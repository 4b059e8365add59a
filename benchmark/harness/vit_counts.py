"""Operations a row of PARC's transformer tracker policy (DM_ViT), counted
from the configuration's widths (its ``vit`` block) and the observation's
segment sizes, never from the program.

A multiply-add is 2 operations. Counted: each convolution and dense layer,
and each encoder layer's two products over all heads (the scores q k^T and
their weighted sum of v). Left out, as ``torch.utils.flop_counter`` leaves
them out: LayerNorm, GELU, the softmax, the adds and the biases.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def _tokenizer(vit: dict) -> Tuple[int, int, int]:
    """(operations of the convolutions, those of the first alone, the
    number of heightfield tokens)."""
    rows, cols = vit["hf_shape"]
    kh, kw = vit["conv_kernel"]
    total, first, c_in = 0, 0, 1
    for c_out, (sh, sw) in zip(vit["conv_channels"], vit["conv_strides"]):
        rows, cols = -(-rows // sh), -(-cols // sw)     # "SAME" padding
        ops = 2 * rows * cols * c_out * c_in * kh * kw
        total, first = total + ops, first or ops
        c_in = c_out
    return total, first, rows * cols


def tokens(vit: dict, segments: Sequence[int]) -> int:
    """The class token, one token a segment, the heightfield's tokens."""
    return 1 + len(segments) + _tokenizer(vit)[2]


def forward_flops(vit: dict, segments: Sequence[int], action_dim: int
                  ) -> int:
    """One row's forward pass: the tokenizer, the segments' dense layers,
    the encoder layers and both heads. ``segments`` are the sizes of the
    observation's segments other than the heightfield."""
    d, d_hid = vit["d_model"], vit["d_hid"]
    conv, _, hf_tokens = _tokenizer(vit)
    t = tokens(vit, segments)
    embed = (conv + 2 * hf_tokens * vit["conv_channels"][-1] * d
             + sum(2 * s * d for s in segments))
    # per layer: q, k, v, out and the FFN's two dense layers; the scores
    # and the weighted sum, 2 t^2 d operations each over all heads
    layers = vit["num_layers"] * (2 * t * (4 * d * d + 2 * d * d_hid)
                                  + 2 * 2 * t * t * d)
    heads = 2 * d * (action_dim + 1)
    return embed + layers + heads


def backward_flops(vit: dict, segments: Sequence[int], action_dim: int
                   ) -> int:
    """One row's backward pass: each convolution's and dense layer's
    weight gradient costs its forward, and its input gradient the same but
    where the input is the observation (the first convolution, the
    segments' dense layers); each attention product has two inputs, whose
    gradients cost its forward each. That is twice the forward, less the
    layers that meet the observation."""
    _, first, _ = _tokenizer(vit)
    observed = first + sum(2 * s * vit["d_model"] for s in segments)
    return 2 * forward_flops(vit, segments, action_dim) - observed
