"""Terrain-conditioned motion diffusion denoiser (torch.nn).

Token layout mirrors the reference MDMTransformer (reference:
diffusion/mdm_transformer.py:5-247):

  [ timestep-embed | 64 heightfield CNN tokens | target token |
    prev-state tokens (2) | motion-frame tokens (15) ]

A transformer *encoder* (full self-attention, 6 layers, d_model 1024,
16 heads) denoises the motion-frame tokens; condition dropout masks the
heightfield / target / prev-state tokens for classifier-free guidance.
The heightfield tokenizer follows cnn_31xy_4layer_c64_out64 (reference:
learning/nets/cnn_31xy_4layer_c64_out64.py:5-37): conv stack to an 8x8
grid of 64-channel patch tokens, each projected to d_model.

The condition tokens (hf CNN + target + prev-state) are independent of
the diffusion timestep and of x_t, so samplers compute them once via
``encode_conditions`` and pass ``cond_toks`` to every denoise step (the
reference's ``fast_forward`` condition-token cache).

The layers match the JAX package's flax modules, which differ from
``nn.TransformerEncoderLayer``: post-norm layers with LayerNorm epsilon
1e-6, tanh-approximated GELU everywhere, dropout only on the attention
weights (one mask shared by the batch and the heads, as flax's
``broadcast_dropout``) and after the FFN's GELU. Dropout masks come from
an explicit generator. With ``compute_dtype`` the token sum and the encoder
layers run in that type (``torch.autocast`` scoped to the encoder stack,
each layer's output cast to it as flax's ``LayerNorm(dtype=...)`` does);
the MLPs, the heightfield CNN and the output stay f32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from reference.diffusion.schedules import timestep_embedding

LN_EPS = 1e-6  # flax LayerNorm's epsilon


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> None:
    """flax lecun_normal: truncated normal (+-2 sd) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)


def _dense(n_in: int, n_out: int, generator=None, device=None) -> nn.Linear:
    layer = nn.Linear(n_in, n_out, device=device)
    with torch.no_grad():
        _lecun_normal_(layer.weight, n_in, generator)
        layer.bias.zero_()
    return layer


def _conv(c_in: int, c_out: int, k: int, stride: int, pad: int,
          generator=None, device=None) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, k, stride=stride, padding=pad,
                     device=device)
    with torch.no_grad():
        _lecun_normal_(conv.weight, c_in * k * k, generator)
        conv.bias.zero_()
    return conv


def _dropout(x: torch.Tensor, rate: float, generator, shape=None
             ) -> torch.Tensor:
    """flax Dropout: keep with probability 1 - rate and scale by its
    inverse; ``shape`` broadcasts one mask (default: x's shape)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape if shape is None else shape,
                      generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class HeightfieldTokenizer(nn.Module):
    """31x31 local heightfield -> 64 tokens of d_model.

    flax's "SAME" padding, written out: a k-wide window at stride s over n
    cells pads max((ceil(n/s) - 1) s + k - n, 0) cells, half before (the
    odd one after). Here every pad is even: 31 -> 31 (k 5, 2 + 2),
    31 -> 16 (k 5, s 2, 2 + 2), 16 -> 16 (k 5, 2 + 2), 16 -> 8 (k 4, s 2,
    1 + 1), so ``nn.Conv2d``'s symmetric padding matches."""

    def __init__(self, d_model: int = 1024, generator=None, device=None):
        super().__init__()
        self.conv = nn.ModuleList([
            _conv(1, 32, 5, 1, 2, generator, device),
            _conv(32, 64, 5, 2, 2, generator, device),
            _conv(64, 64, 5, 1, 2, generator, device),
            _conv(64, 64, 4, 2, 1, generator, device),
        ])
        self.dense = _dense(64, d_model, generator, device)

    def forward(self, hf: torch.Tensor) -> torch.Tensor:  # (..., 31, 31)
        lead = hf.shape[:-2]
        x = hf.reshape((-1, 1) + hf.shape[-2:])
        for i, conv in enumerate(self.conv):
            x = conv(x)
            if i < len(self.conv) - 1:
                x = gelu(x)
        # flax reshapes its NHWC (8, 8, 64) map: token h*8+w, channels last
        x = x.permute(0, 2, 3, 1).reshape(lead + (64, 64))
        return self.dense(x)  # (..., 64, d_model)


class MLPStack(nn.Module):
    def __init__(self, n_in: int, hidden: Sequence[int], out: int,
                 generator=None, device=None):
        super().__init__()
        widths = [n_in, *hidden, out]
        self.dense = nn.ModuleList([
            _dense(a, b, generator, device)
            for a, b in zip(widths[:-1], widths[1:])])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.dense[:-1]:
            x = gelu(layer(x))
        return self.dense[-1](x)


class EncoderLayer(nn.Module):
    """Post-norm encoder layer: LayerNorm(x + attention(x)), then
    LayerNorm(x + FFN(x)); q, k and v projected separately, the query
    scaled by 1/sqrt(head_dim)."""

    def __init__(self, d_model: int, num_heads: int, d_hid: int,
                 dropout: float = 0.1, generator=None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.query = _dense(d_model, d_model, generator, device)
        self.key = _dense(d_model, d_model, generator, device)
        self.value = _dense(d_model, d_model, generator, device)
        self.out = _dense(d_model, d_model, generator, device)
        self.norm_0 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.dense_0 = _dense(d_model, d_hid, generator, device)
        self.dense_1 = _dense(d_hid, d_model, generator, device)
        self.norm_1 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)

    def _attention(self, x, generator):
        b, n, d = x.shape
        h = self.num_heads

        def heads(t):
            return t.reshape(b, n, h, d // h).transpose(1, 2)  # (B, H, N, Dh)

        q = heads(self.query(x)) / math.sqrt(d // h)
        k, v = heads(self.key(x)), heads(self.value(x))
        w = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1)
        if generator is not None and self.dropout > 0.0:
            w = _dropout(w, self.dropout, generator, shape=(1, 1, n, n))
        o = (w @ v).transpose(1, 2).reshape(b, n, d)
        return self.out(o)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` None: deterministic (no dropout)."""
        dtype = x.dtype
        x = self.norm_0(x + self._attention(x, generator)).to(dtype)
        h = gelu(self.dense_0(x))
        if generator is not None and self.dropout > 0.0:
            h = _dropout(h, self.dropout, generator)
        return self.norm_1(x + self.dense_1(h)).to(dtype)


class MDMTransformer(nn.Module):
    """The denoiser. Weights are drawn from ``generator`` on ``device``;
    ``compute_dtype`` is the encoder stack's (None: f32)."""

    def __init__(self, frame_dim: int, seq_len: int = 15,
                 num_prev_states: int = 2, d_model: int = 1024,
                 num_heads: int = 16, d_hid: int = 1024, num_layers: int = 6,
                 dropout: float = 0.1, target_dim: int = 2,
                 in_mlp_layers: Sequence[int] = (1024,),
                 out_mlp_layers: Sequence[int] = (1024,),
                 target_mlp_layers: Sequence[int] = (512,),
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        d = d_model
        self.frame_dim = frame_dim
        self.seq_len = seq_len
        self.num_prev_states = num_prev_states
        self.d_model = d
        self.compute_dtype = compute_dtype
        g, dev = generator, device
        self.t_mlp = MLPStack(d, (d,), d, g, dev)
        self.hf_tokenizer = HeightfieldTokenizer(d, g, dev)
        self.target_mlp = MLPStack(target_dim, target_mlp_layers, d, g, dev)
        self.in_mlp = MLPStack(frame_dim, in_mlp_layers, d, g, dev)
        self.out_mlp = MLPStack(d, out_mlp_layers, frame_dim, g, dev)
        self.prev_noise_ind = nn.Parameter(torch.empty((2, d), device=dev))
        num_tokens = 1 + self.num_cond_tokens + seq_len
        self.pos_embed = nn.Parameter(torch.empty((num_tokens, d),
                                                  device=dev))
        with torch.no_grad():
            self.prev_noise_ind.normal_(0.0, 0.02, generator=g)
            self.pos_embed.normal_(0.0, 0.02, generator=g)
        self.layers = nn.ModuleList([
            EncoderLayer(d, num_heads, d_hid, dropout, g, dev)
            for _ in range(num_layers)])

    @property
    def num_cond_tokens(self) -> int:
        """Cacheable condition tokens: 64 hf + 1 target + prev states."""
        return 64 + 1 + self.num_prev_states

    def encode_conditions(self, prev_states, hf, target_dir, hf_mask=None,
                          target_mask=None, prev_state_mask=None,
                          prev_state_noised=None) -> torch.Tensor:
        """Condition tokens [hf (64) | target (1) | prev (num_prev)]:
        timestep/x_t-independent, so samplers hoist this out of the
        denoise loop (reference fast_forward cache)."""
        hf_toks = self.hf_tokenizer(hf)
        if hf_mask is not None:
            hf_toks = hf_toks * hf_mask[:, None, None]

        tgt_tok = self.target_mlp(target_dir)[:, None, :]
        if target_mask is not None:
            tgt_tok = tgt_tok * target_mask[:, None, None]

        prev_toks = self.in_mlp(prev_states)
        if prev_state_noised is not None:
            ind = torch.where(prev_state_noised[:, None, None] > 0,
                              self.prev_noise_ind[1], self.prev_noise_ind[0])
            prev_toks = prev_toks + ind
        if prev_state_mask is not None:
            prev_toks = prev_toks * prev_state_mask[:, None, None]
        return torch.cat([hf_toks, tgt_tok, prev_toks], dim=1)

    def forward(self, x_t, t, prev_states=None, hf=None, target_dir=None,
                hf_mask=None, target_mask=None, prev_state_mask=None,
                prev_state_noised=None, cond_toks=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Denoise motion tokens.

        Args:
          x_t: (B, seq_len, frame_dim) noised motion frames.
          t: (B,) diffusion timesteps.
          prev_states: (B, num_prev, frame_dim) conditioning frames.
          hf: (B, 31, 31) local heightfield.
          target_dir: (B, target_dim).
          *_mask: (B,) 1.0 keeps the condition, 0.0 drops it (CFG).
          prev_state_noised: (B,) 1.0 flags noisy prev-state conditioning.
          cond_toks: optional (B, num_cond_tokens, d_model) precomputed
            ``encode_conditions`` output; when given, the raw condition
            inputs are ignored.
          generator: draws the dropout masks; None runs deterministically.
        Returns:
          (B, seq_len, frame_dim) predicted x0, f32.
        """
        if cond_toks is None:
            cond_toks = self.encode_conditions(
                prev_states, hf, target_dir, hf_mask, target_mask,
                prev_state_mask, prev_state_noised)
        t_tok = self.t_mlp(timestep_embedding(t, self.d_model))[:, None, :]
        frame_toks = self.in_mlp(x_t)
        tokens = torch.cat([t_tok, cond_toks, frame_toks], dim=1)
        x = self._encode(tokens, generator)
        return self.out_mlp(x[:, -self.seq_len:, :])

    def _encode(self, tokens, generator):
        """The token sum and the encoder stack, in compute_dtype if set;
        returns f32."""
        if self.compute_dtype is None:
            x = tokens + self.pos_embed
            for layer in self.layers:
                x = layer(x, generator)
            return x
        with torch.autocast(tokens.device.type, dtype=self.compute_dtype):
            x = (tokens.to(self.compute_dtype)
                 + self.pos_embed.to(self.compute_dtype))
            for layer in self.layers:
                x = layer(x, generator)
        return x.float()
