"""PARC's transformer tracker policy (upstream ``learning/nets/dm_vit.py``
with ``cnn_tokenizer.py``), written from its layer equations in plain
float32 for the benchmark's reference. No autocast, no fused or library
attention: every operation is spelled out.

One row of the flat observation becomes T tokens of width d:

* the heightfield segment, reshaped to its (rows, cols) ray layout, goes
  through three 3 x 5 convolutions (32, 64, 64 channels; strides (1, 1),
  (1, 3), (1, 3)) with flax's "SAME" padding, each followed by GELU; each
  cell of the last map, read row-major, is one token, projected from 64
  channels to d;
* each other segment (``char_obs``, ``tar_obs``, ``contact_obs``,
  ``tar_contact_obs``) is one token through a dense layer of its own;
* a learned class token leads, and learned positions are added:
  T = 1 + 4 + 49 = 54 for the 7 x 63 ray cone.

Three post-norm encoder layers follow, each

    a = softmax(q k^T / sqrt(d_head)) v over every head,
    x = LN(x + W_o a),   x = LN(x + W_2 gelu(W_1 x)),

with q, k, v separate projections, LayerNorm epsilon 1e-6 and the tanh
GELU, 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))). The class token's
output feeds both heads: the actor's mean (a dense layer) beside a fixed
log-std, and the critic's value (a dense layer).

Weights are drawn from the generator in the order the port draws them
(heads, convolutions, tokenizer dense, segment denses, class token,
positions, then each layer's q, k, v, out, FFN), with the same
distributions, and the parameters carry the port's names, so both sides
start from the same weights and their leaves compare by name. The upstream
widths are the defaults; ``compute_dtype`` is accepted for the agent's
call and must be None.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

LN_EPS = 1e-6
KERNEL = (3, 5)
CONVS = ((1, 32, (1, 1)), (32, 64, (1, 3)), (64, 64, (1, 3)))  # in, out, s


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)))


def layer_norm(x: torch.Tensor, norm: "Norm") -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * norm.weight + norm.bias


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax "SAME": the output has ceil(n / s) cells; the pad that needs,
    max((ceil(n / s) - 1) s + k - n, 0), splits with the smaller half
    before."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _lecun(w: torch.Tensor, fan_in: int, generator) -> None:
    """Truncated normal at +-2 sd with variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)


def _dense(n_in: int, n_out: int, generator, device) -> nn.Linear:
    layer = nn.Linear(n_in, n_out, device=device)
    with torch.no_grad():
        _lecun(layer.weight, n_in, generator)
        layer.bias.zero_()
    return layer


class Norm(nn.Module):
    """A LayerNorm's gain and bias."""

    def __init__(self, d: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))


class Conv(nn.Module):
    """A 3 x 5 convolution's kernel and bias, and its stride."""

    def __init__(self, c_in: int, c_out: int, stride, generator, device):
        super().__init__()
        self.stride = tuple(stride)
        self.weight = nn.Parameter(torch.empty((c_out, c_in) + KERNEL,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(c_out, device=device))
        with torch.no_grad():
            _lecun(self.weight, c_in * KERNEL[0] * KERNEL[1], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h, w), (sh, sw) = x.shape[-2:], self.stride
        top, bottom = same_pads(h, KERNEL[0], sh)
        left, right = same_pads(w, KERNEL[1], sw)
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight,
                        self.bias, stride=self.stride)


class Tokenizer(nn.Module):
    def __init__(self, d_model: int, generator, device):
        super().__init__()
        self.conv = nn.ModuleList([Conv(a, b, s, generator, device)
                                   for a, b, s in CONVS])
        self.dense = _dense(CONVS[-1][1], d_model, generator, device)


class Layer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_hid: int, generator,
                 device):
        super().__init__()
        self.num_heads = num_heads
        self.query = _dense(d_model, d_model, generator, device)
        self.key = _dense(d_model, d_model, generator, device)
        self.value = _dense(d_model, d_model, generator, device)
        self.out = _dense(d_model, d_model, generator, device)
        self.norm_0 = Norm(d_model, device)
        self.dense_0 = _dense(d_model, d_hid, generator, device)
        self.dense_1 = _dense(d_hid, d_model, generator, device)
        self.norm_1 = Norm(d_model, device)

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        q, k, v = (f(x).reshape(b, t, h, d // h)
                   for f in (self.query, self.key, self.value))
        s = torch.einsum("bqhe,bkhe->bhqk", q, k) / math.sqrt(d // h)
        w = torch.exp(s - s.amax(-1, keepdim=True))
        w = w / w.sum(-1, keepdim=True)
        return self.out(torch.einsum("bhqk,bkhe->bqhe", w, v)
                        .reshape(b, t, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = layer_norm(x + self.attention(x), self.norm_0)
        return layer_norm(x + self.dense_1(gelu(self.dense_0(x))),
                          self.norm_1)


class DMViT(nn.Module):
    def __init__(self, action_dim: int, layout, hf_shape: Tuple[int, int],
                 d_model: int = 256, num_heads: int = 8, num_layers: int = 3,
                 d_hid: int = 1024, action_std: float = 0.05,
                 actor_init_output_scale: float = 0.01,
                 generator: Optional[torch.Generator] = None, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if compute_dtype is not None:
            raise ValueError("the reference computes in float32 only")
        self.action_std = action_std
        self.hf_shape = tuple(hf_shape)
        slices = layout.slices()
        self.hf_slice = slices["hf_obs"]
        self.seg_slices = [sl for n, sl in slices.items() if n != "hf_obs"]
        self.mean_head = nn.Linear(d_model, action_dim, device=device)
        with torch.no_grad():
            limit = math.sqrt(3.0 * actor_init_output_scale
                              / ((d_model + action_dim) / 2.0))
            nn.init.uniform_(self.mean_head.weight, -limit, limit,
                             generator=generator)
            self.mean_head.bias.zero_()
        self.value_head = _dense(d_model, 1, generator, device)
        self.tokenizer = Tokenizer(d_model, generator, device)
        self.seg_dense = nn.ModuleList([
            _dense(sl.stop - sl.start, d_model, generator, device)
            for sl in self.seg_slices])
        h, w = self.hf_shape
        for _, _, (sh, sw) in CONVS:
            h, w = -(-h // sh), -(-w // sw)
        self.num_tokens = 1 + len(self.seg_slices) + h * w
        self.cls = nn.Parameter(torch.empty((1, d_model), device=device))
        self.pos = nn.Parameter(torch.empty((self.num_tokens, d_model),
                                            device=device))
        with torch.no_grad():
            self.cls.normal_(0.0, 0.02, generator=generator)
            self.pos.normal_(0.0, 0.02, generator=generator)
        self.layers = nn.ModuleList([
            Layer(d_model, num_heads, d_hid, generator, device)
            for _ in range(num_layers)])

    def trunk(self, obs: torch.Tensor) -> torch.Tensor:
        """(..., obs_dim) -> the class token's output, (..., d_model)."""
        lead = obs.shape[:-1]
        obs = obs.reshape(-1, obs.shape[-1])
        x = obs[:, self.hf_slice].reshape((-1, 1) + self.hf_shape)
        for conv in self.tokenizer.conv:
            x = gelu(conv(x))
        hf_tokens = self.tokenizer.dense(x.permute(0, 2, 3, 1)
                                         .reshape(x.shape[0], -1, x.shape[1]))
        seg_tokens = torch.stack([dense(obs[:, sl]) for dense, sl
                                  in zip(self.seg_dense, self.seg_slices)], 1)
        cls = self.cls.expand(obs.shape[0], 1, -1)
        x = torch.cat([cls, seg_tokens, hf_tokens], 1) + self.pos
        for layer in self.layers:
            x = layer(x)
        return x[:, 0].reshape(lead + (-1,))

    def forward(self, obs: torch.Tensor):
        feat = self.trunk(obs)
        mean = self.mean_head(feat)
        logstd = torch.full_like(mean, math.log(self.action_std))
        return mean, logstd, self.value_head(feat)[..., 0]

    def actor(self, obs: torch.Tensor):
        mean, logstd, _ = self(obs)
        return mean, logstd

    def critic(self, obs: torch.Tensor) -> torch.Tensor:
        return self(obs)[2]
