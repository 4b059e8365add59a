"""Vision tracker policies: a CNN-MLP and a ViT over the flat observation.

The observation's heightfield segment is the ray cone (or grid) reshaped
to its (rows, cols) layout (``envs.perception.hf_shape``); a conv
tokenizer turns it into tokens that are fused with the proprioceptive and
target segments. Both nets share one trunk between the actor's mean and
the critic's value.

The layers follow the JAX package's flax modules: convolutions with
flax's "SAME" padding written out (a k-wide window at stride s over n
cells pads max((ceil(n/s) - 1) s + k - n, 0) cells, the smaller half
before), the tokens read row-major over the NHWC map, tanh-approximated
GELU, post-norm encoder layers with LayerNorm epsilon 1e-6 (the MDM's
``EncoderLayer``, without dropout). With ``compute_dtype`` the trunk runs
in that type under ``torch.autocast`` (the parameters stay f32) and the
heads stay f32.

``DMViT``'s trunk opens the spans ``parc.vit.tokenize`` (the conv
tokenizer, the segment tokens, the class token and the positions) and
``parc.vit.encode`` (the encoder layers), and counts its rows: ``rows``,
every observation through the trunk, and ``grad_rows``, those taken while
autograd records (the update's minibatches). Both counters are Python ints
read from shapes, so counting never waits on the device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from parc_torch.diffusion.transformer import (EncoderLayer, _dense,
                                              _lecun_normal_, gelu)
from parc_torch.envs.obs import ObsLayout
from parc_torch.learning.networks import _fan_avg_uniform_
from parc_torch.utils.profiling import annotate

_CONVS = ((1, 32, (1, 1)), (32, 64, (1, 3)), (64, 64, (1, 3)))  # in, out, s
_KERNEL = (3, 5)


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(c_in: int, c_out: int, stride, generator=None,
          device=None) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, _KERNEL, stride=stride, device=device)
    with torch.no_grad():
        _lecun_normal_(conv.weight, c_in * _KERNEL[0] * _KERNEL[1],
                       generator)
        conv.bias.zero_()
    return conv


class RayConvTokenizer(nn.Module):
    """(rows, cols) heightfield -> tokens of ``d_out``: three 3x5 convs
    (32, 64, 64 channels; the last two stride 3 along the cols), one token
    per cell of the last map."""

    def __init__(self, hf_shape: Tuple[int, int], d_out: int = 256,
                 generator=None, device=None):
        super().__init__()
        self.hf_shape = tuple(hf_shape)
        self.conv = nn.ModuleList([_conv(a, b, s, generator, device)
                                   for a, b, s in _CONVS])
        self.dense = _dense(64, d_out, generator, device)
        h, w = self.hf_shape
        for _, _, (sh, sw) in _CONVS:
            h, w = -(-h // sh), -(-w // sw)
        self.num_tokens = h * w

    def forward(self, hf_flat: torch.Tensor) -> torch.Tensor:
        lead = hf_flat.shape[:-1]
        x = hf_flat.reshape((-1, 1) + self.hf_shape)
        for conv in self.conv:
            (h, w), (sh, sw) = x.shape[-2:], conv.stride
            ph, pw = (_same_pads(h, _KERNEL[0], sh),
                      _same_pads(w, _KERNEL[1], sw))
            x = gelu(conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1]))))
        # flax reshapes its NHWC map: token h*W+w, channels last
        x = x.permute(0, 2, 3, 1).reshape(lead + (-1, x.shape[1]))
        return self.dense(x)


class _VisionPolicy(nn.Module):
    """The heads and the actor/critic API shared by both nets; a subclass
    defines ``_trunk(obs) -> features``."""

    def __init__(self, width: int, action_dim: int, action_std: float,
                 actor_init_output_scale: float, generator, device,
                 compute_dtype):
        super().__init__()
        self.action_std = action_std
        self.compute_dtype = compute_dtype
        self.mean_head = nn.Linear(width, action_dim, device=device)
        with torch.no_grad():
            _fan_avg_uniform_(self.mean_head.weight,
                              actor_init_output_scale, generator)
            self.mean_head.bias.zero_()
        self.value_head = _dense(width, 1, generator, device)

    def forward(self, obs: torch.Tensor):
        if self.compute_dtype is None:
            feat = self._trunk(obs)
        else:
            with torch.autocast(obs.device.type, dtype=self.compute_dtype):
                feat = self._trunk(obs)
        feat = feat.float()
        mean = self.mean_head(feat)
        logstd = torch.full_like(mean, math.log(self.action_std))
        return mean, logstd, self.value_head(feat)[..., 0]

    def actor(self, obs: torch.Tensor):
        mean, logstd, _ = self(obs)
        return mean, logstd

    def critic(self, obs: torch.Tensor) -> torch.Tensor:
        return self(obs)[2]


class DMCnnMlp(_VisionPolicy):
    """Conv tokens of the hf segment (128 wide), flattened and joined to
    the other segments, then a ReLU MLP trunk."""

    def __init__(self, action_dim: int, layout: ObsLayout,
                 hf_shape: Tuple[int, int],
                 mlp_layers: Sequence[int] = (1024, 1024, 512),
                 action_std: float = 0.05,
                 actor_init_output_scale: float = 0.01,
                 generator: Optional[torch.Generator] = None, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(mlp_layers[-1], action_dim, action_std,
                         actor_init_output_scale, generator, device,
                         compute_dtype)
        s = layout.slices()
        self.hf_slice = s["hf_obs"]
        self.rest_slices = [sl for name, sl in s.items() if name != "hf_obs"]
        self.tokenizer = RayConvTokenizer(hf_shape, 128, generator, device)
        d = (sum(sl.stop - sl.start for sl in self.rest_slices)
             + self.tokenizer.num_tokens * 128)
        layers = []
        for w in mlp_layers:
            layers.append(_dense(d, w, generator, device))
            d = w
        self.trunk = nn.ModuleList(layers)

    def _trunk(self, obs):
        hf_feat = self.tokenizer(obs[..., self.hf_slice])
        hf_feat = hf_feat.reshape(hf_feat.shape[:-2] + (-1,))
        rest = torch.cat([obs[..., sl] for sl in self.rest_slices], dim=-1)
        x = torch.cat([rest.to(hf_feat.dtype), hf_feat], dim=-1)
        for layer in self.trunk:
            x = torch.relu(layer(x))
        return x


class DMViT(_VisionPolicy):
    """Transformer policy: each non-hf segment becomes a token beside the
    hf conv tokens and a learned class token; post-norm encoder layers mix
    them and the heads read the class token."""

    def __init__(self, action_dim: int, layout: ObsLayout,
                 hf_shape: Tuple[int, int], d_model: int = 256,
                 num_heads: int = 8, num_layers: int = 3,
                 action_std: float = 0.05,
                 actor_init_output_scale: float = 0.01,
                 generator: Optional[torch.Generator] = None, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(d_model, action_dim, action_std,
                         actor_init_output_scale, generator, device,
                         compute_dtype)
        s = layout.slices()
        self.hf_slice = s["hf_obs"]
        self.seg_slices = [sl for name, sl in s.items() if name != "hf_obs"]
        self.tokenizer = RayConvTokenizer(hf_shape, d_model, generator,
                                          device)
        self.seg_dense = nn.ModuleList([
            _dense(sl.stop - sl.start, d_model, generator, device)
            for sl in self.seg_slices])
        n_tok = 1 + len(self.seg_slices) + self.tokenizer.num_tokens
        self.cls = nn.Parameter(torch.empty((1, d_model), device=device))
        self.pos = nn.Parameter(torch.empty((n_tok, d_model), device=device))
        with torch.no_grad():
            self.cls.normal_(0.0, 0.02, generator=generator)
            self.pos.normal_(0.0, 0.02, generator=generator)
        self.layers = nn.ModuleList([
            EncoderLayer(d_model, num_heads, 4 * d_model, dropout=0.0,
                         generator=generator, device=device)
            for _ in range(num_layers)])
        self.rows = 0
        self.grad_rows = 0

    def _trunk(self, obs):
        rows = math.prod(obs.shape[:-1])
        self.rows += rows
        if torch.is_grad_enabled():
            self.grad_rows += rows
        with annotate("parc.vit.tokenize"):
            hf_tokens = self.tokenizer(obs[..., self.hf_slice])
            toks = torch.stack([dense(obs[..., sl]) for dense, sl
                                in zip(self.seg_dense, self.seg_slices)],
                               dim=-2)
            cls = self.cls.expand(toks.shape[:-2] + self.cls.shape)
            dtype = self.compute_dtype or torch.float32
            x = torch.cat([cls.to(dtype), toks.to(dtype),
                           hf_tokens.to(dtype)], dim=-2)
            x = x + self.pos.to(dtype)
        with annotate("parc.vit.encode"):
            lead = x.shape[:-2]
            x = x.reshape((-1,) + x.shape[-2:])
            for layer in self.layers:
                x = layer(x)
            return x[:, 0, :].reshape(lead + x.shape[-1:])
