"""Policy/value networks (torch.nn).

Registry of MLP trunks; the tracker default is a 3x2048-unit ReLU MLP for
both actor and critic. Initialization follows the JAX package's flax
defaults: trunk and critic-head kernels LeCun-normal (truncated), biases
zero, the actor head variance-scaled uniform with ``actor_init_output_scale``.

A trunk may compute in bf16 (``compute_dtype``, by ``torch.autocast``
scoped to the trunk): its input, weights and matmuls are cast to that type
while the parameters stay f32, and its output returns to f32 before the
heads, so the heads, the log-probs, the values and the losses stay f32. The
PPO agent asks for bf16 on CUDA only.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

_NET_REGISTRY = {
    "fc_2layers_1024units": (1024, 1024),
    "fc_3layers_1024units": (1024, 1024, 1024),
    "fc_2layers_512units": (512, 512),
    "fc_3layers_2048units": (2048, 2048, 2048),
}

STD_TYPES = ("FIXED", "CONSTANT", "VARIABLE")


def _lecun_normal_(w: torch.Tensor, generator=None) -> None:
    """flax lecun_normal: truncated normal (+-2 sd) with variance 1/fan_in."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)


def _fan_avg_uniform_(w: torch.Tensor, scale: float, generator=None) -> None:
    """flax variance_scaling(scale, 'fan_avg', 'uniform')."""
    limit = math.sqrt(3.0 * scale / ((w.shape[0] + w.shape[1]) / 2.0))
    nn.init.uniform_(w, -limit, limit, generator=generator)


def _dense(n_in: int, n_out: int, generator=None, device=None) -> nn.Linear:
    layer = nn.Linear(n_in, n_out, device=device)
    with torch.no_grad():
        _lecun_normal_(layer.weight, generator)
        layer.bias.zero_()
    return layer


class MLP(nn.Sequential):
    """Dense + ReLU trunk; with ``compute_dtype`` its input, weights and
    matmuls run in that type (the parameters stay f32)."""

    def __init__(self, in_dim: int, layers: Sequence[int], generator=None,
                 device=None, compute_dtype: Optional[torch.dtype] = None):
        mods, d = [], in_dim
        for width in layers:
            mods += [_dense(d, width, generator, device), nn.ReLU()]
            d = width
        super().__init__(*mods)
        self.out_dim = d
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        # autocast scoped to the trunk: each Linear casts its input, weight
        # and bias to compute_dtype (the f32 parameters are kept), and its
        # output stays in that type
        with torch.autocast(x.device.type, dtype=self.compute_dtype):
            return super().forward(x)


def build_net(name: str, in_dim: int, generator=None, device=None,
              compute_dtype: Optional[torch.dtype] = None) -> MLP:
    if name not in _NET_REGISTRY:
        raise KeyError(f"unknown net {name!r}; have {list(_NET_REGISTRY)}")
    return MLP(in_dim, _NET_REGISTRY[name], generator, device, compute_dtype)


class ActorCritic(nn.Module):
    """Gaussian actor + value critic over normalized observations.

    FIXED uses a constant std; CONSTANT learns one log-std per action dim;
    VARIABLE predicts log-std per dim from the actor trunk. Weights are
    drawn from ``generator``, which lives on ``device``. ``compute_dtype``
    is the trunks' (None: f32).
    """

    def __init__(self, obs_dim: int, action_dim: int,
                 actor_net: str = "fc_3layers_2048units",
                 critic_net: str = "fc_3layers_2048units",
                 actor_std_type: str = "FIXED", action_std: float = 0.05,
                 actor_init_output_scale: float = 0.01,
                 generator: Optional[torch.Generator] = None, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if actor_std_type not in STD_TYPES:
            raise ValueError(f"actor_std_type {actor_std_type!r} not in "
                             f"{STD_TYPES}")
        self.actor_std_type = actor_std_type
        self.action_std = action_std
        self.actor_trunk = build_net(actor_net, obs_dim, generator, device,
                                     compute_dtype)
        self.critic_trunk = build_net(critic_net, obs_dim, generator, device,
                                      compute_dtype)
        self.actor_head = nn.Linear(self.actor_trunk.out_dim, action_dim,
                                    device=device)
        self.critic_head = _dense(self.critic_trunk.out_dim, 1, generator,
                                  device)
        with torch.no_grad():
            _fan_avg_uniform_(self.actor_head.weight, actor_init_output_scale,
                              generator)
            self.actor_head.bias.zero_()
        if actor_std_type == "VARIABLE":
            self.logstd_head = nn.Linear(self.actor_trunk.out_dim, action_dim,
                                         device=device)
            with torch.no_grad():
                self.logstd_head.weight.zero_()
                self.logstd_head.bias.zero_()
        elif actor_std_type == "CONSTANT":
            self.logstd = nn.Parameter(
                torch.full((action_dim,), math.log(action_std), device=device))

    def actor(self, obs: torch.Tensor):
        h = self.actor_trunk(obs).float()
        mean = self.actor_head(h)
        if self.actor_std_type == "FIXED":
            logstd = torch.full_like(mean, math.log(self.action_std))
        elif self.actor_std_type == "CONSTANT":
            logstd = self.logstd.expand(mean.shape)
        else:
            logstd = self.logstd_head(h)
        return mean, logstd

    def critic(self, obs: torch.Tensor) -> torch.Tensor:
        return self.critic_head(self.critic_trunk(obs).float())[..., 0]

    def forward(self, obs: torch.Tensor):
        mean, logstd = self.actor(obs)
        return mean, logstd, self.critic(obs)
