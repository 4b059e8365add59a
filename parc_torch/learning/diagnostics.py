"""Network-health diagnostics: dormant units, stable rank, weight stats.

Reference parity: learning/dm_ppo_agent.py:607-773 (test_model2): per-layer
stable rank of weight matrices (smallest k singular values covering 99% of
the spectral mass), average weight magnitude, and dormant-unit counts from
activation statistics over evaluation rollouts. Used to monitor plasticity
loss during long PARC iterations.

Rows are named as the JAX package names them, so the two reports line up:
a weight row by its path in the agent's parameter tree, which holds the
top-level ``"params"`` key (``params/actor_trunk/Dense_0``, ...,
``params/critic_head``); an activation row by its module path
(``actor_trunk/Dense_0``, ``actor_trunk``, ...).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def stable_rank(weight: np.ndarray, mass: float = 0.99) -> int:
    """Smallest k such that the top-k singular values hold ``mass`` of the
    total singular-value sum (reference: dm_ppo_agent.py:634-652)."""
    s = np.linalg.svd(np.asarray(weight, np.float64), compute_uv=False)
    total = s.sum()
    if total <= 0:
        return 0
    frac = np.cumsum(s) / total
    return int(np.searchsorted(frac, mass) + 1)


def _layer_names(net: nn.Module) -> Dict[str, nn.Module]:
    """The net's Linear layers and trunks under the JAX package's names:
    a trunk's i-th Linear is ``<trunk>/Dense_i``."""
    names = {}
    for name, mod in net.named_children():
        if isinstance(mod, nn.Sequential):
            names[name] = mod
            linears = [m for m in mod if isinstance(m, nn.Linear)]
            for i, lin in enumerate(linears):
                names[f"{name}/Dense_{i}"] = lin
        elif isinstance(mod, nn.Linear):
            names[name] = mod
    return names


def weight_diagnostics(net: nn.Module) -> Dict[str, Dict[str, float]]:
    """Stable rank + mean |w| for every Linear kernel of ``net``, a row
    ``params/<module path>``."""
    out = {}
    for name, mod in _layer_names(net).items():
        if not isinstance(mod, nn.Linear):
            continue
        w = mod.weight.detach().cpu().numpy().T  # (in, out), as flax holds it
        out[f"params/{name}"] = {
            "stable_rank": stable_rank(w),
            "max_rank": int(min(w.shape)),
            "mean_abs_weight": float(np.mean(np.abs(w))),
        }
    return out


@torch.no_grad()
def activation_diagnostics(net: nn.Module, obs: torch.Tensor,
                           dormant_threshold: float = 0.025
                           ) -> Dict[str, Dict[str, float]]:
    """Dormant-unit fractions from one batch of observations.

    Every Linear layer's output (pre-activation) and every trunk's output
    over one forward pass of the actor and the critic are recorded. A unit
    is dormant when its mean |activation| over the batch is below
    ``dormant_threshold`` x the layer's mean |activation| (the normalized
    criterion from "The Dormant Neuron Phenomenon in Deep RL"; the
    reference tracks the same EMA utility signal in test_model2).
    """
    acts = {}
    hooks = [mod.register_forward_hook(
        lambda _m, _i, out, name=name: acts.__setitem__(name, out))
        for name, mod in _layer_names(net).items()]
    try:
        net(obs)
    finally:
        for h in hooks:
            h.remove()
    out = {}
    for name, act in acts.items():
        a = act.float().abs().mean(dim=tuple(range(act.ndim - 1)))
        denom = torch.clamp(a.mean(), min=1e-12)
        out[name] = {
            "dormant_frac": float(torch.mean((a / denom
                                              < dormant_threshold).float())),
            "num_units": int(a.shape[-1]),
            "mean_abs_act": float(a.mean()),
        }
    return out


def full_report(agent, state, obs: torch.Tensor) -> Dict[str, Any]:
    """Weight + activation diagnostics for a PPO agent state (the port's
    `run.py mode=test2`)."""
    from parc_torch.learning import normalizer as norm_lib
    norm_obs = norm_lib.normalize(state.obs_norm, obs)
    return {
        "weights": weight_diagnostics(agent.net),
        "activations": activation_diagnostics(agent.net, norm_obs),
    }
