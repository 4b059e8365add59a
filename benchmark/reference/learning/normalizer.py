"""Running observation normalizer (a dataclass of tensors).

Accumulates mean/second-moment statistics; segments flagged
non-normalized (heightfield, contacts) pass through untouched. Under data
parallelism the batch's count and sums are all-reduced over the ranks
before they are folded in (reference: learning/normalizer.py:29-58).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from reference import resolve_device
from reference.parallel import mesh


@dataclasses.dataclass
class NormalizerState:
    mean: torch.Tensor       # (D,)
    var: torch.Tensor        # (D,)
    count: torch.Tensor      # ()
    # 1.0 where the feature is normalized, 0.0 where passthrough
    norm_mask: torch.Tensor  # (D,)
    clip: float = 10.0
    sample_limit: float = 3e8

    def replace(self, **changes) -> "NormalizerState":
        return dataclasses.replace(self, **changes)


def create(dim: int, norm_mask=None, clip: float = 10.0,
           sample_limit: float = 3e8, device="cuda") -> NormalizerState:
    dev = resolve_device(device)
    return NormalizerState(
        mean=torch.zeros((dim,), device=dev),
        var=torch.ones((dim,), device=dev),
        count=torch.zeros((), device=dev),
        norm_mask=(torch.ones((dim,), device=dev) if norm_mask is None
                   else torch.as_tensor(norm_mask, dtype=torch.float32,
                                        device=dev)),
        clip=clip, sample_limit=sample_limit)


def update(state: NormalizerState, batch: torch.Tensor,
           group=None) -> NormalizerState:
    """Fold a batch of observations (any leading dims) into the stats; with
    a process ``group``, the batches of all its ranks."""
    x = batch.reshape(-1, batch.shape[-1])
    s1 = torch.sum(x, dim=0)
    s2 = torch.sum(x * x, dim=0)
    s1, s2, n = mesh.psum_flat([s1, s2, s1.new_tensor(float(x.shape[0]))],
                               group)
    new_count = state.count + n
    # merge via moment accumulation
    old_s1 = state.mean * state.count
    old_s2 = (state.var + state.mean**2) * state.count
    mean = (old_s1 + s1) / new_count
    var = torch.clamp((old_s2 + s2) / new_count - mean**2, min=1e-5)
    # freeze after sample_limit
    frozen = state.count >= state.sample_limit
    return state.replace(
        mean=torch.where(frozen, state.mean, mean),
        var=torch.where(frozen, state.var, var),
        count=torch.where(frozen, state.count, new_count))


def normalize(state: NormalizerState, x: torch.Tensor) -> torch.Tensor:
    std = torch.sqrt(state.var)
    normed = torch.clamp((x - state.mean) / std, -state.clip, state.clip)
    return torch.where(state.norm_mask > 0, normed, x)


def unnormalize(state: NormalizerState, x: torch.Tensor) -> torch.Tensor:
    return torch.where(state.norm_mask > 0,
                       x * torch.sqrt(state.var) + state.mean, x)
