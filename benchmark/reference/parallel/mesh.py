"""Single-process stand-ins for the reductions of parc_torch/parallel/mesh.py:
the reference runs in one process, so every reduction over a group of one
is the identity."""

from __future__ import annotations

from typing import List, Sequence

import torch


def world_size(group=None) -> int:
    return 1


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return x


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return x


def psum_flat(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    return list(tensors)
