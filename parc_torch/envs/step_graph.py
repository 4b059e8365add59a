"""The post-physics chain of a pooled env step, replayed as one CUDA graph.

After the physics launch, an env step (``DeepMimicEnv._after_physics``,
``ParkourEnv._after_physics``) advances the clocks, samples the reference
frame and its FK, computes reward, done, tracking error and the fail-rate
EMA, observes, takes the done envs' resets from the reset pool and selects:
some 2,700 small kernels at the tracker's widths, each launched from
Python. On CUDA with a reset pool, the env captures that chain once as a
CUDA graph and replays it every step: the same kernels in the same order on
the same float32 tensors, launched by one call (the recipe of
``retarget/keypoint_ik.adam_fit``).

A :class:`StepGraph` holds static copies of the chain's per-step inputs
(the physics output and the state fields the chain reads, the pool slot)
and of the reset pool, and the graph's outputs. Each step copies the inputs
in with one multi-tensor copy, replays, and copies the outputs out into
fresh tensors, so that no replay overwrites what an earlier step returned.
A reset pool is copied in once, at the first step that passes it.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Iterator, List

import torch

from parc_torch.utils.profiling import annotate

# eager runs of the chain on a side stream before the capture (cuBLAS
# handles, the allocator's blocks)
GRAPH_WARMUP = 2


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dataclasses and tuples, in field order
    (None and other leaves skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in leaves(getattr(tree, f.name))]
    if isinstance(tree, tuple):
        return [t for v in tree for t in leaves(v)]
    return []


def rebuild(tree, tensors: Iterator[torch.Tensor]):
    """``tree`` with its tensors, in :func:`leaves` order, replaced by
    ``tensors``; every other leaf kept."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: rebuild(getattr(tree, f.name), tensors)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return tuple(rebuild(v, tensors) for v in tree)
    return tree


def _copied(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    out = [torch.empty_like(t) for t in tensors]
    torch._foreach_copy_(out, tensors)
    return out


class StepGraph:
    """``chain(args, pool)`` captured as a CUDA graph over static copies of
    ``args`` (the per-step inputs, a tree) and ``pool`` (the reset pool).

    It serves the ``owner`` (the lib the caller passes) and the ``key`` (the
    shapes) it was captured for; ``hold`` keeps alive what the graph reads
    beyond them. ``captures`` and ``replays`` count over every instance."""

    captures = 0
    replays = 0

    def __init__(self, owner, key, chain: Callable, args, pool, hold=None):
        self.owner, self.key, self.hold = owner, key, hold
        self.static_args = [t.clone() for t in leaves(args)]
        self.static_pool = [t.clone() for t in leaves(pool)]
        self._pool = weakref.ref(pool)
        s_args = rebuild(args, iter(self.static_args))
        s_pool = rebuild(pool, iter(self.static_pool))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(GRAPH_WARMUP):
                chain(s_args, s_pool)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph), torch.no_grad():
            self.static_out = leaves(chain(s_args, s_pool))
        StepGraph.captures += 1

    def serves(self, owner, key) -> bool:
        return self.owner is owner and self.key == key

    def __call__(self, args, pool, like):
        """Replay on ``args`` and ``pool`` (trees shaped as at the capture);
        the outputs, copied out, in a tree shaped as ``like``."""
        if self._pool() is not pool:
            torch._foreach_copy_(self.static_pool, leaves(pool))
            self._pool = weakref.ref(pool)
        torch._foreach_copy_(self.static_args, leaves(args))
        with annotate("parc.env.graph_replay"):
            pass
        self.graph.replay()
        StepGraph.replays += 1
        return rebuild(like, iter(_copied(self.static_out)))
