"""Checkpoints: one directory per step, ``<directory>/<step>/state.pt``.

A checkpoint is a ``torch.save`` of a dict of tensors (moved to the CPU
first), floats and nested dicts, such as ``ppo.persistent_state``; it loads
with ``weights_only=True``, so loading runs no pickled code. Optimizer state
and the fail rates are saved too, and every checkpoint is kept (the sweeps
over a run's history read them all).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, List, Optional

import torch

_FILE = "state.pt"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save(directory: str, step: int, state: Any) -> str:
    """Write ``state`` as step ``step``; the step's directory appears
    whole or not at all (written under a temporary name, then renamed)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(int(step)))
    tmp = tempfile.mkdtemp(prefix=f".{int(step)}-", dir=directory)
    try:
        torch.save(_to_cpu(state), os.path.join(tmp, _FILE))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
    return final


def all_steps(directory: str) -> List[int]:
    """All saved checkpoint steps, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit()
                  and os.path.isfile(os.path.join(directory, d, _FILE)))


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: Optional[int] = None,
            map_location="cpu") -> Any:
    """Load step ``step`` (the latest when None) onto ``map_location``."""
    step = latest_step(directory) if step is None else int(step)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, str(step), _FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at step {step} in "
                                f"{directory}")
    return torch.load(path, map_location=map_location, weights_only=True)
