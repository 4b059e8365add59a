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
    """All saved checkpoint steps, ascending. Step directories without
    ``state.pt`` only (an orbax run of the JAX package) raise, naming the
    converter."""
    if not os.path.isdir(directory):
        return []
    dirs = sorted(int(d) for d in os.listdir(directory) if d.isdigit())
    steps = [d for d in dirs
             if os.path.isfile(os.path.join(directory, str(d), _FILE))]
    if dirs and not steps:
        raise FileNotFoundError(
            f"{directory} holds step directories {dirs} without {_FILE}: an "
            f"orbax run of the JAX package, which this package does not "
            f"read. Convert the run where JAX is installed, with `python "
            f"tools/orbax_to_torch.py SRC_RUN_DIR DST_RUN_DIR`, and pass "
            f"DST_RUN_DIR")
    return steps


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: Optional[int] = None,
            map_location="cpu") -> Any:
    """Load step ``step`` (the latest when None) onto ``map_location``."""
    steps = all_steps(directory)  # raises on an orbax run
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        step = steps[-1]
    step = int(step)
    path = os.path.join(directory, str(step), _FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at step {step} in "
                                f"{directory}")
    return torch.load(path, map_location=map_location, weights_only=True)
