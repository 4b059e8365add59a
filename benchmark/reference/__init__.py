"""The benchmark's plain reference: what decides each run's ``correct``.

The subpackages (``anim``, ``data``, ``envs``, ``physics``, ``utils``,
``learning``, ``diffusion``) are a frozen copy of ``parc_torch``'s plain
PyTorch code at the commit that added the benchmark, with the imports
pointed here. The physics runs the control step's plain version on every
device (never the CUDA kernel), ``parallel/mesh.py`` keeps only the
single-process reductions, and the kernel's loader and the terrain mesher
are left out. Nothing here imports ``parc_torch``, ``parc_tpu`` or JAX, so a
later change to the port cannot change what the port is held against.

``tracker``, ``mdm`` and ``parkour`` build that copy's objects for the
same first training steps as the timed path, in float32 with TF32 off (the
reference) or with every trunk and encoder matmul in fp8 (the control,
``fp8``).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device to run on; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
