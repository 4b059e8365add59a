"""Build and load the port's hand-written CUDA kernels.

Each kernel library is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use, into ``build/parc_torch/`` at the root of the
checkout, under a name that carries a hash of the sources, so an edited
source rebuilds and an unchanged one is reused. The compiler's report
(``-Xptxas -v``: registers, local memory and spills per kernel) is kept
beside the library as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "parc_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda; raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str, sources: Sequence[str],
                 defines: Sequence[str] = ()) -> Path:
    """Where the library built from ``sources`` (names under csrc/), with
    the extra ``defines`` (``-DNAME`` flags), lives:
    ``build/parc_torch/<name>-<hash of every csrc file and the flags>.so``."""
    h = hashlib.sha256(
        " ".join(NVCC_FLAGS + tuple(defines) + tuple(sources)).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[str],
          defines: Sequence[str] = ()) -> Path:
    """Compile ``sources`` with nvcc unless the hashed library exists."""
    out = library_path(name, sources, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", tmp,
           *[str(CSRC / s) for s in sources]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def load(name: str, sources: tuple, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load a kernel library; one load per process."""
    return ctypes.CDLL(str(build(name, sources, defines)))
