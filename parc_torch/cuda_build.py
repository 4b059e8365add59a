"""Build and load the port's native libraries: the hand-written CUDA
kernels and the host C++ planner.

Each kernel library is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with ``ctypes``; the
host library (``native/astar.cpp``) is compiled the same way by ``g++``.
The build happens at first use, into ``build/parc_torch/`` at the root of
the checkout, under a name that carries a hash of the sources and flags,
so an edited source rebuilds and an unchanged one is reused. The
compiler's report (for nvcc ``-Xptxas -v``: registers, local memory and
spills per kernel) is kept beside the library as ``<name>-<hash>.log``.
A failed build raises; nothing falls back to another implementation.
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
NATIVE = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "parc_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the JAX package's flags for the same planner source: one seed, one path
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


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


def _compile(out: Path, cmd_head: Sequence[str], sources: Sequence[Path],
             what: str) -> Path:
    """Run ``cmd_head -o <tmp> sources`` unless ``out`` exists; keep the
    compiler's output beside the library."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [*cmd_head, "-o", tmp, *[str(s) for s in sources]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{what} failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build(name: str, sources: Sequence[str],
          defines: Sequence[str] = ()) -> Path:
    """Compile ``sources`` with nvcc unless the hashed library exists."""
    return _compile(library_path(name, sources, defines),
                    [nvcc_path(), *NVCC_FLAGS, *defines],
                    [CSRC / s for s in sources], "nvcc")


@functools.cache
def load(name: str, sources: tuple, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load a kernel library; one load per process."""
    return ctypes.CDLL(str(build(name, sources, defines)))


@functools.cache
def load_host(name: str, sources: tuple) -> ctypes.CDLL:
    """Build (if needed) with g++ and load a host library from ``sources``
    (names under native/); one load per process. Raises if g++ is absent
    or the build fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native planner builds only "
                           "where a C++ compiler is installed")
    paths = [NATIVE / s for s in sources]
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for f in paths:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    return ctypes.CDLL(str(_compile(out, [gxx, *GXX_FLAGS], paths, "g++")))
