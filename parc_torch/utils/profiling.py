"""Tracing / profiling utilities.

* ``sync`` — wait for the device work behind a tensor or on a device
  (``torch.cuda.synchronize``; nothing to wait for on the CPU).
* ``PhaseTimer`` — named per-phase wall timers that synchronize the device
  at the end of each phase, so a phase's time includes its device work.
* ``start_trace`` / ``stop_trace`` — a ``torch.profiler`` capture of the
  host and the GPU, written as a Chrome trace (open in Perfetto or
  chrome://tracing). The trainers' ``profile_iters`` (tracker) and
  ``profile_epochs`` (MDM) write one under ``<output_dir>/profile/``.
* ``annotate`` — the program's one span primitive: a named range in the
  trace while a torch profiler runs, and nothing otherwise.

The program's spans are named ``parc.<layer>.<part>``: ``parc.env.step``
with ``.reference``, ``.reward``, ``.obs``, ``.reset`` inside it
(``envs/deepmimic.py``, ``envs/parkour.py``; ``parc.env.reset_pool`` around
a rollout's reset pool; ``parc.env.graph_replay``, an instant marker closed
just before a pooled CUDA step replays its post-physics chain as one CUDA
graph, ``envs/step_graph.py``, so the gaps of the replay stay under
``parc.env.step``), ``parc.physics.control_step``
(``physics/engine.py``), ``parc.ppo.act`` (each step of
``PPOAgent.rollout``), ``parc.env.replan`` (``ParkourEnv._replan``) with
``parc.ddim.denoise`` for each DDIM timestep (``MDM.ddim_sample``),
``parc.mdm.batch``, ``.forward``, ``.backward``, ``.update`` in
``MDM.train_step``, and ``parc.vit.tokenize``, ``parc.vit.encode`` in the
ViT policy's trunk (``learning/vision_nets.py``). In a trace written by
``profile_iters`` or ``profile_epochs`` they name the code the host was
running while the device waited: each idle gap on the device's timeline
lies under the innermost span open at its start. A span reads nothing
from the device and never synchronizes; a span is stamped by the
profiler that records the device's kernels, so it shares their clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch
from torch.autograd import _profiler_enabled


def sync(x=None) -> None:
    """Wait for the device: ``x`` is a tensor (its device), a device, or
    None (nothing to wait for)."""
    if x is None:
        return
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulating named phase timers.

    >>> pt = PhaseTimer()
    >>> with pt.phase("rollout", sync_on=state.reward):
    ...     state = step(state)
    >>> pt.summary()   # {'rollout': {'total_s': ..., 'count': ..., ...}}
    """

    def __init__(self):
        self._acc = OrderedDict()

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(sync_on)
            dt = time.perf_counter() - t0
            tot, cnt = self._acc.get(name, (0.0, 0))
            self._acc[name] = (tot + dt, cnt + 1)

    def summary(self) -> "OrderedDict[str, dict]":
        out = OrderedDict()
        for name, (tot, cnt) in self._acc.items():
            out[name] = {"total_s": tot, "count": cnt,
                         "mean_ms": 1e3 * tot / max(cnt, 1)}
        return out

    def report(self) -> str:
        rows = [f"  {k:<24s} {v['mean_ms']:9.3f} ms x{v['count']:<6d} "
                f"= {v['total_s']:8.3f} s"
                for k, v in self.summary().items()]
        return "\n".join(rows)

    def reset(self):
        self._acc.clear()


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace() -> torch.profiler.profile:
    """Start a ``torch.profiler`` trace of the host and, where there is
    one, the GPU; end it with :func:`stop_trace`."""
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace under ``log_dir``."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` over the ``with`` body while a torch profiler
    runs on this thread (``torch.profiler.record_function``); otherwise
    one shared no-op context, with no ``record_function`` built: about
    0.5 us a span against about 10 us (CPU timeit)."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
