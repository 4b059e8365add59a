"""The traced window: a torch.profiler capture of the device and of the
host's spans (``record_function`` ranges: the benchmark's own, named
``bench.*``, and any the program opens), reduced to the device's busy time,
the kernels' times by name, every host span with its interval, and the idle
gaps by the innermost span the host was in.

A span's copy on the device's timeline (a ``gpu_user_annotation``) is told
from a device operation by its kind, not by its name, so a span the
program adds never counts as device work."""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"


def span(name: str):
    """A host span of the benchmark's own, visible in the trace."""
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]    # (name, start_us, dur_us)
    gaps: List[Tuple[str, float]]          # (span the host was in, s)
    spans: List[Tuple[str, float, float]]  # (name, start_us, end_us)

    def kernel_times(self, fragment: str) -> List[float]:
        """Seconds of each device operation whose name holds ``fragment``."""
        return [d * 1e-6 for n, _, d in self.ops if fragment in n]

    def span_times(self, name: str) -> List[float]:
        """Host seconds of each span named ``name`` in the window."""
        return [(e - s) * 1e-6 for n, s, e in self.spans if n == name]

    def device_ops(self, top: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for n, _, d in self.ops:
            tot[n] += d * 1e-6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])
                ][:top]

    def host_spans(self) -> Dict[str, List[float]]:
        """Each span name's count and total host seconds."""
        out: Dict[str, List[float]] = {}
        for n, s, e in self.spans:
            c = out.setdefault(n, [0, 0.0])
            c[0] += 1
            c[1] += (e - s) * 1e-6
        return out

    def idle_gaps(self, top: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        cnt: Dict[str, int] = defaultdict(int)
        for n, s in self.gaps:
            tot[n] += s
            cnt[n] += 1
        return [[f"{n} ({cnt[n]} gaps)", s]
                for n, s in sorted(tot.items(), key=lambda kv: -kv[1])][:top]


@contextlib.contextmanager
def capture(path: str, out: list, rename: Optional[Dict[str, str]] = None):
    """Profile the body as the traced window; append its Trace to ``out``
    and write the Trace's summary (busy time, the top device operations and
    idle gaps) to ``path`` as JSON."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with span(WINDOW):
            yield
            if cuda:
                torch.cuda.synchronize()
    # the raw events: parsing them into FunctionEvents takes minutes for
    # a tracker iteration's hundreds of thousands of operations
    tr = reduce(prof.profiler.kineto_results.events(), rename)
    out.append(tr)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"window_s": tr.window_s, "busy_s": tr.busy_s,
                   "device_ops": tr.device_ops(50),
                   "idle_gaps": tr.idle_gaps(50),
                   "host_spans": tr.host_spans()}, f, indent=1)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _annotation(e) -> bool:
    """Whether a raw event is a span (a ``record_function`` range, on the
    host or its copy on the device) rather than an operation."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return "user_annotation" in str(kind())
    return bool(e.is_user_annotation())


def label(name: str) -> str:
    """A span's name as the breakdown gives it (``bench.`` dropped)."""
    return name[len("bench."):] if name.startswith("bench.") else name


def reduce(events, rename: Optional[Dict[str, str]] = None) -> Trace:
    """Busy time (the union of device operations' intervals), the device
    operations, the host's spans, and every idle gap labelled by the
    innermost host span open at its start, over the window span's interval.
    ``events`` are the profiler's raw ones (``name()``, ``device_type()``,
    ``activity_type()``, ``start_ns()``, ``duration_ns()``)."""
    from torch.autograd import DeviceType
    win, ops, spans = None, [], []
    for e in events:
        name = e.name()
        s, d = e.start_ns() * 1e-3, e.duration_ns() * 1e-3
        if _annotation(e):
            if e.device_type() != DeviceType.CPU:
                continue          # a span's copy on the device's timeline
            if name == WINDOW:
                win = (s, s + d)
            else:
                spans.append((s, s + d, name))
        elif e.device_type() == DeviceType.CUDA:
            ops.append((name, s, d))
    if win is None:
        raise RuntimeError(f"no {WINDOW} span in the trace")
    w0, w1 = win
    ops = [(n, s, d) for n, s, d in ops if s < w1 and s + d > w0]
    spans = [(s, e, n) for s, e, n in spans if s < w1 and e > w0]
    merged = _union([(max(s, w0), min(s + d, w1)) for _, s, d in ops])
    busy_us = sum(e - s for s, e in merged)
    # gaps between busy stretches, and before the first and after the last
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    spans.sort()
    starts = [s for s, _, _ in spans]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        where = "outside every span"
        # the latest-starting span that still holds the gap's start is the
        # innermost one
        for i in range(bisect.bisect_right(starts, a) - 1, -1, -1):
            s, e, n = spans[i]
            if a < e:
                where = label(n)
                break
        if rename:
            where = rename.get(where, where)
        gaps.append((where, (b - a) * 1e-6))
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6, ops=ops,
                 gaps=gaps, spans=[(n, s, e) for s, e, n in spans])
