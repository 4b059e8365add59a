"""One run of one cell: set-up, the measured window, the traced window, the
per-layer readers, the check against the reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` (which names its driver, ``drivers/<driver>.py``)
and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent      # benchmark/
ROOT = HERE.parent                                 # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "parc_tpu")
TRACE_DIR = ROOT / "build" / "benchmark" / "traces"


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules (compared whole) that no run may
    load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_module(path: Path, name: str):
    """Import the file at ``path`` (names may hold dots) as ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic_file(base: Path, name: str) -> dict:
    """``traffic/<name>.json``; one that names ``clips_from`` holds only
    what it adds to (or changes in) that mix's file."""
    p = load_json(base / "traffic" / f"{name}.json")
    if "clips_from" in p:
        p = dict(traffic_file(base, p.pop("clips_from")), **p)
    return p


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell's entries and files, the seed and
    the device."""

    bench: dict
    cell: dict        # the BENCHMARK.json workload entry
    config: dict      # configs/<config>.json
    traffic: dict     # traffic/<traffic>.json
    workload: dict    # workloads/<cell>.json
    seed: int
    device: object    # torch.device
    trace: bool
    base: Path = HERE  # the folder the files were found in


def context(bench: dict, name: str, seed: int, device, trace: bool,
            base: Path = HERE, **replace: dict) -> Context:
    """The context of cell ``name``, its files found under ``base``;
    ``config``, ``traffic`` or ``workload`` replace that file's contents
    (the tests shrink a cell so)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[name]
    files = {"config": base / "configs" / f"{cell['config']}.json",
             "traffic": base / "traffic" / f"{cell['traffic']}.json",
             "workload": base / "workloads" / f"{name}.json"}
    loaded = {k: replace[k] if k in replace else load_json(path)
              for k, path in files.items()}
    if "traffic" not in replace:
        loaded["traffic"] = traffic_file(base, cell["traffic"])
    return Context(bench=bench, cell=cell, seed=seed, device=device,
                   trace=trace, base=base, **loaded)


def driver_module(ctx: Context):
    """The cell's driver, ``drivers/<driver>.py``."""
    name = ctx.workload["driver"]
    return load_module(ctx.base / "drivers" / f"{name}.py",
                       f"bench_driver_{name}")


def metric_reader(name: str, base: Path = HERE):
    """A per-layer metric's reader, ``metrics/<name>.py``."""
    return load_module(base / "metrics" / f"{name}.py",
                       f"bench_metric_{name}")


def end_to_end_metrics(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_metrics(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end_metrics(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads (``metrics/<name>.py``'s
    ``read(run)``, which returns a number or None)."""

    ctx: Context
    device_name: str
    window_s: float
    steps: int
    units: float
    phases: Dict[str, dict]   # the program's PhaseTimer over the window
    spans: Dict[str, list]    # the benchmark's own spans, seconds each
    work: Dict[str, float]    # the cell's counts of work (harness/counts)
    trace: object             # harness.trace.Trace of the traced window
    traced_steps: int = 1     # the steps the traced window ran

    def phase_ms(self, name: str) -> Optional[float]:
        p = self.phases.get(name)
        return None if p is None or not p["count"] else p["mean_ms"]

    def span_ms(self, name: str) -> Optional[float]:
        s = self.spans.get(name) or []
        return 1e3 * sum(s) / len(s) if s else None

    @property
    def step_s(self) -> float:
        """Mean wall seconds of a step of the measured window."""
        return self.window_s / self.steps

    def idle_share(self) -> float:
        """Share of the time (%) in which no operation runs on the device:
        the traced steps' busy time against the time the same number of
        steps takes in the measured window. The profiler slows the host's
        side of a traced step (by some 60 % in a tracker iteration), so the
        traced window's own length would overstate the idle time."""
        return 100.0 * (1.0 - self.trace.busy_s
                        / (self.traced_steps * self.step_s))


def power_limit() -> str:
    """nvidia-smi's name and power limit of the first card ("" if
    nvidia-smi does not answer)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else ""


def measure(ctx: Context, seconds: float, t0: float, out=sys.stdout,
            err=sys.stderr) -> dict:
    """Set up, measure, trace, check; returns the result dict. ``t0`` is
    the process's start on the host clock (time.perf_counter)."""
    import torch
    from harness import trace as trace_lib

    dev = ctx.device
    cell = driver_module(ctx).Cell(ctx)
    cell.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0

    # the measured window: whole steps until --seconds have passed, closed
    # by a synchronize after the last
    steps, units = 0, 0.0
    w0 = time.perf_counter()
    while True:
        units += cell.step()
        steps += 1
        if time.perf_counter() - w0 >= seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - w0
    failed = cell.failed()
    phases = cell.phases()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    name = ctx.cell["name"]
    metrics = {}
    for m in end_to_end_metrics(ctx.bench, name):
        if m["name"] == "setup_s":
            v = setup_s
        elif m["name"] == ctx.workload["rate_metric"]:
            v = units / window_s
        else:
            raise KeyError(f"cell {name} has no way to read {m['name']}")
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": int(ctx.cell["chips"]),
              "memory_peak_bytes": int(peak),
              "power_limit_w": power_limit() if dev.type == "cuda" else ""}
    result = {"workload": name, "seed": ctx.seed}
    if ctx.trace:
        # a short traced window after the measured one, so the profiler
        # does not slow the window that the per-layer times come from
        traces = []
        path = str(TRACE_DIR / f"{name}-{ctx.seed}.json")
        with trace_lib.capture(path, traces, cell.span_rename):
            for _ in range(cell.trace_steps):
                cell.step(traced=True)
        tr = traces[0]
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        run = Run(ctx=ctx, device_name=device["kind"], window_s=window_s,
                  steps=steps, units=units, phases=phases,
                  spans=cell.spans, work=cell.work(), trace=tr,
                  traced_steps=cell.trace_steps)
        metrics = {}
        for m in per_layer_metrics(ctx.bench, name):
            v = metric_reader(m["name"], ctx.base).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}

    cell.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.check()
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks) and failed == 0
    result.update(correct=correct, attempted=steps, failed=failed,
                  metrics=metrics, device=device)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def parse(argv):
    ap = argparse.ArgumentParser(
        description="Run one cell of the parc_torch benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / "build" / "benchmark" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {n}. The benchmark measures only on the card and does "
              f"not fall back to the CPU.", file=sys.stderr)
        return 3
    ctx = context(bench, args.workload, args.seed, torch.device("cuda", 0),
                  bool(args.trace))
    result = measure(ctx, args.seconds, t0)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark may import none of "
              f"{FORBIDDEN}", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
