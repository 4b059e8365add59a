"""Read what the limits of a cell's ``correct`` are set from, on the card,
at the cell's own size:

    python benchmark/calibrate.py --workload <name> --seeds <n> ... \
        [--control-seeds <n> ...] [--faults half_batch answer ...] \
        [--twice] [--exact]

For each seed it drives the program through the cell's set-up (its first
steps through the timed call), the reference through the same steps, and
prints every number compared, with the driver's ``diagnostics`` where it
has them. On the control seeds it also reads the control (the reference
with its bf16 matmuls in fp8) against the reference, and on every seed each
named fault, planted in the program (``drivers/<driver>.FAULTS`` or
``EXTRA_FAULTS``). ``--twice`` also reads a second run of the reference
against the first (what the reference's own nondeterminism reads), and
``--exact`` the program run with TF32 off. One JSON line a seed on standard
output. The benchmark's runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from harness import compare, core  # noqa: E402


def readings(driver, got, want, limits):
    out = {c["name"]: c["value"]
           for c in driver.checks(got, want, limits)}
    out.update({f"grad_{k}": v for k, v in
                compare.grad_readings(got, want).items()})
    if hasattr(driver, "diagnostics"):
        out.update(driver.diagnostics(got, want))
    return out


def program(driver, ctx):
    cell = driver.Cell(ctx)
    cell.setup()
    cell.release()
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    return cell


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--twice", action="store_true")
    ap.add_argument("--exact", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate.py reads on the card only", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = core.context(bench, args.workload, seed, dev, False)
        driver = core.driver_module(ctx)
        limits = ctx.workload["check"]["limits"]
        cell = driver.Cell(ctx)
        cell.setup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        cell.release()
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        want = cell.reference()
        ref_s = time.perf_counter() - t1
        out = {"seed": seed, "setup_s": setup_s, "reference_s": ref_s,
               "peak_bytes": peak,
               "sound": readings(driver, cell.prog, want, limits),
               "loss": cell.prog["loss"], "ref_loss": want["loss"]}
        if "critic_mb" in want:
            out["critic_mb"] = [cell.prog["critic_mb"], want["critic_mb"]]
            out["actor_mb"] = [cell.prog["actor_mb"], want["actor_mb"]]
        leaves = {k: {"grad": [cell.prog["grad"].get(k), g],
                      "change": [cell.prog["change"].get(k),
                                 want["change"].get(k)],
                      "grad_max": want["grad_max"].get(k)}
                  for k, g in want["grad"].items()}
        if seed in args.control_seeds:
            got = cell.reference(control=True)
            out["control"] = readings(driver, got, want, limits)
            out["control_loss"] = got["loss"]
            for k in leaves:
                leaves[k]["grad"].append(got["grad"].get(k))
                leaves[k]["change"].append(got["change"].get(k))
        out["leaves"] = leaves
        if args.twice:
            out["ref_twice"] = readings(driver, cell.reference(), want,
                                        limits)
        if args.exact:
            from reference.tracker import float32_exact
            with float32_exact():
                exact = program(driver, ctx)
            out["exact"] = readings(driver, exact.prog, want, limits)
        faults = dict(driver.FAULTS, **getattr(driver, "EXTRA_FAULTS", {}))
        for name in args.faults:
            with faults[name]():
                bad = program(driver, ctx)
            out[name] = readings(driver, bad.prog, want, limits)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    bad = core.forbidden_modules()
    if bad:
        print(f"loaded {bad}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
