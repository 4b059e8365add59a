"""The harness finds every configuration, cell and metric by name from its
files, a new one is added by files alone, and the yardstick's counts equal
the chip runs' figures."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import HERE
from harness import core, counts

ROOT = HERE.parent


def test_every_entry_has_its_files(bench):
    for c in bench["configs"]:
        cfg = core.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        ctx = core.context(bench, w["name"], 1, None, False)
        assert ctx.config["name"] == w["config"]
        assert hasattr(core.driver_module(ctx), "Cell")
        e2e = {m["name"] for m in core.end_to_end_metrics(bench, w["name"])}
        assert "setup_s" in e2e and ctx.workload["rate_metric"] in e2e
        assert core.per_layer_metrics(bench, w["name"])
    for m in bench["per_layer"]:
        assert callable(core.metric_reader(m["name"]).read)
        for cell in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in
                                  core.end_to_end_metrics(bench, cell)}


def test_a_cell_config_and_metric_are_added_as_files(bench, tmp_path):
    """A copy of the folder with new files only: a configuration, a traffic
    mix, a cell and a per-layer metric, found by their names."""
    base = tmp_path / "benchmark"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = core.load_json(base / "configs" / "humanoid_tracker.json")
    (base / "configs" / "humanoid_small.json").write_text(json.dumps(
        dict(cfg, name="humanoid_small")))
    (base / "traffic" / "flat.json").write_text(json.dumps(dict(
        core.load_json(base / "traffic" / "boxes.json"), clips=4)))
    (base / "workloads" / "tracker.flat.json").write_text(json.dumps(dict(
        core.load_json(base / "workloads" / "tracker.boxes.json"),
        num_envs=64)))
    (base / "metrics" / "ppo.steps.py").write_text(
        "def read(run):\n    return run.steps\n")
    added = dict(bench)
    added["configs"] = bench["configs"] + [dict(
        bench["configs"][0], name="humanoid_small",
        file="benchmark/configs/humanoid_small.json")]
    added["workloads"] = bench["workloads"] + [dict(
        name="tracker.flat", config="humanoid_small", traffic="flat",
        chips=1, why="a new cell")]
    added["end_to_end"] = [dict(m, workloads=m["workloads"] + ["tracker.flat"])
                           if "tracker.boxes" in m.get("workloads", [])
                           else m for m in bench["end_to_end"]]
    added["per_layer"] = bench["per_layer"] + [dict(
        name="ppo.steps", unit="steps", better="higher",
        source="host_clock", layer="PPO trainer",
        moves="tracker_samples_per_s", workloads=["tracker.flat"])]
    ctx = core.context(added, "tracker.flat", 1, None, False, base=base)
    assert ctx.config["name"] == "humanoid_small"
    assert ctx.traffic["clips"] == 4 and ctx.workload["num_envs"] == 64
    assert core.driver_module(ctx).Cell.__name__ == "Cell"
    assert [m["name"] for m in core.per_layer_metrics(added, "tracker.flat")
            ] == ["ppo.steps"]
    assert core.metric_reader("ppo.steps", base).read(
        core.Run(ctx, "", 1.0, 7, 1.0, {}, {}, {}, None)) == 7
    assert all(p.read_bytes() == b for p, b in before.items())


def test_counts_equal_the_chip_runs_figures():
    """A humanoid control step at 4096 envs over 3 stacked 32 x 32
    terrains, and a cached-condition denoiser call at 64 windows, as
    chip_smoke.py printed them on the card."""
    model = counts.humanoid()
    assert counts.control_step_operations(model, 4096, 2, 2) == 482_394_112
    assert counts.control_step_bytes(model, 4096, 3, 32, 32) == 11_714_416
    flops = counts.denoiser_flops(1024, 1024, 6, 15, 2, 91, 64,
                                  conditions=False)
    assert f"{flops / 1e9:.1f}" == "416.5"


def test_counts_equal_chip_smokes_functions():
    """The copies count what chip_smoke.py's originals count on the
    program's own model and denoiser."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from parc_torch.data.humanoid import humanoid_spec
    from parc_torch.diffusion.transformer import MDMTransformer
    prog = humanoid_spec().build(device="cpu")
    assert (chip_smoke.substep_operations(prog)
            == counts.substep_operations(counts.humanoid()))
    net = MDMTransformer(frame_dim=91, generator=torch.Generator())
    for b in (1, 64, 512):
        assert chip_smoke.denoiser_flops(net, b) == counts.denoiser_flops(
            1024, 1024, 6, 15, 2, 91, b, conditions=False)


def test_shares_refuse_no_time():
    assert counts.share(1.0, 4.0) == 25.0
    with pytest.raises(ValueError):
        counts.share(1.0, 0.0)


def test_no_card_no_result(tmp_path):
    """Without a card the run fails with a message and prints no result;
    it does not fall back to the CPU."""
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", "mdm.train",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout == ""
    assert "does not fall back to the CPU" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's folder
    the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "tracker.boxes",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


class _Event:
    """A raw profiler event as ``trace.reduce`` reads it."""

    def __init__(self, name, kind, start_us, dur_us, device=False):
        from torch.autograd import DeviceType
        self._n, self._k = name, kind
        self._s, self._d = start_us * 1000, dur_us * 1000
        self._dev = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_trace_counts_operations_not_spans():
    """A span's copy on the device's timeline is not device work, whatever
    its name; every host span is kept with its interval, and an idle gap
    is labelled by the innermost span open at its start."""
    from harness import trace
    ev = [_Event(trace.WINDOW, "user_annotation", 0, 1000),
          _Event("bench.rollout", "user_annotation", 0, 600),
          _Event("parc.env.obs", "user_annotation", 100, 200),
          _Event("aten::mm", "cpu_op", 110, 5),
          # device copies of the spans: not operations
          _Event("parc.env.obs", "gpu_user_annotation", 100, 400, True),
          _Event("bench.rollout", "gpu_user_annotation", 0, 900, True),
          _Event("gemm_kernel", "kernel", 150, 100, True),
          _Event("Memcpy HtoD", "gpu_memcpy", 700, 100, True)]
    tr = trace.reduce(ev)
    assert tr.busy_s == pytest.approx(200e-6)
    assert sorted(n for n, _, _ in tr.ops) == ["Memcpy HtoD", "gemm_kernel"]
    assert tr.span_times("parc.env.obs") == [pytest.approx(200e-6)]
    assert tr.host_spans()["bench.rollout"] == [1, pytest.approx(600e-6)]
    gaps = {}
    for n, s in tr.gaps:
        gaps[n] = gaps.get(n, 0.0) + s
    # idle 0-150 (starts in the rollout), 250-700 (starts in the obs
    # span) and 800-1000 (outside every span)
    assert gaps == {"rollout": pytest.approx(150e-6),
                    "parc.env.obs": pytest.approx(450e-6),
                    "outside every span": pytest.approx(200e-6)}


def test_idle_share_against_the_measured_steps():
    """The idle share weighs the traced steps' busy time against the time
    the same steps take in the measured window, not against the traced
    window the profiler slows."""
    from harness import trace
    tr = trace.Trace(window_s=9.0, busy_s=3.0, ops=[], gaps=[], spans=[])
    run = core.Run(None, "", 40.0, 20, 1.0, {}, {}, {}, tr, traced_steps=2)
    assert run.idle_share() == pytest.approx(25.0)
    for name in ("device.idle_share.tracker", "device.idle_share.mdm"):
        assert core.metric_reader(name).read(run) == pytest.approx(25.0)


def test_a_traffic_mix_builds_on_another():
    """``parkour`` names ``boxes`` as its base and adds the platform: its
    clips are the same as ``boxes``'."""
    boxes = core.traffic_file(HERE, "boxes")
    parkour = core.traffic_file(HERE, "parkour")
    assert "clips_from" not in parkour and "platform" in parkour
    assert {k: v for k, v in parkour.items() if k != "platform"} == boxes
