"""The per-layer metrics that read the program's own ``parc.*`` spans
(harness/spans and metrics/*_ms): each apportions the measured idle of a
step by the traced gaps its spans label, and reads nothing where the
program opens none of them."""

import pytest

from harness import core


def _span_run(gaps, spans, replans=()):
    """A run whose step takes 2 s in the measured window and whose traced
    step is busy 1 s of it: 1,000 ms of idle a step to apportion over
    ``gaps`` (label, s; 1 s in all); ``spans`` are (name, count)."""
    from harness import trace
    tr = trace.Trace(window_s=3.0, busy_s=1.0, ops=[], gaps=gaps,
                     spans=[(n, 0.0, 1.0) for n, c in spans
                            for _ in range(c)])
    return core.Run(None, "", 40.0, 20, 1.0, {}, {"replan": list(replans)},
                    {}, tr)


def _read(name, run):
    return core.metric_reader(name).read(run)


def test_span_readers_apportion_the_measured_idle():
    """Each idle reader gives its spans' share of the traced gaps' seconds
    times the measured idle of a step (harness/spans), PyTorch's own spans
    inside the program's counted with them."""
    run = _span_run(
        [("parc.env.obs", 0.2), ("parc.env.step", 0.05),
         ("parc.env.reset", 0.05), ("parc.env.reset_pool", 0.05),
         ("parc.physics.control_step", 0.2), ("parc.ppo.act", 0.15),
         ("parc.env.replan", 0.1), ("parc.ddim.denoise", 0.1),
         ("rollout", 0.05), ("update", 0.05)],
        [("parc.env.step", 3), ("parc.env.replan", 2),
         ("parc.ddim.denoise", 6), ("parc.physics.control_step", 3),
         ("parc.ppo.act", 3)], replans=[1.2, 1.0])
    assert run.step_s * run.idle_share() / 100 == pytest.approx(1.0)
    assert _read("env.idle_ms", run) == pytest.approx(350.0)
    assert _read("physics.idle_ms", run) == pytest.approx(200.0)
    assert _read("policy.idle_ms", run) == pytest.approx(150.0)
    # 200 ms of idle a step in two replans
    assert _read("replan.idle_ms", run) == pytest.approx(100.0)
    mdm = _span_run(
        [("parc.mdm.batch", 0.1), ("parc.mdm.forward", 0.2),
         ("parc.mdm.backward", 0.2),
         ("Optimizer.zero_grad#AdamW.zero_grad", 0.05),
         ("parc.mdm.update", 0.3), ("Optimizer.step#AdamW.step", 0.1),
         ("train_step", 0.05)],
        [("parc.mdm.batch", 1), ("parc.mdm.forward", 1),
         ("parc.mdm.backward", 1), ("parc.mdm.update", 1)])
    assert _read("mdm.batch_idle_ms", mdm) == pytest.approx(100.0)
    assert _read("denoiser.train_idle_ms", mdm) == pytest.approx(450.0)
    assert _read("mdm.update_idle_ms", mdm) == pytest.approx(400.0)


def test_denoiser_call_ms_is_a_replans_ms_a_call():
    """The replan's mean CUDA-event ms times the traced replans over the
    traced denoiser calls."""
    run = _span_run([("parc.ddim.denoise", 1.0)],
                    [("parc.env.replan", 2), ("parc.ddim.denoise", 6)],
                    replans=[1.2, 1.0])
    assert _read("denoiser.call_ms", run) == pytest.approx(1100.0 * 2 / 6)
    # no replan timed in the window: nothing to divide
    assert _read("denoiser.call_ms", _span_run(
        [("parc.ddim.denoise", 1.0)],
        [("parc.env.replan", 2), ("parc.ddim.denoise", 6)])) is None


SPAN_READERS = ("env.idle_ms", "physics.idle_ms", "policy.idle_ms",
                "replan.idle_ms", "denoiser.call_ms", "mdm.batch_idle_ms",
                "mdm.update_idle_ms", "denoiser.train_idle_ms")


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_nothing_without_their_spans(name):
    """A program that opens none of the spans (the parent of the change
    that added them) reads None, not 0: the benchmark's own spans and
    PyTorch's are no stand-in."""
    run = _span_run([("rollout", 0.6), ("replan", 0.2),
                     ("Optimizer.step#AdamW.step", 0.1),
                     ("outside every span", 0.1)],
                    [("bench.rollout", 1), ("bench.replan", 2),
                     ("Optimizer.step#AdamW.step", 1)], replans=[1.1])
    assert _read(name, run) is None


def test_every_span_reader_is_in_the_benchmark(bench):
    """The span readers are per-layer metrics of the cells whose program
    opens their spans, each read from the program's spans."""
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_READERS:
        assert entries[name]["source"] == "program_span"
    assert entries["replan.idle_ms"]["workloads"] == ["tracker.parkour"]
    assert entries["mdm.update_idle_ms"]["workloads"] == ["mdm.train"]
