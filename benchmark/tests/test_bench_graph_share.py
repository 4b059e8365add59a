"""``env.graph_share`` (metrics/env.graph_share.py): the share of the
traced env steps that replayed their post-physics chain as one CUDA graph,
from the program's ``parc.env.graph_replay`` markers and ``parc.env.step``
spans."""

import pytest

from harness import core, trace


def _run(spans):
    """A traced run holding ``spans``, (name, count) each."""
    tr = trace.Trace(window_s=3.0, busy_s=1.0, ops=[], gaps=[],
                     spans=[(n, 0.0, 1.0) for n, c in spans
                            for _ in range(c)])
    return core.Run(None, "", 40.0, 20, 1.0, {}, {}, {}, tr)


def _read(run):
    return core.metric_reader("env.graph_share").read(run)


def test_every_step_replayed_reads_100():
    run = _run([("parc.env.step", 32), ("parc.env.graph_replay", 32),
                ("parc.env.reset_pool", 1), ("parc.ppo.act", 32)])
    assert _read(run) == pytest.approx(100.0)


def test_eager_steps_read_0():
    run = _run([("parc.env.step", 32), ("parc.env.reference", 32),
                ("parc.env.obs", 32)])
    assert _read(run) == 0.0


def test_part_of_the_steps():
    run = _run([("parc.env.step", 32), ("parc.env.graph_replay", 8)])
    assert _read(run) == pytest.approx(25.0)


def test_no_step_spans_read_none():
    """A program that opens no spans: nothing to read."""
    run = _run([("bench.rollout", 1), ("bench.train_iter", 1)])
    assert _read(run) is None


def test_in_the_benchmark(bench):
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "env.graph_share"]
    assert entry["source"] == "program_span"
    assert entry["moves"] == "tracker_samples_per_s"
    assert entry["workloads"] == ["tracker.boxes", "tracker.parkour"]
