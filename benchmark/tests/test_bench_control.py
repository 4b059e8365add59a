"""The control (the reference with its bf16 matmuls in fp8) and every
fault a cell can have come out as not correct under the cells' own
limits, at a size the CPU holds."""

import time

import pytest

from conftest import tiny
from harness import core

CELLS = [w["name"] for w in core.load_json(core.ROOT / "BENCHMARK.json")
         ["workloads"]]


def _faults():
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    out = []
    for name in CELLS:
        ctx = core.context(bench, name, 1, None, False)
        out += [(name, f) for f in core.driver_module(ctx).FAULTS]
    return out


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(bench, name):
    ctx = tiny(bench, name)
    driver = core.driver_module(ctx)
    cell = driver.Cell(ctx)
    cell.setup()
    cell.release()
    want = cell.reference()
    got = cell.reference(control=True)
    checks = driver.checks(got, want, ctx.workload["check"]["limits"])
    assert any(c["value"] > c["limit"] for c in checks), checks


@pytest.mark.parametrize("name,fault", _faults())
def test_fault_fails(bench, name, fault):
    """A run with the timed path broken underneath (the look for a card
    skipped): ``correct`` comes out false."""
    ctx = tiny(bench, name)
    with core.driver_module(ctx).FAULTS[fault]():
        res = core.measure(ctx, 0.5, time.perf_counter())
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_on_card(bench, name, cuda):
    """A traced run of each cell, shrunk, on the card: it runs, traces the
    device and reads every number it compares."""
    res = core.measure(tiny(bench, name, device=cuda, trace=True), 1.0,
                       time.perf_counter())
    assert res["device"]["busy_s"] > 0 and res["attempted"] >= 1
    assert all(c["value"] == c["value"] for c in res["checks"].values())
