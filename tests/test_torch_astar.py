"""parc_torch.procgen.astar against parc_tpu.procgen.astar.

- The port's pure-Python planner equals the JAX package's node for node
  from the same np.random.Generator at the default rand_cost_scale 0.1,
  and leaves the generator in the same state.
- The port's native planner (parc_torch/native/astar.cpp, built with g++
  into build/parc_torch/) equals the JAX package's native planner for the
  same seed (both need g++; the JAX package falls back to Python without
  it, so the test needs it).
- Native and Python agree in path cost at rand_cost_scale 0 (as
  tests/test_tools.py::test_native_astar_matches_python), to 1e-2 of the
  cost (the C++ sums in f32).
- An unreachable goal returns None; a failed native build raises.
- The endpoint picker and path helpers: exact (world nodes 1e-6).
"""

import shutil

import numpy as np
import pytest

from parc_tpu import native as jnative
from parc_tpu.procgen import astar as ja
from parc_torch import cuda_build
from parc_torch.procgen import astar as ta
from parc_torch.utils import terrain as tter

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the native planner needs g++")
DXDY = np.asarray([0.4, 0.4])


def _terrains():
    """Flat, walled, gapped (a jump edge) and random-box (two jump
    edges) heightfields with a start and a goal."""
    flat = np.zeros((24, 24), np.float32)
    wall = np.zeros((30, 30), np.float32)
    wall[12:14, :24] = 2.0
    gap = np.zeros((20, 32), np.float32)
    gap[:, 14:18] = -3.0
    boxes = tter.add_boxes(np.random.default_rng(2),
                           np.zeros((32, 32), np.float32), num_boxes=16,
                           box_min_height=-1.0, box_max_height=1.5,
                           box_min_len=2, box_max_len=8)
    return [(flat, (2, 2), (21, 20)), (wall, (2, 3), (27, 5)),
            (gap, (10, 2), (10, 29)), (boxes, (2, 2), (29, 29))]


def _cost(hf, path, s):
    """The planner's cost of a path without the random tie-breakers."""
    total = 0.0
    for (i0, j0, _), (i1, j1, jf) in zip(path[:-1], path[1:]):
        dz = abs(float(hf[i1, j1] - hf[i0, j0]))
        dist = np.hypot((i1 - i0) * DXDY[0], (j1 - j0) * DXDY[1])
        if jf:
            total += s.jump_cost_mult * (dist + s.z_weight * dz)
        else:
            patch = hf[max(i1 - 1, 0):i1 + 2, max(j1 - 1, 0):j1 + 2]
            total += (dist + s.z_weight * dz + s.bumpiness_weight
                      * float(patch.max() - patch.min()) * dist)
    return total


def test_python_planner_matches_jax():
    for k, (hf, start, goal) in enumerate(_terrains()):
        for seed in range(2):
            r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
            got = ta.run_a_star(hf, DXDY, start, goal, rng=r1,
                                use_native=False)
            want = ja.run_a_star(hf, DXDY, start, goal, rng=r2,
                                 use_native=False)
            assert got is not None, k
            np.testing.assert_array_equal(got, want, f"terrain {k}")
            assert r1.random() == r2.random()
    # the jump edges are taken across the gap
    gap = _terrains()[2]
    assert ta.run_a_star(*gap[:1], DXDY, *gap[1:], use_native=False)[
        :, 2].any()


@needs_gxx
def test_native_planner_matches_jax():
    assert jnative.available()
    for k, (hf, start, goal) in enumerate(_terrains()):
        for seed in range(3):
            r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
            got = ta.run_a_star(hf, DXDY, start, goal, rng=r1)
            want = ja.run_a_star(hf, DXDY, start, goal, rng=r2)
            np.testing.assert_array_equal(got, want, f"terrain {k}")
            assert r1.random() == r2.random()
    lib = cuda_build.BUILD_DIR.glob("astar-*.so")
    assert any(lib), "the planner builds into build/parc_torch/"


@needs_gxx
def test_native_equals_python_cost_without_noise():
    s = ta.AStarSettings(rand_cost_scale=0.0)
    for k, (hf, start, goal) in enumerate(_terrains()):
        p_n = ta.run_a_star(hf, DXDY, start, goal, s)
        p_p = ta.run_a_star(hf, DXDY, start, goal, s, use_native=False)
        assert tuple(p_n[0, :2]) == start and tuple(p_n[-1, :2]) == goal
        c_n, c_p = _cost(hf, p_n, s), _cost(hf, p_p, s)
        assert abs(c_n - c_p) < 1e-2 * max(c_p, 1.0), k


@pytest.mark.parametrize("use_native", [
    pytest.param(True, marks=needs_gxx), False])
def test_unreachable_returns_none(use_native):
    wall = np.zeros((20, 20), np.float32)
    wall[10, :] = 100.0
    rng = np.random.default_rng(0)
    assert ta.run_a_star(wall, DXDY, (2, 2), (17, 17), rng=rng,
                         use_native=use_native) is None
    if use_native:  # a goal off the grid is an error, not "unreachable"
        with pytest.raises(ValueError):
            ta.native_astar(wall, DXDY, (2, 2), (30, 17))


def test_native_build_failure_raises(monkeypatch):
    """No g++: run_a_star raises instead of falling back to Python."""
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    cuda_build.load_host.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            ta.run_a_star(np.zeros((8, 8), np.float32), DXDY, (1, 1),
                          (6, 6), rng=np.random.default_rng(0))
    finally:
        cuda_build.load_host.cache_clear()


def test_endpoints_and_path_helpers():
    hf = _terrains()[3][0]
    for seed in range(5):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = ta.pick_start_end_on_edges(hf, r1)
        assert got == ja.pick_start_end_on_edges(hf, r2)
    path = ta.run_a_star(hf, DXDY, (2, 2), (29, 29), use_native=False)
    mp = np.asarray([-1.5, 2.0])
    nodes = ta.path_to_world(path, mp, DXDY, hf)
    np.testing.assert_allclose(nodes, ja.path_to_world(path, mp, DXDY, hf),
                               atol=1e-6)
    for pps in (4, 8):
        np.testing.assert_array_equal(ta.catmull_rom_path(nodes, pps),
                                      ja.catmull_rom_path(nodes, pps))
    np.testing.assert_array_equal(
        ta.straight_line_path(nodes[0], nodes[-1], 9),
        ja.straight_line_path(nodes[0], nodes[-1], 9))
