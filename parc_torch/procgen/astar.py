"""A* path planning over heightfield terrains (host-side).

Plans navigation paths over the heightfield grid with walk edges (8
connected, gated by max step height) and jump edges (gap/cliff crossings up
to a max distance), with costs rewarding flat, direct routes plus a random
tie-breaker for diversity.

Two planners with one contract: the native C++ one (``native/astar.cpp``,
built with g++ into ``build/parc_torch/`` at first use; the default) and
the pure-Python one below (``use_native=False``). They agree exactly for
``rand_cost_scale=0`` and differ only in random tie-breaking otherwise.
There is no silent fallback: ``use_native=True`` raises if the library
cannot be built.

Reference parity: tools/procgen/astar.py:8-507 (a tiny, irregular search
that runs once per generated motion, on the host).
"""

from __future__ import annotations

import ctypes
import dataclasses
import heapq
import math
from typing import Optional, Tuple

import numpy as np

from parc_torch import cuda_build


@dataclasses.dataclass
class AStarSettings:
    """Reference: tools/procgen/astar.py:8-21."""

    max_z_diff: float = 0.5        # max walkable step height
    max_jump_dist: float = 3.0     # max jump edge length (m)
    min_jump_gap: float = 1.5      # jumps shorter than this are walks
    z_weight: float = 2.0          # cost weight on |dz|
    bumpiness_weight: float = 1.0
    rand_cost_scale: float = 0.1
    jump_cost_mult: float = 1.5


def _neighbors_walk(i, j, h, w):
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            ni, nj = i + di, j + dj
            if 0 <= ni < h and 0 <= nj < w:
                yield ni, nj


def _jump_candidates(dx: float, settings: AStarSettings):
    """Straight-line jump offsets in the 8 directions, 2..max cells."""
    max_cells = int(settings.max_jump_dist / dx)
    min_cells = max(int(settings.min_jump_gap / dx), 2)
    dirs = [(1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1),
            (-1, -1)]
    out = []
    for di, dj in dirs:
        step = math.hypot(di, dj) * dx
        for n in range(min_cells, max_cells + 1):
            if n * step <= settings.max_jump_dist:
                out.append((di * n, dj * n, n))
    return out


class _AStarSettingsC(ctypes.Structure):
    _fields_ = [(f.name, ctypes.c_float)
                for f in dataclasses.fields(AStarSettings)]


def _native_lib() -> ctypes.CDLL:
    lib = cuda_build.load_host("astar", ("astar.cpp",))
    lib.parc_astar.restype = ctypes.c_int32
    lib.parc_astar.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(_AStarSettingsC),
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32)]
    return lib


def native_astar(hf: np.ndarray, dxdy, start, goal,
                 settings: AStarSettings = AStarSettings(),
                 seed: int = 0) -> Optional[np.ndarray]:
    """The native planner: (N, 3) int32 [i, j, jump_flag] path, or None if
    the goal is unreachable. Builds the library at first use (raises if it
    cannot)."""
    lib = _native_lib()
    hf = np.ascontiguousarray(hf, np.float32)
    h, w = hf.shape
    s = _AStarSettingsC(**dataclasses.asdict(settings))
    out = np.empty((h * w, 3), np.int32)
    n = lib.parc_astar(
        hf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
        float(dxdy[0]), float(dxdy[1]), int(start[0]), int(start[1]),
        int(goal[0]), int(goal[1]), ctypes.byref(s), int(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if n < 0:
        raise ValueError("bad A* arguments")
    if n == 0:
        return None
    return out[:n].copy()


def run_a_star(hf: np.ndarray, dxdy: np.ndarray, start: Tuple[int, int],
               goal: Tuple[int, int],
               settings: AStarSettings = AStarSettings(),
               rng: Optional[np.random.Generator] = None,
               use_native: bool = True) -> Optional[np.ndarray]:
    """Plan start->goal; returns (N, 3) grid-node path [i, j, jump_flag]
    or None if unreachable.

    ``use_native`` (default) runs the C++ planner, seeded by one draw from
    ``rng``; ``use_native=False`` runs the pure-Python planner below, which
    draws its tie-breakers from ``rng``."""
    if use_native:
        seed = int(rng.integers(0, 2**63 - 1)) if rng is not None else 0
        return native_astar(hf, dxdy, start, goal, settings, seed=seed)
    rng = rng or np.random.default_rng(0)
    h, w = hf.shape
    dx = float(dxdy[0])
    jumps = _jump_candidates(dx, settings)

    def heuristic(i, j):
        return math.hypot((i - goal[0]) * dx, (j - goal[1]) * dxdy[1])

    open_heap = [(heuristic(*start), 0.0, start, None, 0)]
    came_from = {}
    g_score = {start: 0.0}
    closed = set()

    while open_heap:
        _, g, node, parent, is_jump = heapq.heappop(open_heap)
        if node in closed:
            continue
        closed.add(node)
        came_from[node] = (parent, is_jump)
        if node == goal:
            path = []
            cur = node
            while cur is not None:
                parent, jf = came_from[cur]
                path.append((cur[0], cur[1], jf))
                cur = parent
            return np.asarray(path[::-1], np.int32)

        i, j = node
        z = hf[i, j]
        # walk edges
        for ni, nj in _neighbors_walk(i, j, h, w):
            dz = hf[ni, nj] - z
            if abs(dz) > settings.max_z_diff:
                continue
            dist = math.hypot((ni - i) * dx, (nj - j) * dxdy[1])
            # local bumpiness around the target cell
            lo = max(ni - 1, 0), max(nj - 1, 0)
            hi = min(ni + 2, h), min(nj + 2, w)
            patch = hf[lo[0]:hi[0], lo[1]:hi[1]]
            bump = float(patch.max() - patch.min())
            cost = (dist + settings.z_weight * abs(dz)
                    + settings.bumpiness_weight * bump * dist
                    + settings.rand_cost_scale * rng.random())
            ng = g + cost
            nxt = (ni, nj)
            if ng < g_score.get(nxt, math.inf):
                g_score[nxt] = ng
                heapq.heappush(open_heap, (ng + heuristic(ni, nj), ng, nxt,
                                           node, 0))
        # jump edges: cross gaps/cliffs when intermediate cells are lower
        for di, dj, ncells in jumps:
            ni, nj = i + di, j + dj
            if not (0 <= ni < h and 0 <= nj < w):
                continue
            dz = hf[ni, nj] - z
            if dz > settings.max_z_diff:  # can't jump too far up
                continue
            # intermediate cells must be below both endpoints (a real gap)
            ts = np.linspace(0, 1, ncells + 1)[1:-1]
            mi = np.round(i + ts * di).astype(int)
            mj = np.round(j + ts * dj).astype(int)
            mid_max = hf[mi, mj].max() if len(mi) else -math.inf
            if mid_max > min(z, hf[ni, nj]) - 0.3:
                continue
            dist = math.hypot(di * dx, dj * dxdy[1])
            cost = settings.jump_cost_mult * (
                dist + settings.z_weight * abs(dz)
                + settings.rand_cost_scale * rng.random())
            ng = g + cost
            nxt = (ni, nj)
            if ng < g_score.get(nxt, math.inf):
                g_score[nxt] = ng
                heapq.heappush(open_heap, (ng + heuristic(ni, nj), ng, nxt,
                                           node, 1))
    return None


def pick_start_end_on_edges(hf: np.ndarray, rng: np.random.Generator,
                            min_separation_cells: int = 8
                            ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Pick random start/goal cells near opposite terrain edges
    (reference: tools/procgen/astar.py:71-95)."""
    h, w = hf.shape
    margin = 2
    for _ in range(100):
        side = rng.integers(0, 4)
        if side == 0:
            s = (margin, int(rng.integers(margin, w - margin)))
            e = (h - 1 - margin, int(rng.integers(margin, w - margin)))
        elif side == 1:
            s = (h - 1 - margin, int(rng.integers(margin, w - margin)))
            e = (margin, int(rng.integers(margin, w - margin)))
        elif side == 2:
            s = (int(rng.integers(margin, h - margin)), margin)
            e = (int(rng.integers(margin, h - margin)), w - 1 - margin)
        else:
            s = (int(rng.integers(margin, h - margin)), w - 1 - margin)
            e = (int(rng.integers(margin, h - margin)), margin)
        if abs(s[0] - e[0]) + abs(s[1] - e[1]) >= min_separation_cells:
            return s, e
    return (margin, margin), (h - 1 - margin, w - 1 - margin)


def path_to_world(path: np.ndarray, min_point: np.ndarray,
                  dxdy: np.ndarray, hf: np.ndarray) -> np.ndarray:
    """Grid path -> (N, 3) world xyz node positions."""
    xy = min_point[:2] + path[:, 0:2].astype(np.float64) * dxdy[:2]
    z = hf[path[:, 0], path[:, 1]]
    return np.concatenate([xy, z[:, None]], axis=-1).astype(np.float32)


def catmull_rom_path(nodes_xyz: np.ndarray,
                     points_per_segment: int = 8) -> np.ndarray:
    """Smooth a node path with centripetal Catmull-Rom splines
    (reference: tools/procgen/astar.py:407-506)."""
    pts = np.asarray(nodes_xyz, np.float64)
    if len(pts) < 3:
        return pts.astype(np.float32)
    padded = np.concatenate([pts[:1], pts, pts[-1:]], axis=0)
    out = []
    for i in range(len(pts) - 1):
        p0, p1, p2, p3 = padded[i:i + 4]

        def tj(ti, pa, pb):
            return ti + max(np.linalg.norm(pb - pa) ** 0.5, 1e-6)

        t0 = 0.0
        t1 = tj(t0, p0, p1)
        t2 = tj(t1, p1, p2)
        t3 = tj(t2, p2, p3)
        ts = np.linspace(t1, t2, points_per_segment, endpoint=False)
        for t in ts:
            a1 = (t1 - t) / (t1 - t0) * p0 + (t - t0) / (t1 - t0) * p1
            a2 = (t2 - t) / (t2 - t1) * p1 + (t - t1) / (t2 - t1) * p2
            a3 = (t3 - t) / (t3 - t2) * p2 + (t - t2) / (t3 - t2) * p3
            b1 = (t2 - t) / (t2 - t0) * a1 + (t - t0) / (t2 - t0) * a2
            b2 = (t3 - t) / (t3 - t1) * a2 + (t - t1) / (t3 - t1) * a3
            c = (t2 - t) / (t2 - t1) * b1 + (t - t1) / (t2 - t1) * b2
            out.append(c)
    out.append(pts[-1])
    return np.asarray(out, np.float32)


def straight_line_path(start_xyz, end_xyz, num_points: int = 16
                       ) -> np.ndarray:
    """Straight-line node path (reference alternative path generator)."""
    t = np.linspace(0.0, 1.0, num_points)[:, None]
    return ((1 - t) * np.asarray(start_xyz, np.float64)
            + t * np.asarray(end_xyz, np.float64)).astype(np.float32)
