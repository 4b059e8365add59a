"""Heightfield terrain: the grid the physics collides against, its
lookups, SDF queries and pooling (torch), and the procedural generators
kin-gen draws terrains from (host numpy, with the JAX package's
``np.random.Generator`` calls in the same order, so a seed gives the same
heightfield bit for bit).

Grid conventions:
* ``hf[i, j]`` is the height of the cell whose *center* is at
  ``min_point + (i, j) * dxdy``; points map to cells by rounding.
* ``hf_mask`` marks cells protected from augmentation (touched by a motion).
* ``hf_maxmin[..., 0] / [..., 1]`` are per-cell max/min allowed heights for
  augmentation.

A stacked terrain holds ``hf`` (M, H, W) and ``min_point`` (M, 2); each
env then looks up its own terrain by index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from parc_torch import resolve_device


@dataclasses.dataclass
class Terrain:
    hf: torch.Tensor          # (H, W) or (M, H, W) float heights
    hf_mask: torch.Tensor     # same shape as hf, bool
    hf_maxmin: torch.Tensor   # hf.shape + (2,) max/min augmentation heights
    min_point: torch.Tensor   # (2,) or (M, 2) world xy of cell (0, 0) center
    dxdy: torch.Tensor        # (2,) cell size

    @property
    def dims(self) -> Tuple[int, int]:
        return self.hf.shape[-2], self.hf.shape[-1]

    @property
    def max_point(self) -> torch.Tensor:
        dims = torch.as_tensor(self.dims, dtype=self.min_point.dtype,
                               device=self.min_point.device)
        return self.min_point + (dims - 1) * self.dxdy


def create_terrain(x_dim: int = 16, y_dim: int = 16, dx: float = 0.4,
                   dy: Optional[float] = None, min_x: float = 0.0,
                   min_y: float = 0.0, height: float = 0.0,
                   device="cuda") -> Terrain:
    dev = resolve_device(device)
    dy = dx if dy is None else dy
    hf = torch.full((x_dim, y_dim), height, dtype=torch.float32, device=dev)
    return Terrain(
        hf=hf,
        hf_mask=torch.zeros((x_dim, y_dim), dtype=torch.bool, device=dev),
        hf_maxmin=torch.stack([hf + 3.0, hf - 3.0], dim=-1),
        min_point=torch.tensor([min_x, min_y], dtype=torch.float32,
                               device=dev),
        dxdy=torch.tensor([dx, dy], dtype=torch.float32, device=dev),
    )


def stack_terrains(terrains: Sequence[Terrain]) -> Terrain:
    """Stack R terrains into one hf (R, H, W) Terrain (edge-padded to the
    largest grid; per-terrain (R, 2) min_point). dxdy must match."""
    dev = terrains[0].hf.device
    dx0 = terrains[0].dxdy.cpu().numpy()
    h = max(int(t.hf.shape[0]) for t in terrains)
    w = max(int(t.hf.shape[1]) for t in terrains)
    hfs, mps = [], []
    for t in terrains:
        if not np.allclose(t.dxdy.cpu().numpy(), dx0):
            raise ValueError("dxdy must match across stacked terrains")
        hf = t.hf.cpu().numpy().astype(np.float32)
        hfs.append(np.pad(hf, [(0, h - hf.shape[0]), (0, w - hf.shape[1])],
                          mode="edge"))
        mps.append(t.min_point.cpu().numpy().astype(np.float32))
    hf = torch.as_tensor(np.stack(hfs), device=dev)
    return Terrain(
        hf=hf, hf_mask=torch.zeros(hf.shape, dtype=torch.bool, device=dev),
        hf_maxmin=torch.stack([hf + 3.0, hf - 3.0], dim=-1),
        min_point=torch.as_tensor(np.stack(mps), device=dev),
        dxdy=torch.as_tensor(dx0, device=dev))


# ---------------------------------------------------------------------------
# Lookups and motion-aware masks
# ---------------------------------------------------------------------------


def get_grid_index(terrain: Terrain, points_xy: torch.Tensor) -> torch.Tensor:
    """Nearest-cell (int64) indices for world xy points, clamped in-bounds
    (round half to even, as numpy and JAX round). The bounds are host
    ints, so nothing is copied to the device (a CUDA graph may hold it)."""
    inds = torch.round((points_xy - terrain.min_point) / terrain.dxdy).long()
    h, w = terrain.dims
    return torch.stack([torch.clamp(inds[..., 0], 0, h - 1),
                        torch.clamp(inds[..., 1], 0, w - 1)], dim=-1)


def get_hf_val(terrain: Terrain, points_xy: torch.Tensor) -> torch.Tensor:
    """Nearest-cell height lookup (matches the reference observation path)."""
    inds = get_grid_index(terrain, points_xy)
    return terrain.hf[inds[..., 0], inds[..., 1]]


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip as JAX differentiates it: maximum then minimum, so a value
    on a bound gets half the gradient (torch.clamp passes all of it)."""
    return torch.minimum(torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                                          device=x.device)),
                         torch.as_tensor(hi, dtype=x.dtype, device=x.device))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's gradient at 0 (+1; torch.abs gives 0)."""
    return torch.where(x >= 0, x, -x)


def _bilinear(h00, h10, h01, h11, f):
    fx, fy = f[..., 0], f[..., 1]
    return ((1 - fx) * (1 - fy) * h00 + fx * (1 - fy) * h10
            + (1 - fx) * fy * h01 + fx * fy * h11)


def get_hf_val_bilinear(terrain: Terrain,
                        points_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear height interpolation (smoother contact normals for physics)."""
    uv = (points_xy - terrain.min_point) / terrain.dxdy
    hi = torch.as_tensor(terrain.dims, device=uv.device) - 1
    uv = clip(uv, 0.0, hi.to(uv.dtype))
    i0 = torch.floor(uv).long()
    i1 = torch.minimum(i0 + 1, hi)
    f = uv - i0
    hf = terrain.hf
    return _bilinear(hf[i0[..., 0], i0[..., 1]], hf[i1[..., 0], i0[..., 1]],
                     hf[i0[..., 0], i1[..., 1]], hf[i1[..., 0], i1[..., 1]],
                     f)


def _stacked_uv(stacked: Terrain, terrain_idx: torch.Tensor,
                points_xy: torch.Tensor) -> torch.Tensor:
    """Fractional grid coords of world points in their per-row terrain.

    stacked.hf (R, H, W); terrain_idx (N,); points_xy (N, ..., 2)."""
    mp = stacked.min_point
    if mp.dim() == 2:
        mp = mp[terrain_idx]
    mp = mp.reshape((points_xy.shape[0],) + (1,) * (points_xy.dim() - 2)
                    + (2,))
    uv = (points_xy - mp) / stacked.dxdy
    hi = torch.as_tensor(stacked.hf.shape[-2:], device=uv.device) - 1
    return clip(uv, 0.0, hi.to(uv.dtype))


def _row_index(terrain_idx: torch.Tensor, like: torch.Tensor):
    return terrain_idx.reshape((-1,) + (1,) * (like.dim() - 2))


def get_hf_val_stacked(stacked: Terrain, terrain_idx: torch.Tensor,
                       points_xy: torch.Tensor) -> torch.Tensor:
    """Nearest-cell lookup where each row reads ITS OWN terrain."""
    ij = torch.round(_stacked_uv(stacked, terrain_idx, points_xy)).long()
    return stacked.hf[_row_index(terrain_idx, ij), ij[..., 0], ij[..., 1]]


def get_hf_val_bilinear_stacked(stacked: Terrain, terrain_idx: torch.Tensor,
                                points_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear per-row-terrain lookup."""
    uv = _stacked_uv(stacked, terrain_idx, points_xy)
    hi = torch.as_tensor(stacked.hf.shape[-2:], device=uv.device) - 1
    i0 = torch.floor(uv).long()
    i1 = torch.minimum(i0 + 1, hi)
    r = _row_index(terrain_idx, uv)
    hf = stacked.hf
    return _bilinear(hf[r, i0[..., 0], i0[..., 1]],
                     hf[r, i1[..., 0], i0[..., 1]],
                     hf[r, i0[..., 0], i1[..., 1]],
                     hf[r, i1[..., 0], i1[..., 1]], uv - i0)


def point_hf_penetration(terrain: Terrain,
                         points: torch.Tensor) -> torch.Tensor:
    """z distance above the heightfield cell under each point (<0 = below).

    Reference parity: util/terrain_util.py:1540-1557.
    """
    return points[..., 2] - get_hf_val(terrain, points[..., 0:2])


def get_point(terrain: Terrain, ij: torch.Tensor) -> torch.Tensor:
    """Cell-center world xy from integer grid indices."""
    return terrain.min_point + ij.to(terrain.min_point.dtype) * terrain.dxdy


# ---------------------------------------------------------------------------
# Observation sampling (envs/perception.py's patterns are laid out and
# rotated differently: these are the JAX package's generic helpers)
# ---------------------------------------------------------------------------


def local_grid_points(center_xy: torch.Tensor, heading: torch.Tensor,
                      num_x: int, num_y: int, dx: float, dy: float,
                      center_offset_x: float = 0.0) -> torch.Tensor:
    """Heading-rotated regular xy sample grid around a character.

    Returns (..., num_x * num_y, 2) world points. Used for the MDM local
    31x31 heightfield window and grid-style env observations.
    """
    dev = center_xy.device
    xs = (torch.arange(num_x, device=dev) - (num_x - 1) / 2.0) * dx \
        + center_offset_x
    ys = (torch.arange(num_y, device=dev) - (num_y - 1) / 2.0) * dy
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # (P, 2)
    c, s = torch.cos(heading)[..., None], torch.sin(heading)[..., None]
    rx = c * pts[..., 0] - s * pts[..., 1]
    ry = s * pts[..., 0] + c * pts[..., 1]
    return torch.stack([rx, ry], dim=-1) + center_xy[..., None, :]


def cone_ray_points(center_xy: torch.Tensor, heading: torch.Tensor,
                    num_rays_behind: int = 2, num_rays_ahead: int = 60,
                    num_cone_rays: int = 3,
                    cone_angle: float = 15.0 * np.pi / 180.0,
                    ray_dx: float = 0.05) -> torch.Tensor:
    """Cone-of-rays sample pattern ahead of the character.

    A center line of samples from ``-behind`` to ``+ahead`` along the heading
    with ``num_cone_rays`` additional rays fanned out on each side
    (reference: envs/ig_parkour/ig_parkour_env.py:139-155).

    Returns (..., P, 2) world points where
    ``P = (behind + ahead + 1) * (2 * num_cone_rays + 1)``.
    """
    dev = center_xy.device
    t = torch.arange(-num_rays_behind, num_rays_ahead + 1,
                     device=dev) * ray_dx                        # (L,)
    angles = torch.arange(-num_cone_rays, num_cone_rays + 1,
                          device=dev) * cone_angle               # (R,)
    ang = heading[..., None, None] + angles[None, :, None]       # (..., R, 1)
    dist = t[None, None, :]
    pts = torch.stack([torch.cos(ang) * dist, torch.sin(ang) * dist],
                      dim=-1)                                    # (..., R, L, 2)
    pts = pts.reshape(pts.shape[:-3] + (-1, 2))
    return pts + center_xy[..., None, :]


def sample_hf_obs(terrain: Terrain, points_xy: torch.Tensor,
                  root_pos: torch.Tensor) -> torch.Tensor:
    """Heights at sample points, expressed relative to the root height."""
    return get_hf_val(terrain, points_xy) - root_pos[..., 2:3]


def compute_hf_mask_inds(terrain: Terrain, body_points: torch.Tensor,
                         pad_cells: int = 1) -> torch.Tensor:
    """Boolean (H, W) mask of cells touched by character body points.

    ``body_points`` is any (..., 3) cloud (e.g. per-frame body positions or
    surface samples over a whole motion). Cells within ``pad_cells`` of a
    touched cell are also marked (reference: util/terrain_util.py:1951-1997).
    """
    mask = torch.zeros(terrain.dims, dtype=torch.bool,
                       device=terrain.hf.device)
    pts = body_points.reshape(-1, 3)
    ij = get_grid_index(terrain, pts[:, 0:2])
    mask[ij[:, 0], ij[:, 1]] = True
    if pad_cells > 0:
        size = 2 * pad_cells + 1
        mask = F.max_pool2d(mask[None, None].float(), size, stride=1,
                            padding=pad_cells)[0, 0] > 0
    return mask


def compute_hf_maxmin(terrain: Terrain, body_points: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      z_buf: float = 3.0, jump_buf: float = 0.8,
                      contact_eps: float = 0.05) -> Terrain:
    """Augmentation bounds (reference: util/terrain_util.py:2017-2047
    compute_hf_extra_vals):

    * free cells may move in [min(terrain) - z_buf, max(body z) + z_buf];
    * cells the motion touched are pinned near their current height;
    * **jump-gap carving**: touched cells the character cleared by at least
      ``jump_buf`` (min body height >= hf + jump_buf) may be carved *down*
      to a gap (hmin = global min - z_buf) and raised only up to
      ``min_body - jump_buf``: augmentation can open a gap under a jump
      but never put terrain into the flight path.
    """
    pts = body_points.reshape(-1, 3)
    if mask is None:
        mask = compute_hf_mask_inds(terrain, pts)
    h, w = terrain.dims
    ij = get_grid_index(terrain, pts[:, 0:2])
    # min body height per cell (inf where never visited)
    min_body = torch.full((h * w,), float("inf"), dtype=terrain.hf.dtype,
                          device=terrain.hf.device)
    min_body.scatter_reduce_(0, ij[:, 0] * w + ij[:, 1],
                             pts[:, 2].to(min_body.dtype), reduce="amin")
    # spread over the 3x3 neighbourhood (max-pooling pads with -inf)
    min_body = -F.max_pool2d(-min_body.reshape(1, 1, h, w), 3, stride=1,
                             padding=1)[0, 0]

    hf = terrain.hf
    max_free = torch.max(pts[:, 2]) + z_buf
    min_free = torch.min(hf) - z_buf
    hmax = torch.where(mask, hf + contact_eps, max_free)
    hmin = torch.where(mask, hf - contact_eps, min_free)
    jump = mask & ((min_body - hf) >= jump_buf)
    hmax = torch.where(jump, min_body - jump_buf, hmax)
    hmin = torch.where(jump, min_free, hmin)
    return dataclasses.replace(terrain, hf_mask=mask,
                               hf_maxmin=torch.stack([hmax, hmin], dim=-1))


# ---------------------------------------------------------------------------
# SDF queries
# ---------------------------------------------------------------------------


def _box_sdf(d: torch.Tensor) -> torch.Tensor:
    """Box SDF from the per-axis excess ``d = |p - c| - halfdims``.

    sqrt(sum^2 + eps), NOT a norm: its gradient at exactly zero is NaN, and
    optimizers drive points onto the surface through this SDF. amax/maximum
    split the gradient evenly among ties, as JAX's max does."""
    outside = torch.sqrt(torch.sum(torch.maximum(d, torch.zeros_like(d))**2,
                                   dim=-1) + 1e-12)
    inside = torch.amax(d, dim=-1)
    return outside + torch.minimum(inside, torch.zeros_like(inside))


def points_boxes_sdf(points: torch.Tensor, box_centers: torch.Tensor,
                     box_halfdims: torch.Tensor) -> torch.Tensor:
    """SDF from each point to each axis-aligned box.

    points (..., N, 3), box_centers (..., M, 3), box_halfdims (..., M, 3)
    -> (..., N, M).
    """
    d = (_abs(points[..., :, None, :] - box_centers[..., None, :, :])
         - box_halfdims[..., None, :, :])
    return _box_sdf(d)


def points_hf_sdf(points: torch.Tensor, hf: torch.Tensor,
                  hf_min_point: torch.Tensor, dxdy: torch.Tensor,
                  base_z: float = -10.0, inverted: bool = True,
                  window: int = 3) -> torch.Tensor:
    """SDF from points to a heightfield-of-boxes, over the
    ``(2*window+1)^2`` cells around each point (exact for
    |sdf| < window*dx). Each cell is a box column; ``inverted`` treats the
    air above as the solid to get interior distances (reference:
    util/terrain_util.py:1835-1893).

    points: (N, 3); hf: (H, W). Returns (N,).
    """
    dev = points.device
    hi = torch.as_tensor(hf.shape, device=dev) - 1
    k = 2 * window + 1
    ij0 = torch.round((points[..., 0:2] - hf_min_point) / dxdy).long()
    ar = torch.arange(k, device=dev) - window
    offs = torch.stack(torch.meshgrid(ar, ar, indexing="ij"),
                       dim=-1).reshape(-1, 2)
    ij = torch.minimum(torch.clamp(ij0[..., None, :] + offs, min=0), hi)
    heights = hf[ij[..., 0], ij[..., 1]]                   # (N, k*k)
    centers_xy = hf_min_point + ij.to(points.dtype) * dxdy
    if inverted:
        top_z = -base_z
        z = (heights + top_z) / 2.0
        z_half = (top_z - heights) / 2.0
    else:
        z = (heights + base_z) / 2.0
        z_half = (heights - base_z) / 2.0
    centers = torch.cat([centers_xy, z[..., None]], dim=-1)
    halfdims = torch.cat([(dxdy / 2.0).expand(centers_xy.shape),
                          z_half[..., None]], dim=-1)
    d = _abs(points[..., None, :] - centers) - halfdims
    sdf = torch.amin(_box_sdf(d), dim=-1)
    return -sdf if inverted else sdf


def terrain_sdf(terrain: Terrain, points: torch.Tensor,
                **kw) -> torch.Tensor:
    return points_hf_sdf(points, terrain.hf, terrain.min_point, terrain.dxdy,
                         **kw)


# ---------------------------------------------------------------------------
# Pool / simplify ops (respect hf_maxmin where given)
# ---------------------------------------------------------------------------


def pool_same(hf: torch.Tensor, sx: int, sy: int,
              mode: str = "max") -> torch.Tensor:
    """lax.reduce_window(max or min, (sx, sy), stride 1, "SAME") over the
    last two axes: an even window pads (s - 1) // 2 cells before and s // 2
    after (F.max_pool2d's own padding is symmetric), with -inf for max and
    +inf for min."""
    sign = 1.0 if mode == "max" else -1.0
    lead = hf.shape[:-2]
    x = (sign * hf).reshape((-1, 1) + hf.shape[-2:])
    x = F.pad(x, ((sy - 1) // 2, sy // 2, (sx - 1) // 2, sx // 2),
              value=-float("inf"))
    out = F.max_pool2d(x, (sx, sy), stride=1)
    return sign * out.reshape(lead + out.shape[-2:])


def maxpool_hf(hf: torch.Tensor, hf_maxmin: Optional[torch.Tensor],
               size: int) -> torch.Tensor:
    out = pool_same(hf, size, size, "max")
    if hf_maxmin is not None:
        out = clip(out, hf_maxmin[..., 1], hf_maxmin[..., 0])
    return out


def minpool_hf(hf: torch.Tensor, hf_maxmin: Optional[torch.Tensor],
               size: int) -> torch.Tensor:
    out = pool_same(hf, size, size, "min")
    if hf_maxmin is not None:
        out = clip(out, hf_maxmin[..., 1], hf_maxmin[..., 0])
    return out


def flat_maxpool_2x2(terrain: Terrain) -> Terrain:
    """Snap each 2x2 block to its max height (stabilizes A* planning)."""
    hf = terrain.hf
    h, w = hf.shape
    h2, w2 = h - h % 2, w - w % 2
    blocks = hf[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2)
    pooled = torch.amax(blocks, dim=(1, 3))
    flat = pooled.repeat_interleave(2, 0).repeat_interleave(2, 1)
    hf = hf.clone()
    hf[:h2, :w2] = flat
    return dataclasses.replace(terrain, hf=hf)


def _pool2d(hf: torch.Tensor, size: int, mode: str) -> torch.Tensor:
    """``lax.reduce_window`` max or min, ``size`` x ``size``, stride 1,
    "SAME" padding."""
    return pool_same(hf, size, size, mode)


def flat_maxpool_3x3(terrain: Terrain) -> Terrain:
    """Snap each non-overlapping 3x3 block to its max height; a trailing
    partial block is left untouched (reference: util/terrain_util.py:
    2099-2113, a viewer terrain-edit op)."""
    hf = terrain.hf
    h, w = hf.shape
    h3, w3 = h - h % 3, w - w % 3
    blocks = hf[:h3, :w3].reshape(h3 // 3, 3, w3 // 3, 3)
    pooled = torch.amax(blocks, dim=(1, 3))
    hf = hf.clone()
    hf[:h3, :w3] = pooled.repeat_interleave(3, 0).repeat_interleave(3, 1)
    return dataclasses.replace(terrain, hf=hf)


def downsample_terrain(terrain: Terrain) -> Terrain:
    """Halve the grid resolution: 2x2 max-pool of heights, OR of the mask,
    doubled cell size (reference: util/terrain_util.py:1631-1673, a viewer
    terrain-edit op).  Unlike the reference (which resets them), the
    augmentation bounds are pooled conservatively (max of maxes / min of
    mins)."""
    h, w = terrain.hf.shape
    h2, w2 = (h // 2) * 2, (w // 2) * 2

    def blocks(a):
        return a[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2)

    return Terrain(
        hf=torch.amax(blocks(terrain.hf), dim=(1, 3)),
        hf_mask=torch.any(torch.any(blocks(terrain.hf_mask), dim=3), dim=1),
        hf_maxmin=torch.stack(
            [torch.amax(blocks(terrain.hf_maxmin[..., 0]), dim=(1, 3)),
             torch.amin(blocks(terrain.hf_maxmin[..., 1]), dim=(1, 3))],
            dim=-1),
        min_point=terrain.min_point,
        dxdy=terrain.dxdy * 2,
    )


def remove_sharp_lines(hf: np.ndarray, eps: float = 0.1) -> np.ndarray:
    """Smooth single-cell ridges/grooves: a cell strictly above (below) both
    its x- or both its y-neighbours by ``eps`` snaps to the min (max) of its
    4-neighbourhood.  Sequential raster scan like the reference (updated
    cells feed later detections; util/terrain_util.py:260-290, a viewer
    terrain-edit op).  Host numpy — grids are small."""
    hf = np.array(hf, copy=True)
    h, w = hf.shape
    for i in range(1, h - 1):
        for j in range(1, w - 1):
            c = hf[i, j]
            nbrs = (hf[i - 1, j], hf[i + 1, j], hf[i, j - 1], hf[i, j + 1])
            high = ((c > nbrs[0] + eps and c > nbrs[1] + eps)
                    or (c > nbrs[2] + eps and c > nbrs[3] + eps))
            low = ((c < nbrs[0] - eps and c < nbrs[1] - eps)
                   or (c < nbrs[2] - eps and c < nbrs[3] - eps))
            if high:
                hf[i, j] = min(nbrs)
            elif low:
                hf[i, j] = max(nbrs)
    return hf


def flatten_4x4_near_edge(hf: np.ndarray, grid_ind, height: float
                          ) -> np.ndarray:
    """Flatten a 4x4 region around a grid cell to ``height``, aligned so
    the region starts on an even index and the cell sits in its middle 2x2
    (reference: util/terrain_util.py:2115-2133; applied around A*
    start/end nodes so planning begins on stable footing,
    parc_2_kin_gen.py:304-310)."""
    hf = np.asarray(hf).copy()
    i, j = int(grid_ind[0]), int(grid_ind[1])
    x0 = i - 2 if i % 2 == 0 else i - 1
    y0 = j - 2 if j % 2 == 0 else j - 1
    hf[max(x0, 0):x0 + 4, max(y0, 0):y0 + 4] = height
    return hf


def merge_hfs(hf1: torch.Tensor, hf_mask: torch.Tensor,
              hf_maxmin: Optional[torch.Tensor],
              hf2: torch.Tensor) -> torch.Tensor:
    """Merge a motion-protected heightfield with a free-form edit: keep
    ``hf1`` where the motion mask is set, take ``hf2`` elsewhere, clamped
    into the motion-aware ``hf_maxmin`` bounds (reference:
    util/terrain_util.py:1349-1365 merge_hfs)."""
    merged = torch.where(hf_mask, hf1, hf2)
    if hf_maxmin is not None:
        clamped = clip(merged, hf_maxmin[..., 1], hf_maxmin[..., 0])
        merged = torch.where(hf_mask, merged, clamped)
    return merged


# ---------------------------------------------------------------------------
# Slicing / padding (shapes change)
# ---------------------------------------------------------------------------


def pad_terrain(terrain: Terrain, pad: int, height: float = 0.0) -> Terrain:
    """Pad every side by ``pad`` cells of ``height`` (unmasked, bounds
    +-3 m around ``height``)."""
    hf = F.pad(terrain.hf, (pad, pad, pad, pad), value=height)
    mask = F.pad(terrain.hf_mask, (pad, pad, pad, pad), value=False)
    inner = F.pad(torch.ones(terrain.dims, dtype=torch.bool,
                             device=hf.device), (pad, pad, pad, pad),
                  value=False)
    maxmin = torch.stack([
        torch.where(inner, F.pad(terrain.hf_maxmin[..., i],
                                 (pad, pad, pad, pad)),
                    torch.full_like(hf, height + off))
        for i, off in ((0, 3.0), (1, -3.0))], dim=-1)
    return Terrain(hf=hf, hf_mask=mask, hf_maxmin=maxmin,
                   min_point=terrain.min_point - pad * terrain.dxdy,
                   dxdy=terrain.dxdy)


def slice_terrain(terrain: Terrain, min_i: int, min_j: int,
                  max_i: int, max_j: int) -> Terrain:
    off = torch.tensor([min_i, min_j], dtype=terrain.min_point.dtype,
                       device=terrain.min_point.device)
    return Terrain(
        hf=terrain.hf[min_i:max_i, min_j:max_j],
        hf_mask=terrain.hf_mask[min_i:max_i, min_j:max_j],
        hf_maxmin=terrain.hf_maxmin[min_i:max_i, min_j:max_j],
        min_point=terrain.min_point + off * terrain.dxdy,
        dxdy=terrain.dxdy)


def slice_terrain_around_points(terrain: Terrain, points_xy: np.ndarray,
                                padding: float = 1.0,
                                localize: bool = True) -> Terrain:
    """Crop the terrain to the bounding box of (host) xy points."""
    pts = np.asarray(points_xy).reshape(-1, 2)
    dxdy = terrain.dxdy.cpu().numpy()
    minp = terrain.min_point.cpu().numpy()
    dims = np.asarray(terrain.dims)
    pad = np.ceil(padding / dxdy).astype(int)
    lo = np.floor((pts.min(0) - minp) / dxdy).astype(int) - pad
    hi = np.ceil((pts.max(0) - minp) / dxdy).astype(int) + pad + 1
    lo = np.clip(lo, 0, dims - 1)
    hi = np.clip(hi, 1, dims)
    out = slice_terrain(terrain, int(lo[0]), int(lo[1]), int(hi[0]),
                        int(hi[1]))
    if localize:
        out = dataclasses.replace(out,
                                  min_point=torch.zeros_like(out.min_point))
    return out


# ---------------------------------------------------------------------------
# Procedural generation (host numpy; the JAX package's draws in its order)
# ---------------------------------------------------------------------------


def add_boxes(rng: np.random.Generator, hf: np.ndarray, num_boxes: int = 32,
              box_min_height: float = -3.0, box_max_height: float = 3.0,
              box_min_len: int = 1, box_max_len: int = 6,
              hf_maxmin: Optional[np.ndarray] = None,
              min_angle: float = 0.0,
              max_angle: float = 2.0 * np.pi) -> np.ndarray:
    """Stamp random (optionally rotated) raised/lowered boxes onto the
    heightfield (reference: util/terrain_util.py:864-917 add_boxes_to_hf2:
    boxes are rotated by a uniform angle about their center; pass
    ``max_angle=0`` for axis-aligned stamps). ``hf_maxmin`` clamps the
    result into per-cell motion-protected bounds. The result is float32."""
    h, w = hf.shape
    hf = hf.copy()
    gx, gy = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    for _ in range(num_boxes):
        c = rng.uniform(0.0, 1.0, size=2) * np.asarray([h, w], np.float32)
        blen = rng.uniform(box_min_len, box_max_len, size=2)
        ang = rng.uniform(min_angle, max_angle)
        height = np.float32(rng.uniform(box_min_height, box_max_height))
        rel_x, rel_y = gx - c[0], gy - c[1]
        ca, sa = np.cos(ang), np.sin(ang)
        rx = ca * rel_x - sa * rel_y
        ry = sa * rel_x + ca * rel_y
        in_box = (np.abs(rx) < blen[0] / 2) & (np.abs(ry) < blen[1] / 2)
        hf = np.where(in_box, height, hf)
    if hf_maxmin is not None:
        hf = np.clip(hf, hf_maxmin[..., 1], hf_maxmin[..., 0])
    return hf.astype(np.float32)


def add_boxes_at_points(rng: np.random.Generator, hf: np.ndarray,
                        centers_ij: np.ndarray,
                        min_h: float = 0.1, max_h: float = 0.6,
                        min_len: float = 2.0, max_len: float = 6.0,
                        min_angle: float = 0.0,
                        max_angle: float = np.pi) -> np.ndarray:
    """Stamp randomly-rotated boxes centered at given grid points (grid
    units): obstacles along a motion's path for terrain augmentation
    (reference: util/terrain_util.py:930-969 add_boxes_to_hf_at_xy_points)."""
    hf = hf.copy()
    gx, gy = np.meshgrid(np.arange(hf.shape[0], dtype=np.float32),
                         np.arange(hf.shape[1], dtype=np.float32),
                         indexing="ij")
    xy = np.stack([gx, gy], axis=-1)
    for c in np.asarray(centers_ij, np.float32).reshape(-1, 2):
        blen = rng.uniform(min_len, max_len, size=2)
        ang = rng.uniform(min_angle, max_angle)
        rel = xy - c
        ca, sa = np.cos(ang), np.sin(ang)
        rx = ca * rel[..., 0] - sa * rel[..., 1]
        ry = sa * rel[..., 0] + ca * rel[..., 1]
        in_box = (np.abs(rx) < blen[0] / 2) & (np.abs(ry) < blen[1] / 2)
        hf = np.where(in_box, np.float32(rng.uniform(min_h, max_h)), hf)
    return hf


def add_stairs(rng: np.random.Generator, hf: np.ndarray,
               min_start_height: float = -3.0, max_start_height: float = 1.0,
               min_step: float = 0.1, max_step: float = 0.4,
               min_width: int = 1, max_width: int = 3) -> np.ndarray:
    """Add a run of stairs along a random axis direction."""
    h, w = hf.shape
    hf = hf.copy()
    axis = rng.integers(0, 2)
    direction = rng.choice([-1, 1])
    height = rng.uniform(min_start_height, max_start_height)
    step = rng.uniform(min_step, max_step) * rng.choice([-1, 1])
    pos = 0
    n = h if axis == 0 else w
    while pos < n:
        width = int(rng.integers(min_width, max_width + 1))
        sl = slice(pos, min(pos + width, n))
        rows = sl if direction == 1 else slice(n - sl.stop, n - sl.start)
        if axis == 0:
            hf[rows, :] = height
        else:
            hf[:, rows] = height
        height += step
        pos += width
    return hf


def perlin(rng: np.random.Generator, shape: Tuple[int, int],
           res: Tuple[int, int] = (4, 4), octaves: int = 1,
           persistence: float = 0.5, amplitude: float = 1.0) -> np.ndarray:
    """Multi-octave 2D gradient (perlin) noise."""
    def fade(t):
        return 6 * t**5 - 15 * t**4 + 10 * t**3

    def one(res_):
        d0 = shape[0] // res_[0]
        d1 = shape[1] // res_[1]
        angles = 2 * np.pi * rng.random((res_[0] + 1, res_[1] + 1))
        grads = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
        g = grads.repeat(d0, 0).repeat(d1, 1)[:shape[0] + d0, :shape[1] + d1]
        xy = np.mgrid[0:shape[0], 0:shape[1]].transpose(1, 2, 0).astype(float)
        xy[..., 0] = xy[..., 0] / d0 % 1
        xy[..., 1] = xy[..., 1] / d1 % 1

        def dot(grad, shift):
            return (np.stack([xy[..., 0] + shift[0], xy[..., 1] + shift[1]],
                             axis=-1) * grad[:shape[0], :shape[1]]).sum(-1)

        n00 = dot(g[:-d0, :-d1], (0, 0))
        n10 = dot(g[d0:, :-d1], (-1, 0))
        n01 = dot(g[:-d0, d1:], (0, -1))
        n11 = dot(g[d0:, d1:], (-1, -1))
        t = fade(xy)
        nx0 = n00 * (1 - t[..., 0]) + n10 * t[..., 0]
        nx1 = n01 * (1 - t[..., 0]) + n11 * t[..., 0]
        return np.sqrt(2) * ((1 - t[..., 1]) * nx0 + t[..., 1] * nx1)

    noise = np.zeros(shape)
    freq, amp = 1, 1.0
    for _ in range(octaves):
        r = (res[0] * freq, res[1] * freq)
        if shape[0] % r[0] or shape[1] % r[1]:
            break
        noise += amp * one(r)
        freq *= 2
        amp *= persistence
    return (amplitude * noise).astype(np.float32)


def gen_curvy_paths(rng: np.random.Generator, hf: np.ndarray,
                    num_paths: int = 10, floor_height: float = -1.0,
                    path_min_height: float = -0.5,
                    path_max_height: float = 3.0, curviness: float = 7.0,
                    num_points: int = 180) -> np.ndarray:
    """Carve random-walk paths of varying heights into a low floor."""
    h, w = hf.shape
    out = np.full_like(hf, floor_height)
    for _ in range(num_paths):
        pos = np.array([rng.uniform(0, h), rng.uniform(0, w)])
        ang = rng.uniform(0, 2 * np.pi)
        height = rng.uniform(path_min_height, path_max_height)
        for _ in range(num_points):
            i, j = int(pos[0]), int(pos[1])
            if 0 <= i < h and 0 <= j < w:
                out[max(0, i - 1):i + 2, max(0, j - 1):j + 2] = height
            ang += rng.normal() * curviness * np.pi / 180.0
            pos += np.array([np.cos(ang), np.sin(ang)])
            if not (0 <= pos[0] < h and 0 <= pos[1] < w):
                break
    return out



# ---------------------------------------------------------------------------
# Export meshes and course / motion-driven generators (host numpy; the
# generators make the JAX package's np.random.Generator calls in order)
# ---------------------------------------------------------------------------


def _mesher_lib():
    import ctypes

    from parc_torch import cuda_build
    lib = cuda_build.load_host("mesher", ("mesher.cpp",))
    lib.parc_hf_mesh.restype = ctypes.c_int32
    lib.parc_hf_mesh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    return lib


def hf_to_trimesh(hf: np.ndarray, min_x: float, min_y: float, dx: float,
                  dy: float, skirt_depth: float = 10.0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Heightfield -> voxelized trimesh by the native mesher
    (``native/mesher.cpp``, built with g++ at first use; raises where it
    does not build). Each cell is a flat top quad plus a side quad toward
    every lower neighbour, and a skirt around the border.

    Returns (verts (V, 3) float32, tris (T, 3) int32).
    """
    import ctypes
    lib = _mesher_lib()
    hf = np.ascontiguousarray(hf, np.float32)
    h, w = hf.shape
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    hf_p = hf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    args = (hf_p, h, w, min_x, min_y, dx, dy, skirt_depth)
    if lib.parc_hf_mesh(*args, None, None, ctypes.byref(nv),
                        ctypes.byref(nt)) != 0:
        raise ValueError("bad mesher arguments")
    verts = np.empty((nv.value, 3), np.float32)
    tris = np.empty((nt.value, 3), np.int32)
    if lib.parc_hf_mesh(
            *args, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.byref(nv), ctypes.byref(nt)) != 0:
        raise ValueError("bad mesher arguments")
    return verts, tris


def hf_to_voxelized_trimesh(hf: np.ndarray, min_x: float, min_y: float,
                            dx: float, use_native: bool = True):
    """Minecraft-style mesh export (verts, faces) of a heightfield.

    ``use_native`` builds it with the native mesher (:func:`hf_to_trimesh`:
    only the non-coplanar side quads plus a border skirt); otherwise the
    vectorized numpy version below (every top quad and every side quad
    between neighbours). The simulator never needs it: it collides with
    the heightfield itself.
    """
    if use_native:
        return hf_to_trimesh(hf, float(min_x), float(min_y), float(dx),
                             float(dx))
    h, w = hf.shape
    half = dx / 2.0
    xs = min_x + np.arange(h) * dx
    ys = min_y + np.arange(w) * dx
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    # 4 top corners per cell
    cx = np.stack([gx - half, gx + half, gx + half, gx - half], -1)
    cy = np.stack([gy - half, gy - half, gy + half, gy + half], -1)
    cz = np.repeat(hf[..., None], 4, axis=-1)
    verts = np.stack([cx, cy, cz], -1).reshape(-1, 3)
    base = 4 * np.arange(h * w).reshape(h, w)
    top1 = np.stack([base, base + 1, base + 2], -1).reshape(-1, 3)
    top2 = np.stack([base, base + 2, base + 3], -1).reshape(-1, 3)
    faces = [top1, top2]
    # vertical side quads between x-neighbors
    b0, b1 = base[:-1, :], base[1:, :]
    # cell i side (+x) uses corners 1,2 ; cell i+1 side (-x) corners 0,3
    faces.append(np.stack([b0 + 1, b1, b0 + 2], -1).reshape(-1, 3))
    faces.append(np.stack([b0 + 2, b1, b1 + 3], -1).reshape(-1, 3))
    c0, c1 = base[:, :-1], base[:, 1:]
    faces.append(np.stack([c0 + 2, c1, c0 + 3], -1).reshape(-1, 3))
    faces.append(np.stack([c0 + 3, c1, c1 + 1], -1).reshape(-1, 3))
    return verts, np.concatenate(faces, 0)


def _centered(hf: np.ndarray, dx: float, device) -> Terrain:
    """A terrain of ``hf`` centred on the origin."""
    x_dim, y_dim = hf.shape
    t = create_terrain(x_dim, y_dim, dx=dx, min_x=-x_dim * dx / 2,
                       min_y=-y_dim * dx / 2, device=device)
    return dataclasses.replace(t, hf=torch.as_tensor(hf,
                                                     device=t.hf.device))


def linear_parkour_course(rng: np.random.Generator, x_dim: int = 48,
                          y_dim: int = 16, dx: float = 0.4,
                          num_blocks: int = 6,
                          height_range: Tuple[float, float] = (-1.0, 1.5),
                          width_range: Tuple[int, int] = (2, 6),
                          device="cuda") -> Terrain:
    """Linear parkour course: a runway along x with raised/lowered blocks at
    random stations (reference: util/terrain_util.py:320-543
    linear/random_linear_parkour_course — hf-based; the reference also
    emits a trimesh, which here comes from hf_to_voxelized_trimesh)."""
    hf = np.zeros((x_dim, y_dim), np.float32)
    stations = np.sort(rng.choice(
        np.arange(4, x_dim - 4), size=num_blocks, replace=False))
    for cx in stations:
        h = rng.uniform(*height_range)
        wx = rng.integers(*width_range)
        wy = rng.integers(y_dim // 3, y_dim)
        y0 = rng.integers(0, max(y_dim - wy, 1))
        hf[cx:cx + wx, y0:y0 + wy] = h
    return _centered(hf, dx, device)


def random_linear_parkour_course(rng: np.random.Generator,
                                 x_dim: int = 64, y_dim: int = 16,
                                 dx: float = 0.4,
                                 min_block_spacing: float = 6.5,
                                 max_block_spacing: float = 8.0,
                                 gap_width: float = 1.2,
                                 gap_height: float = -1.5,
                                 vault_width: float = 0.8,
                                 vault_height: float = 1.0,
                                 num_padding_cells: int = 2,
                                 device="cuda") -> Terrain:
    """Randomized linear parkour course (reference:
    util/terrain_util.py:427-543 random_linear_parkour_course):
    stations along the course axis spaced alternately by the min/max block
    spacing (coin flip per station), each a full-width **vault** (raised
    block to climb over) or **gap** (pit to jump across). The reference
    also emits a bespoke trimesh for PhysX; here the hf itself is the
    collision geometry (hf_to_voxelized_trimesh only for export)."""
    hf = np.zeros((x_dim, y_dim), np.float32)
    x = 0.0
    max_x_len = x_dim * dx
    centers = []
    while True:
        x += min_block_spacing if rng.random() < 0.5 else max_block_spacing
        if x >= max_x_len:
            break
        centers.append(int(round(x / dx)) + num_padding_cells)
    for c in centers:
        if c >= x_dim - num_padding_cells:
            continue
        is_vault = rng.random() < 0.5
        h = vault_height if is_vault else gap_height
        w = vault_width if is_vault else gap_width
        wc = max(int(round(w / dx)) // 2, 1)
        lo, hi = max(c - wc, 0), min(c + wc + 1, x_dim)
        hf[lo:hi, :] = h
    return _centered(hf, dx, device)


def hf_from_motion(body_pos: np.ndarray, dx: float = 0.4,
                   num_neg_x: int = 15, num_pos_x: int = 15,
                   num_neg_y: int = 15, num_pos_y: int = 15,
                   min_height: float = -2.0,
                   ground_height: float = 0.0,
                   floor_heights: Optional[np.ndarray] = None,
                   canon_idx: int = 0, device="cuda") -> Terrain:
    """Path-under-the-motion heightfield (reference:
    util/terrain_util.py:597-700 hf_from_motion): a low floor at
    ``min_height`` with a walkable path at ``ground_height`` (or the
    per-frame ``floor_heights``) carved under every body position.  Used
    to synthesize per-motion terrains for clips that have none.

    ``body_pos`` is (T, B, 3) world body positions (FK output); the grid
    is centered on the root/body position of frame ``canon_idx``.
    Returns a Terrain with ``hf_mask`` marking the path cells.
    """
    body_pos = np.asarray(body_pos)
    center = body_pos[canon_idx, 0, 0:2]
    min_point = center - dx * np.asarray([num_neg_x, num_neg_y])
    dims = (num_neg_x + num_pos_x + 1, num_neg_y + num_pos_y + 1)
    hf = np.full(dims, min_height, np.float32)
    mask = np.zeros(dims, bool)
    ij = np.round((body_pos[..., 0:2] - min_point) / dx).astype(np.int64)
    ij = np.clip(ij, 0, np.asarray(dims) - 1)       # (T, B, 2)
    if floor_heights is not None:
        # per-frame floor height, written per body column (T-major so the
        # path under later frames wins like the reference's CPU scatter)
        fh = np.broadcast_to(np.asarray(floor_heights, np.float32)[:, None],
                             ij.shape[:2])
        hf[ij[..., 0].ravel(), ij[..., 1].ravel()] = fh.ravel()
    else:
        hf[ij[..., 0].ravel(), ij[..., 1].ravel()] = ground_height
    mask[ij[..., 0].ravel(), ij[..., 1].ravel()] = True
    t = create_terrain(dims[0], dims[1], dx=dx, min_x=float(min_point[0]),
                       min_y=float(min_point[1]), device=device)
    return dataclasses.replace(
        t, hf=torch.as_tensor(hf, device=t.hf.device),
        hf_mask=torch.as_tensor(mask, device=t.hf.device))


def hf_from_motion_discrete_heights(terrain: Terrain,
                                    body_pos: np.ndarray,
                                    heights) -> Terrain:
    """Snap motion-touched cells to discrete height levels (reference:
    util/terrain_util.py:697-737 hf_from_motion_discrete_heights, driven
    by the MOTION_FORGE terrain GUI, terrain_gui.py:182).

    ``heights`` is an ascending list of allowed levels.  Per cell, the
    minimum body z that passed over it (min-pooled 7x7 like the
    reference) picks the first level above ``min_z - 0.5``; cells the
    motion never touched (``hf_mask`` False) drop to ``heights[0]``.

    ``body_pos`` is (T, B, 3) world body positions (FK output).
    """
    heights = np.asarray(heights, np.float32)
    if heights.ndim != 1 or heights.size == 0 or np.any(np.diff(heights) < 0):
        raise ValueError("heights must be a non-empty ascending sequence")
    dims = terrain.dims
    dev = terrain.hf.device
    mn = terrain.min_point.cpu().numpy()
    dxdy = terrain.dxdy.cpu().numpy()
    pts = np.asarray(body_pos).reshape(-1, 3)
    ij = np.round((pts[:, 0:2] - mn) / dxdy).astype(np.int64)
    ij = np.clip(ij, 0, np.asarray(dims) - 1)
    min_h = np.full(dims, heights[-1], np.float32)
    np.minimum.at(min_h, (ij[:, 0], ij[:, 1]), pts[:, 2].astype(np.float32))
    min_h = minpool_hf(torch.as_tensor(min_h, device=dev), None,
                       7).cpu().numpy()
    # first (lowest) level strictly above min_z - 0.5; none -> heights[0]
    k = np.searchsorted(heights, min_h - 0.5, side="right")
    snapped = heights[np.where(k < heights.size, k, 0)]
    mask = terrain.hf_mask.cpu().numpy()
    hf = np.where(mask, snapped, heights[0]).astype(np.float32)
    return dataclasses.replace(terrain, hf=torch.as_tensor(hf, device=dev))


def generate_cave(rng: np.random.Generator, x_dim: int = 48,
                  y_dim: int = 48, dx: float = 0.4,
                  num_iterations: int = 5, fill_p: float = 0.5,
                  birth_threshold: int = 6, death_threshold: int = 4,
                  wall_height: float = 3.0, device="cuda") -> Terrain:
    """Cellular-automata cave terrain (reference:
    util/terrain_util.py:2137-2166): random fill then birth/death smoothing;
    alive cells become walls."""
    alive = rng.random((x_dim, y_dim)) < fill_p
    for _ in range(num_iterations):
        padded = np.pad(alive.astype(np.int32), 1)
        count = sum(padded[1 + di:x_dim + 1 + di, 1 + dj:y_dim + 1 + dj]
                    for di in (-1, 0, 1) for dj in (-1, 0, 1))
        birth = (count >= birth_threshold) & ~alive
        death = (count <= death_threshold) & alive
        alive = (alive | birth) & ~death
    return _centered(alive.astype(np.float32) * wall_height, dx, device)
