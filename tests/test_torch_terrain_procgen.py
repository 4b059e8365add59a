"""parc_torch.utils.terrain's procedural generators, pooling, padding,
slicing, heightfield lookups and SDFs against parc_tpu.utils.terrain.

Tolerances:
- generators (numpy, the same np.random.Generator calls in the same
  order), kin-gen's terrain styles, pooling, flattening, padding, slicing
  and the nearest-cell lookups: exact;
- bilinear lookups and SDF values: 1e-6 absolute (f32, heights of order 1);
- SDF gradients against jax.grad, with points placed on cell centres, on
  box faces and inside boxes (the tie cases of max/min and |x| at 0):
  1e-6 absolute.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.pipeline import kin_gen as jkg
from parc_tpu.utils import terrain as jter
from parc_torch.pipeline import kin_gen as tkg
from parc_torch.utils import terrain as tter
from test_torch_diffusion import _close, _t, jit

torch.set_num_threads(1)


def _pair(hf, min_point=(-2.0, 1.0), dx=0.4, mask=None, maxmin=None):
    hf = np.asarray(hf, np.float32)
    mask = np.zeros(hf.shape, bool) if mask is None else mask
    maxmin = (np.stack([hf + 3, hf - 3], -1) if maxmin is None
              else maxmin).astype(np.float32)
    mp = np.asarray(min_point, np.float32)
    dxdy = np.asarray([dx, dx], np.float32)
    j = jter.Terrain(hf=jnp.asarray(hf), hf_mask=jnp.asarray(mask),
                     hf_maxmin=jnp.asarray(maxmin), min_point=jnp.asarray(mp),
                     dxdy=jnp.asarray(dxdy))
    t = tter.Terrain(hf=_t(hf), hf_mask=_t(mask), hf_maxmin=_t(maxmin),
                     min_point=_t(mp), dxdy=_t(dxdy))
    return j, t


def _same_terrain(got, want):
    for f in ("hf", "hf_mask", "hf_maxmin", "min_point", "dxdy"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_generators_bit_exact():
    """Each generator from one numpy seed, with its options varied."""
    hf0 = np.random.default_rng(0).uniform(-1, 1, (30, 26)).astype(
        np.float32)
    maxmin = np.stack([hf0 + 0.5, hf0 - 0.5], -1)
    calls = [
        ("add_boxes", (hf0,), {}),
        ("add_boxes", (hf0,), dict(num_boxes=5, hf_maxmin=maxmin,
                                   max_angle=0.0)),
        ("add_boxes_at_points", (hf0, np.asarray([[3.0, 4.0], [20, 10]])),
         {}),
        ("add_stairs", (hf0,), {}),
        ("add_stairs", (hf0,), dict(min_width=2, max_width=5)),
        ("gen_curvy_paths", (hf0,), {}),
        ("gen_curvy_paths", (hf0,), dict(num_paths=3, curviness=20.0)),
    ]
    for seed in range(3):
        for name, args, kw in calls:
            got = getattr(tter, name)(np.random.default_rng(seed), *args,
                                      **kw)
            want = getattr(jter, name)(np.random.default_rng(seed), *args,
                                       **kw)
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, name)
        for kw in ({}, dict(res=(2, 4), octaves=3, amplitude=2.0)):
            np.testing.assert_array_equal(
                tter.perlin(np.random.default_rng(seed), (32, 32), **kw),
                jter.perlin(np.random.default_rng(seed), (32, 32), **kw))


@pytest.mark.parametrize("style", ["boxes", "stairs", "paths"])
def test_kin_gen_terrain_styles(style):
    """kin-gen's terrains and A* paths, drawn from one seed per stack."""
    tcfg = tkg.KinGenConfig(terrain_style=style, terrain_dim=10)
    jcfg = jkg.KinGenConfig(terrain_style=style, terrain_dim=10)
    for seed in range(3):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = tkg._draw_terrain_and_path(tcfg, r1, "cpu")
        want = jkg._draw_terrain_and_path(jcfg, r2)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
        # the streams stay in step after the draw
        assert r1.random() == r2.random()


def test_pool_flatten_pad_slice():
    rng = np.random.default_rng(1)
    hf = rng.uniform(-1, 1, (13, 10)).astype(np.float32)
    maxmin = np.stack([hf + 0.2, hf - 0.2], -1).astype(np.float32)
    jt, tt = _pair(hf, mask=hf > 0.5, maxmin=maxmin)
    for size in (2, 3, 4):
        for mm in (None, maxmin):
            for name in ("maxpool_hf", "minpool_hf"):
                got = getattr(tter, name)(_t(hf), None if mm is None
                                          else _t(mm), size)
                want = getattr(jter, name)(jnp.asarray(hf), mm, size)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              f"{name} {size}")
    _same_terrain(tter.flat_maxpool_2x2(tt), jter.flat_maxpool_2x2(jt))
    for ij in ((0, 0), (5, 4), (6, 7), (12, 9), (1, 8)):
        np.testing.assert_array_equal(
            tter.flatten_4x4_near_edge(hf, ij, 2.5),
            jter.flatten_4x4_near_edge(hf, ij, 2.5))
    for pad, h in ((1, 0.0), (3, -1.5)):
        _same_terrain(tter.pad_terrain(tt, pad, h),
                      jter.pad_terrain(jt, pad, h))
    _same_terrain(tter.slice_terrain(tt, 2, 1, 9, 7),
                  jter.slice_terrain(jt, 2, 1, 9, 7))
    pts = rng.uniform([-1.0, 1.5], [1.5, 3.0], (20, 2)).astype(np.float32)
    for pad, loc in ((1.0, True), (0.4, False), (5.0, False)):
        _same_terrain(
            tter.slice_terrain_around_points(tt, pts, pad, localize=loc),
            jter.slice_terrain_around_points(jt, pts, pad, localize=loc))


def test_hf_lookups():
    """Nearest-cell and bilinear lookups, one terrain and a stack (rows
    reading their own terrain), points inside, on and beyond the grid."""
    rng = np.random.default_rng(2)
    hfs = [rng.uniform(-1, 1, (12, 9)).astype(np.float32),
           rng.uniform(-1, 1, (10, 14)).astype(np.float32)]
    jt, tt = _pair(hfs[0])
    pts = rng.uniform([-3.0, 0.0, -1], [4.0, 5.5, 1], (6, 7, 3)).astype(
        np.float32)
    pts[0, 0, :2] = [-2.0, 1.0]                  # on cell (0, 0)'s centre
    pts[0, 1, :2] = [-2.0 + 0.4 * 11, 1.0 + 0.4 * 8]   # the last cell
    xy = pts[..., :2]
    for name in ("get_hf_val", "get_hf_val_bilinear"):
        _close(getattr(tter, name)(tt, _t(xy)),
               getattr(jter, name)(jt, jnp.asarray(xy)),
               0.0 if name == "get_hf_val" else 1e-6, name)
    _close(tter.point_hf_penetration(tt, _t(pts)),
           jter.point_hf_penetration(jt, jnp.asarray(pts)), 0.0, "pen")

    pairs = [_pair(h, mp) for h, mp in zip(hfs, ((-2.0, 1.0), (0.5, -1)))]
    jst = jter.stack_terrains([p[0] for p in pairs])
    tst = tter.stack_terrains([p[1] for p in pairs])
    idx = np.asarray([0, 1, 1, 0, 1, 0])
    for name in ("get_hf_val_stacked", "get_hf_val_bilinear_stacked"):
        got = getattr(tter, name)(tst, _t(idx).long(), _t(xy))
        want = jit(lambda s, i, p: getattr(jter, name)(s, i, p))(
            jst, jnp.asarray(idx), jnp.asarray(xy))
        _close(got, want, 0.0 if "bilinear" not in name else 1e-6, name)
    # a row of the stack reads what its own terrain reads alone
    _close(tter.get_hf_val_bilinear_stacked(tst, _t(idx).long(), _t(xy))[1],
           tter.get_hf_val_bilinear(pairs[1][1], _t(xy[1])), 1e-6, "row")


def _sdf_points(rng):
    """Points spread over a 10x8 grid at 0.4 m, plus the tie cases: on a
    cell centre's x and y, on a box face, exactly on a surface."""
    pts = rng.uniform([-2.5, 0.5, -0.8], [2.0, 4.0, 1.5], (40, 3))
    pts[0] = [-2.0 + 0.4 * 3, 1.0 + 0.4 * 2, 0.9]   # above a cell centre
    pts[1] = [-2.0 + 0.4 * 3 + 0.2, 1.0 + 0.4 * 4, 0.1]   # on a face
    pts[2] = [-2.0 + 0.4 * 5, 1.0 + 0.4 * 5, -0.5]  # inside the columns
    return pts.astype(np.float32)


def test_sdf_values_and_gradients():
    rng = np.random.default_rng(3)
    hf = (0.25 * rng.integers(-2, 3, (10, 8))).astype(np.float32)
    hf[3, 2] = 0.9                                   # pts[0] on its top
    jt, tt = _pair(hf)
    pts = _sdf_points(rng)

    def both(jfn, tfn, x, tol_msg):
        want, jg = jit(jax.value_and_grad(lambda p: jnp.sum(jfn(p) ** 2)))(
            jnp.asarray(x))
        xt = _t(x).requires_grad_(True)
        got = torch.sum(tfn(xt) ** 2)
        got.backward()
        assert torch.isfinite(xt.grad).all(), tol_msg
        _close(got.detach(), want, 1e-6 * max(1.0, float(want)), tol_msg)
        _close(xt.grad, jg, 1e-6, f"{tol_msg} gradient")

    for kw in (dict(), dict(inverted=False), dict(window=1),
               dict(base_z=-3.0, inverted=False)):
        both(lambda p: jter.terrain_sdf(jt, p, **kw),
             lambda p: tter.terrain_sdf(tt, p, **kw), pts, f"hf sdf {kw}")
        _close(tter.terrain_sdf(tt, _t(pts), **kw),
               jit(lambda p: jter.terrain_sdf(jt, p, **kw))(pts), 1e-6,
               f"hf sdf values {kw}")

    centers = rng.uniform(-1, 1, (2, 5, 3)).astype(np.float32)
    halfdims = rng.uniform(0.1, 0.6, (2, 5, 3)).astype(np.float32)
    bpts = rng.uniform(-1.5, 1.5, (2, 9, 3)).astype(np.float32)
    bpts[0, 0] = centers[0, 0]                     # the centre: |x| at 0
    bpts[0, 1] = centers[0, 1] + halfdims[0, 1] * [1, 0, 0]  # on a face
    both(lambda p: jter.points_boxes_sdf(p, centers, halfdims),
         lambda p: tter.points_boxes_sdf(p, _t(centers), _t(halfdims)),
         bpts, "boxes sdf")
