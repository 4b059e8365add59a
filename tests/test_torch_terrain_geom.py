"""The rest of parc_torch.utils.terrain (observation sample patterns,
pooling and edit ops, course and cave generators, terrains from motion,
mesh export through the native mesher) and parc_torch.utils.geom against
parc_tpu, on the same numpy inputs.

Tolerances:
- sample patterns (cos/sin of float32 headings): 1e-5 absolute;
  nearest-cell heights from the same points: exact;
- pooling, flat pooling, downsampling, sharp-line removal, merges, the
  generators (the same np.random.Generator calls in the same order), the
  terrains from motion and the meshes (native and numpy): exact;
- OBB overlap flags: equal (boxes drawn away from touching); OBB SDF:
  1e-6 absolute; surface point samplers (host numpy): exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.utils import geom as jgeom
from parc_tpu.utils import rotation as jrot
from parc_tpu.utils import terrain as jter
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.utils import geom as tgeom
from parc_torch.utils import terrain as tter
from test_torch_diffusion import _close, _t
from test_torch_terrain_procgen import _pair

torch.set_num_threads(1)


def _same(got, want, fields=("hf", "hf_mask", "hf_maxmin", "min_point",
                             "dxdy")):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_sample_patterns():
    rng = np.random.default_rng(0)
    hf = rng.uniform(-1, 1, (30, 26)).astype(np.float32)
    jt, tt = _pair(hf)
    ij = rng.integers(0, 26, (5, 7, 2))
    _close(tter.get_point(tt, _t(ij)), jter.get_point(jt, jnp.asarray(ij)),
           0.0, "get_point")
    center = rng.uniform(-1, 3, (4, 2)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, 4).astype(np.float32)
    for args in ((5, 7, 0.4, 0.3), (31, 31, 0.4, 0.4, 0.2), (4, 6, 0.1, 0.2)):
        want = jter.local_grid_points(jnp.asarray(center),
                                      jnp.asarray(heading), *args)
        _close(tter.local_grid_points(_t(center), _t(heading), *args), want,
               1e-5, f"local_grid_points {args}")
    for kw in ({}, dict(num_rays_behind=1, num_rays_ahead=5, num_cone_rays=2,
                        cone_angle=0.3, ray_dx=0.2)):
        want = jter.cone_ray_points(jnp.asarray(center),
                                    jnp.asarray(heading), **kw)
        got = tter.cone_ray_points(_t(center), _t(heading), **kw)
        _close(got, want, 1e-5, f"cone_ray_points {kw}")
        root = rng.uniform(0, 2, (4, 3)).astype(np.float32)
        _close(tter.sample_hf_obs(tt, _t(np.asarray(want)), _t(root)),
               jter.sample_hf_obs(jt, want, jnp.asarray(root)), 0.0,
               "sample_hf_obs")


def test_pool_and_edit_ops():
    rng = np.random.default_rng(1)
    hf = np.round(rng.uniform(-1, 1, (17, 23)), 1).astype(np.float32)
    mask = rng.random(hf.shape) < 0.3
    maxmin = np.stack([hf + rng.uniform(0, 1, hf.shape),
                       hf - rng.uniform(0, 1, hf.shape)], -1)
    jt, tt = _pair(hf, mask=mask, maxmin=maxmin)
    for size in (2, 3, 7):
        for mode in ("max", "min"):
            _close(tter._pool2d(_t(hf), size, mode),
                   jter._pool2d(jnp.asarray(hf), size, mode), 0.0,
                   f"_pool2d {size} {mode}")
    _same(tter.flat_maxpool_3x3(tt), jter.flat_maxpool_3x3(jt))
    _same(tter.downsample_terrain(tt), jter.downsample_terrain(jt))
    sharp = hf.copy()
    sharp[5, 3:20] += 2.0
    sharp[9:15, 7] -= 2.0
    for eps in (0.1, 0.5):
        np.testing.assert_array_equal(tter.remove_sharp_lines(sharp, eps),
                                      jter.remove_sharp_lines(sharp, eps))
    hf2 = rng.uniform(-3, 3, hf.shape).astype(np.float32)
    for mm in (None, maxmin):
        want = jter.merge_hfs(jnp.asarray(hf), jnp.asarray(mask),
                              None if mm is None else jnp.asarray(mm),
                              jnp.asarray(hf2))
        got = tter.merge_hfs(_t(hf), _t(mask), None if mm is None else _t(mm),
                             _t(hf2))
        _close(got, want, 0.0, "merge_hfs")


def test_course_and_cave_generators():
    for seed in range(3):
        for name, kw in (("linear_parkour_course", {}),
                         ("linear_parkour_course",
                          dict(x_dim=30, y_dim=12, num_blocks=4)),
                         ("random_linear_parkour_course", {}),
                         ("random_linear_parkour_course",
                          dict(x_dim=40, min_block_spacing=3.0)),
                         ("generate_cave", {}),
                         ("generate_cave", dict(x_dim=20, y_dim=30,
                                                num_iterations=2))):
            got = getattr(tter, name)(np.random.default_rng(seed),
                                      device="cpu", **kw)
            want = getattr(jter, name)(np.random.default_rng(seed), **kw)
            _same(got, want)


def test_terrains_from_motion():
    rng = np.random.default_rng(2)
    body = np.cumsum(rng.normal(0, 0.2, (30, 15, 3)), 0).astype(np.float32)
    body[..., 2] = np.abs(body[..., 2]) + 0.1
    floor = rng.uniform(-0.5, 0.5, 30).astype(np.float32)
    for kw in ({}, dict(floor_heights=floor, canon_idx=7, num_pos_x=20),
               dict(dx=0.2, min_height=-3.0, ground_height=0.4)):
        got = tter.hf_from_motion(body, device="cpu", **kw)
        want = jter.hf_from_motion(body, **kw)
        _same(got, want)
    base_j, base_t = jter.hf_from_motion(body), tter.hf_from_motion(
        body, device="cpu")
    for heights in ([0.0, 0.5, 1.0], [-1.0, 0.2]):
        _same(tter.hf_from_motion_discrete_heights(base_t, body, heights),
              jter.hf_from_motion_discrete_heights(base_j, body, heights))
    with pytest.raises(ValueError):
        tter.hf_from_motion_discrete_heights(base_t, body, [1.0, 0.0])


def test_mesher():
    """The native mesher, built with g++ from parc_torch/native/mesher.cpp,
    against the JAX package's build of the same source, and the numpy
    mesher against the JAX package's."""
    rng = np.random.default_rng(3)
    hf = np.round(rng.uniform(-1, 1, (9, 12)), 1).astype(np.float32)
    hf[2:4, 3:7] = 1.5
    for native in (True, False):
        gv, gf = tter.hf_to_voxelized_trimesh(hf, -1.2, 0.4, 0.4,
                                              use_native=native)
        wv, wf = jter.hf_to_voxelized_trimesh(hf, -1.2, 0.4, 0.4,
                                              use_native=native)
        np.testing.assert_array_equal(gv, wv, f"verts native={native}")
        np.testing.assert_array_equal(gf, wf, f"faces native={native}")
    v, t = tter.hf_to_trimesh(hf, -1.2, 0.4, 0.4, 0.3, skirt_depth=2.0)
    assert v.dtype == np.float32 and t.dtype == np.int32
    assert t.min() >= 0 and t.max() < len(v)
    tri = v[t]
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                   tri[:, 2] - tri[:, 0]), axis=-1)
    assert area.min() > 0


def test_obb():
    rng = np.random.default_rng(4)
    n = 64
    pos_a = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pos_b = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    dims_a = rng.uniform(0.1, 0.6, (n, 3)).astype(np.float32)
    dims_b = rng.uniform(0.1, 0.6, (n, 3)).astype(np.float32)
    quat_a = np.asarray(jrot.quat_normalize(jnp.asarray(
        rng.standard_normal((n, 4)).astype(np.float32))))
    quat_b = np.asarray(jrot.quat_normalize(jnp.asarray(
        rng.standard_normal((n, 4)).astype(np.float32))))
    args = (pos_a, dims_a, quat_a, pos_b, dims_b, quat_b)
    want = np.asarray(jgeom.obb_obb_intersect(*map(jnp.asarray, args)))
    got = tgeom.obb_obb_intersect(*map(_t, args)).numpy()
    assert 0 < want.sum() < n
    np.testing.assert_array_equal(got, want)
    pts = rng.uniform(-1.5, 1.5, (n, 9, 3)).astype(np.float32)
    _close(tgeom.points_obb_sdf(_t(pts), _t(pos_a), _t(dims_a), _t(quat_a)),
           jgeom.points_obb_sdf(jnp.asarray(pts), jnp.asarray(pos_a),
                                jnp.asarray(dims_a), jnp.asarray(quat_a)),
           1e-6, "points_obb_sdf")


def test_surface_points():
    for sub in (0, 1, 2):
        np.testing.assert_array_equal(tgeom.sphere_surface_points(0.3, sub),
                                      jgeom.sphere_surface_points(0.3, sub))
    np.testing.assert_array_equal(
        tgeom.box_surface_points((0.1, 0.2, 0.3), 3, 4, 5),
        jgeom.box_surface_points((0.1, 0.2, 0.3), 3, 4, 5))
    np.testing.assert_array_equal(
        tgeom.capsule_surface_points((0, 0, 0), (0.1, 0.2, 0.5), 0.05, 6, 3),
        jgeom.capsule_surface_points((0, 0, 0), (0.1, 0.2, 0.5), 0.05, 6, 3))
    for got, want in zip(tgeom.char_surface_points(tspec()),
                         jgeom.char_surface_points(jspec())):
        np.testing.assert_array_equal(got, want)
