"""parc_torch.anim.motion_edit's editing helpers (resample, slice, blend,
contacts, the stride/cut/stitch/translate/rotate/heading/scale edits, foot
plants, spatial variation, foot-penetration correction and the
motion-matching search and stitch) against parc_tpu.anim.motion_edit, on
the same numpy clips.

Tolerances (f32):
- resampled and blended frames: 1e-4 absolute (slerped rotations through
  exp maps, as tests/test_torch_motion_lib.py holds slerp);
- rigid edits (rotate, re-heading, alignment, stitch at a match) and the
  spatial variation: 1e-5 absolute on positions and exp maps (a few
  float32 quaternion products);
- foot-penetration correction: 1e-5 absolute (FK heights);
- match features: 1e-4 absolute; match error: 1e-5 relative; heading
  difference 1e-5;
- contact labels, the match indices (the first of tied minima too), the
  numpy edits (stride, cut, stitch, translate, scale, contact-run
  midpoints, foot plants) and slice_motion: exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.anim import motion_edit as jme
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.data.synthetic import standing_clip, walking_clip
from parc_tpu.utils import terrain as jter
from parc_torch.anim import motion_data as tmd
from parc_torch.anim import motion_edit as tme
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.utils import terrain as tter
from test_torch_diffusion import _close, _t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return jspec().build(), tspec().build(device="cpu")


def _clip(seed=0, n=40, turn=0.6):
    """A walking clip with a varying heading (yaw) and a small tilt."""
    f = np.asarray(walking_clip(seed=seed, n=n).frames, np.float32).copy()
    rng = np.random.default_rng(seed)
    f[:, 5] = np.linspace(0.0, turn, n)
    f[:, 3:5] += 0.05 * rng.standard_normal((n, 2)).astype(np.float32)
    return f


def test_resample_slice_blend(models):
    jm, tm = models
    a, b = _clip(0), _clip(1)
    for src, dst in ((30.0, 20.0),):
        want = np.asarray(jme.resample_fps(jm, a, src, dst))
        got = tme.resample_fps(tm, a, src, dst)
        assert got.shape == want.shape, (src, dst)
        _close(got, want, 1e-4, f"resample {src}->{dst}")
    for k in (7,):
        _close(tme.blend_motions(tm, a, b, k),
               np.asarray(jme.blend_motions(jm, jnp.asarray(a),
                                            jnp.asarray(b), k)),
               1e-4, f"blend {k}")
    clip = walking_clip(seed=2, n=30)
    tclip = tmd.MotionData(frames=clip.frames, fps=clip.fps,
                           contacts=clip.contacts)
    got, want = tme.slice_motion(tclip, 5, 17), jme.slice_motion(clip, 5, 17)
    np.testing.assert_array_equal(got.frames, want.frames)
    np.testing.assert_array_equal(got.contacts, want.contacts)
    assert got.fps == want.fps and got.loop_mode == want.loop_mode


def test_compute_contacts(models):
    """Contact labels over a box terrain, with the motion lowered so that
    some feet sit inside the eps band and some below the surface."""
    jm, tm = models
    rng = np.random.default_rng(3)
    hf = np.zeros((40, 40), np.float32)
    hf[10:20, 12:30] = 0.3
    hf[25:28, :] = -0.2
    mp = np.asarray([-4.05, -8.03], np.float32)
    dxdy = np.asarray([0.4, 0.4], np.float32)
    f = _clip(4, n=50)
    f[:, 2] -= rng.uniform(0.0, 0.1, 50).astype(np.float32)
    jt = jter.Terrain(hf=jnp.asarray(hf), hf_mask=jnp.zeros(hf.shape, bool),
                      hf_maxmin=jnp.stack([hf + 3, hf - 3], -1),
                      min_point=jnp.asarray(mp), dxdy=jnp.asarray(dxdy))
    tt = tter.Terrain(hf=_t(hf), hf_mask=torch.zeros(hf.shape, dtype=bool),
                      hf_maxmin=_t(np.stack([hf + 3, hf - 3], -1)),
                      min_point=_t(mp), dxdy=_t(dxdy))
    for eps in (0.04, 0.1):
        want = np.asarray(jme.compute_contacts(jm, jt, f, eps))
        got = tme.compute_contacts(tm, tt, f, eps).numpy()
        assert 0 < want.sum() < want.size, eps
        np.testing.assert_array_equal(got, want, f"eps {eps}")


def test_numpy_edits(models):
    jm, tm = models
    f = _clip(5, n=45)
    for fn, args in ((jme.stride_motion, (4, 30, 3)),
                     (jme.stride_motion, (0, 44, 2)),
                     (jme.cut_motion, (10, 20)),
                     (jme.stitch_motions, (f[::-1],)),
                     (jme.translate_motion, ([0.5, -1.0, 0.2],)),
                     (jme.move_xy_root_to_origin, ()),
                     (jme.scale_motion_segment, (1.3, 5, 25)),
                     (jme.scale_motion_segment, (0.7, 0, 44))):
        want = fn(f, *args)
        got = getattr(tme, fn.__name__)(f, *args)
        assert got.dtype == want.dtype, fn.__name__
        np.testing.assert_array_equal(got, want, fn.__name__)
    c = np.asarray(walking_clip(seed=1, n=90).contacts)
    c[:7, 11] = 1.0
    c[-5:, 14] = 1.0
    for col in (11, 14, 0):
        np.testing.assert_array_equal(tme._contact_chain_midpoints(c[:, col]),
                                      jme._contact_chain_midpoints(c[:, col]))
    np.testing.assert_array_equal(tme.foot_plant_frames(tm, c),
                                  jme.foot_plant_frames(jm, c))


def test_rigid_edits():
    f = _clip(6, n=30)
    rng = np.random.default_rng(6)
    for _ in range(3):
        q = rng.standard_normal(4).astype(np.float32)
        q /= np.linalg.norm(q)
        origin = rng.uniform(-2, 2, 3)
        _close(tme.rotate_motion(f, q, origin),
               jme.rotate_motion(f, q, origin), 1e-5, "rotate_motion")
    for heading, idx in ((0.7, 0), (-2.5, 12), (3.0, 29)):
        _close(tme.change_heading_at_frame(f, heading, idx),
               jme.change_heading_at_frame(f, heading, idx), 1e-5,
               f"change_heading_at_frame {heading} {idx}")
    _close(tme.align_matched_motion(f, 1.1, np.asarray([0.3, -0.4, 0.0])),
           jme.align_matched_motion(f, 1.1, np.asarray([0.3, -0.4, 0.0])),
           1e-5, "align_matched_motion")


def test_spatial_variation_and_pen_correction(models):
    jm, tm = models
    clip = walking_clip(seed=7, n=50)
    f = _clip(7, n=50)
    for seed in (0,):
        want = jme.spatially_vary_motion(jm, f, clip.contacts,
                                         np.random.default_rng(seed))
        got = tme.spatially_vary_motion(tm, f, clip.contacts,
                                        np.random.default_rng(seed))
        assert not np.allclose(want, f)
        _close(got, want, 1e-5, f"spatially_vary_motion seed {seed}")
    low = f.copy()
    low[:, 2] -= np.linspace(-0.05, 0.15, 50).astype(np.float32)
    for ground in (0.0, 0.12):
        want = jme.correct_foot_ground_pen(jm, low, ground)
        got = tme.correct_foot_ground_pen(tm, low, ground)
        assert got.dtype == want.dtype
        _close(got, want, 1e-5, f"correct_foot_ground_pen {ground}")


def test_match_search_and_stitch(models):
    jm, tm = models
    a, b = _clip(8, turn=1.2), _clip(9, turn=-0.8)
    for fj, ft in zip(jme._match_features(jm, a, 30.0),
                      tme._match_features(tm, a, 30.0)):
        _close(ft, np.asarray(fj), 1e-4, "_match_features")
    for ra, rb in ((None, None), ((5, 30), (2, 20))):
        want = jme.search_for_matching_motion_frames(jm, a, b, 30.0, ra, rb)
        got = tme.search_for_matching_motion_frames(tm, a, b, 30.0, ra, rb)
        assert got[:2] == want[:2], (got[:2], want[:2])
        assert abs(got[2] - want[2]) <= 1e-5
        _close(got[3], want[3], 1e-5, "root_pos_diff")
        _close(np.float32(got[4]), np.float32(want[4]), 1e-5, "err", rel=True)
        _close(tme.stitch_at_match(tm, a, b, 30.0, ra, rb),
               jme.stitch_at_match(jm, a, b, 30.0, ra, rb), 1e-5,
               "stitch_at_match")
    # a standing clip scores every pair alike: the first pair wins in both
    s = np.asarray(standing_clip(n=40).frames)
    want = jme.search_for_matching_motion_frames(jm, s, s, 30.0, (2, 9),
                                                 (3, 8))
    got = tme.search_for_matching_motion_frames(tm, s, s, 30.0, (2, 9),
                                                (3, 8))
    assert got[:2] == want[:2] == (2, 3), (got[:2], want[:2])
    with pytest.raises(ValueError):
        tme.search_for_matching_motion_frames(tm, a, b, 30.0, (5, 5))
