"""parc_torch.anim.motion_lib / motion_data / data.synthetic against the
JAX package.

Frame sampling is compared on identical tables (the JAX library carried
over with convert.motion_lib_from_numpy) at 1e-5, except the slerped
rotations at 1e-4: slerp of nearly equal quats (neighbouring frames)
takes sin(theta/2) as sqrt(1 - cos^2), which turns a one-ulp difference
in the f32 dot product cos into ~1e-5 (XLA sums that dot product with
fused multiply-adds, torch does not).
Tables built by each package are compared at 1e-5, except the finite-
difference velocities, which scale a 1e-5 rotation difference by fps = 30
(3e-4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.anim import motion_data as jmd
from parc_tpu.anim import motion_lib as jml
from parc_tpu.data import synthetic as jsyn
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_torch import convert
from parc_torch.anim import motion_data as tmd
from parc_torch.anim import motion_lib as tml
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec

from test_torch_diffusion import jit

torch.set_num_threads(1)

VEL_FIELDS = ("frame_root_ang_vel", "frame_dof_vel", "frame_root_vel")
SLERP_ATOL = 1e-4


def _clips(pkg_syn, pkg_md):
    walk = pkg_syn.walking_clip(n=40, seed=1)
    walk.loop_mode = pkg_md.WRAP
    return [pkg_syn.standing_clip(n=30), walk, pkg_syn.walking_clip(n=50, seed=2)]


@pytest.fixture(scope="module")
def libs():
    jm, tm = jspec().build(), tspec().build(device="cpu")
    jlib = jml.build_motion_lib(jm, _clips(jsyn, jmd))
    tlib = tml.build_motion_lib(tm, _clips(tsyn, tmd), device="cpu")
    return jm, tm, jlib, tlib


@pytest.fixture(scope="module")
def query():
    # WRAP motion 1 over several cycles, CLAMP motions past their ends,
    # exact frame times and t = 0
    ids = np.asarray([0, 0, 1, 1, 1, 1, 2, 2, 2, 1], np.int64)
    times = np.asarray([0.0, 5.0, 0.5, 1.3, 2.9, 7.77, 1.0 / 30, 1.6, 9.0,
                        1.0], np.float32)
    return ids, times


def test_synthetic_clips_equal():
    for jc, tc in zip(_clips(jsyn, jmd), _clips(tsyn, tmd)):
        np.testing.assert_array_equal(tc.frames, jc.frames)
        np.testing.assert_array_equal(tc.contacts, jc.contacts)
        np.testing.assert_array_equal(tc.terrain.hf, jc.terrain.hf)
        np.testing.assert_array_equal(tc.terrain.min_point, jc.terrain.min_point)
        assert tc.fps == jc.fps and tc.loop_mode == jc.loop_mode


def test_npz_interchange(tmp_path):
    clip = tsyn.walking_clip(n=20, seed=3)
    clip.hf_mask_inds = [np.asarray([[1, 2]], np.int32),
                         np.zeros((0, 2), np.int32)] * 10
    tmd.save_motion_data(str(tmp_path / "a.npz"), clip)
    back = jmd.load_motion_data(str(tmp_path / "a.npz"))
    np.testing.assert_array_equal(back.frames, clip.frames)
    jmd.save_motion_data(str(tmp_path / "b.npz"), back)
    again = tmd.load_motion_data(str(tmp_path / "b.npz"))
    np.testing.assert_array_equal(again.frames, clip.frames)
    np.testing.assert_array_equal(again.terrain.hf, clip.terrain.hf)
    assert len(again.hf_mask_inds) == 20
    np.testing.assert_array_equal(again.hf_mask_inds[0], [[1, 2]])


@pytest.mark.parametrize("field", [f for f in tml.MotionLib.__dataclass_fields__])
def test_build_motion_lib(libs, field):
    _, _, jlib, tlib = libs
    want = np.asarray(getattr(jlib, field))
    got = getattr(tlib, field).numpy()
    assert got.shape == want.shape, field
    atol = 3e-4 if field in VEL_FIELDS else 1e-5
    np.testing.assert_allclose(got, want, atol=atol, err_msg=field)


def test_calc_motion_frame(libs, query):
    jm, tm, jlib, _ = libs
    lib = convert.motion_lib_from_numpy(jax.tree.map(np.asarray, jlib))
    ids, times = query
    want = jit(lambda i, t: jml.calc_motion_frame(jlib, i, t))(
        jnp.asarray(ids, jnp.int32), jnp.asarray(times))
    got = tml.calc_motion_frame(lib, torch.as_tensor(ids), torch.as_tensor(times))
    for f in tml.MotionFrame.__dataclass_fields__:
        atol = SLERP_ATOL if f in ("root_rot", "joint_rot") else 1e-5
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=atol,
                                   err_msg=f)
    # multi-step (N, S) queries as the target-frame observation makes them
    ids2 = np.repeat(ids[:, None], 3, 1)
    times2 = times[:, None] + np.asarray([0.0, 1.0, 2.5], np.float32)
    want2 = jit(lambda i, t: jml.calc_motion_frame(jlib, i, t))(
        jnp.asarray(ids2, jnp.int32), jnp.asarray(times2))
    got2 = tml.calc_motion_frame(lib, torch.as_tensor(ids2),
                                 torch.as_tensor(times2))
    np.testing.assert_allclose(got2.joint_rot.numpy(),
                               np.asarray(want2.joint_rot), atol=SLERP_ATOL)
    np.testing.assert_allclose(got2.root_pos.numpy(),
                               np.asarray(want2.root_pos), atol=1e-5)
    np.testing.assert_allclose(
        tml.frames_34d(tm, got).numpy(),
        np.asarray(jml.frames_34d(jm, want)), atol=2 * SLERP_ATOL)


def test_frame_blend_and_loop_offset(libs, query):
    _, _, jlib, _ = libs
    lib = convert.motion_lib_from_numpy(jax.tree.map(np.asarray, jlib))
    ids, times = query
    ji, tt = jnp.asarray(ids, jnp.int32), jnp.asarray(times)
    i0, i1, b = jml.calc_frame_blend(jlib, ji, tt)
    g0, g1, gb = tml.calc_frame_blend(lib, torch.as_tensor(ids),
                                      torch.as_tensor(times))
    np.testing.assert_array_equal(g0.numpy(), np.asarray(i0))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(i1))
    np.testing.assert_allclose(gb.numpy(), np.asarray(b), atol=1e-6)
    off = tml._loop_offset(lib, torch.as_tensor(ids), torch.as_tensor(times))
    np.testing.assert_allclose(off.numpy(),
                               np.asarray(jml._loop_offset(jlib, ji, tt)),
                               atol=1e-5)
    assert float(off[5].abs().max()) > 1.0  # WRAP motion, several cycles in


def test_sampling_ranges(libs):
    _, _, _, tlib = libs
    g = torch.Generator().manual_seed(0)
    w = torch.tensor([0.0, 1.0, 3.0])
    ids = tml.sample_motions(tlib, g, 4000, weights=w)
    counts = torch.bincount(ids, minlength=3).float() / 4000
    assert counts[0] == 0 and abs(float(counts[2]) - 0.75) < 0.05
    times = tml.sample_time(tlib, g, ids, truncate_time=1.0 / 30)
    assert bool((times >= 0).all())
    assert bool((times <= tlib.lengths[ids] - 1.0 / 30 + 1e-6).all())
