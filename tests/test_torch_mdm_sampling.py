"""parc_torch.diffusion's MDM sampling (DDIM, DDPM, guidance, in-painting,
gen_mdm_motion) against parc_tpu.diffusion at the small config of
tests/test_mdm.py, from one fresh JAX state carried over by
parc_torch.convert (tests/test_torch_mdm.py::base_setup). The initial and
per-step noise are drawn in JAX from the JAX package's keys and handed to
the port.

Tolerances (f32):
- DDIM (stride 5, 11 steps; guidance scale 1 and 2.5) and DDPM (51 steps)
  given the JAX noise: 1e-4 absolute on the unstandardized frames;
- apply_guidance (every term on), hf_guidance_x0 (2 iterations): 1e-4 of
  the largest magnitude, on x0 and the optimized heightfield;
  apply_inpaint: 1e-7;
- gen_mdm_motion on a stacked terrain: frames 2e-4 absolute, contacts
  equal where the port's value before rounding lies 0.05 or more from
  0.5; sample_local_hf on one shared terrain: 1e-6 (the same cells).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.diffusion import gen as jgen
from parc_tpu.diffusion import guidance as jguid
from parc_tpu.utils import terrain as jter
from parc_torch.anim import motion_lib as tml
from parc_torch.diffusion import gen as tgen
from parc_torch.diffusion import guidance as tguid
from parc_torch.utils import terrain as tter
from test_torch_diffusion import _close, _t, jit
from test_torch_mdm import B, base_setup

from test_torch_diffusion import jax_jit_opt0  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _opt0(jax_jit_opt0):
    """The JAX package's own jax.jit calls compile at level 0."""


@pytest.fixture(scope="module")
def setup():
    return base_setup()


def _sample_inputs(setup):
    batch = setup["batch"]
    return batch.prev_states, batch.hf, batch.target_dir


@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_ddim_sample(setup, scale):
    jm, tm, s0 = setup["jmdm"], setup["tmdm"], setup["s0"]
    ts = setup["port_state"](s0)
    prev, hf, tgt = _sample_inputs(setup)
    key = jax.random.PRNGKey(3)
    want = jit(lambda s, k, p, h, t: jm.ddim_sample(
        s, k, p, h, t, stride=5, guidance_scale=scale))(s0, key, prev, hf,
                                                        tgt)
    noise = jax.random.normal(key, (B, 15, 91))
    tm.denoise_calls = 0
    got = tm.ddim_sample(ts, None, _t(prev), _t(hf), _t(tgt), stride=5,
                         guidance_scale=scale, noise=_t(noise))
    assert tm.denoise_calls == 11
    _close(got, want, 1e-4, f"ddim scale {scale}")


def test_ddpm_sample(setup):
    jm, tm, s0 = setup["jmdm"], setup["tmdm"], setup["s0"]
    ts = setup["port_state"](s0)
    prev, hf, tgt = _sample_inputs(setup)
    key = jax.random.PRNGKey(4)
    want = jit(jm.ddpm_sample)(s0, key, prev, hf, tgt)

    def noises(key):
        k_init, k_loop = jax.random.split(key)

        def body(k, _):
            k, k_n = jax.random.split(k)
            return k, jax.random.normal(k_n, (B, 15, 91))
        return (jax.random.normal(k_init, (B, 15, 91)),
                jax.lax.scan(body, k_loop, None, length=51)[1])

    x_init, steps = jit(noises)(key)
    got = tm.ddpm_sample(ts, None, _t(prev), _t(hf), _t(tgt),
                         noise=_t(x_init), step_noise=_t(steps))
    _close(got, want, 1e-4, "ddpm")


def test_guidance_and_inpaint(setup):
    jm, tm, s0 = setup["jmdm"], setup["tmdm"], setup["s0"]
    ts = setup["port_state"](s0)
    prev, hf, tgt = _sample_inputs(setup)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(B, 15, 91)).astype(np.float32)
    txy = (2.0 * rng.normal(size=(B, 2))).astype(np.float32)
    hf = np.asarray(hf) + 0.6  # the ground above some contact points
    gp = dict(use_target=True, use_hf=True, guide_speed=True,
              guide_acc=True, guide_jerk=True, max_speed=0.5, max_acc=2.0,
              max_jerk=20.0)
    want = jit(lambda s, a, h, t: jguid.apply_guidance(
        jm, s, a, h, t, jguid.GuidanceParams(**gp)))(s0, x, hf, txy)
    got = tguid.apply_guidance(tm, ts, _t(x), _t(hf), _t(txy),
                               tguid.GuidanceParams(**gp))
    assert not np.allclose(np.asarray(want), x)
    _close(got, want, 1e-4, "apply_guidance", rel=True)

    strong = dict(use_target=True, use_hf=True, strong_hf_guidance=True,
                  hf_iters=2)
    t_batch = np.full((B,), 30, np.int32)
    prev_std = np.asarray((prev - s0.mean[:2]) / s0.std[:2])
    jx0, jhf = jit(lambda s, a: jguid.hf_guidance_x0(
        jm, s.params, s, a, t_batch, prev_std, hf, tgt, txy,
        jguid.GuidanceParams(**strong)))(s0, x)
    tx0, thf = tguid.hf_guidance_x0(
        tm, ts.net, ts, _t(x), _t(t_batch).long(), _t(prev_std), _t(hf),
        _t(tgt), _t(txy), tguid.GuidanceParams(**strong))
    assert not np.allclose(np.asarray(jhf), hf)
    _close(thf, jhf, 1e-4, "optimized hf", rel=True)
    _close(tx0, jx0, 1e-4, "x0 under hf guidance", rel=True)

    mask = np.zeros((B, 15), bool)
    mask[:, -1] = True
    paint = rng.normal(size=(B, 15, 91)).astype(np.float32)
    _close(tguid.apply_inpaint(_t(x), _t(paint), _t(mask)),
           jguid.apply_inpaint(x, paint, jnp.asarray(mask)), 1e-7)


def test_gen_mdm_motion_stacked_terrain(setup):
    jm, tm, s0 = setup["jmdm"], setup["tmdm"], setup["s0"]
    ts = setup["port_state"](s0)
    tlib, jlib = setup["tlib"], setup["jlib"]
    g = torch.Generator().manual_seed(11)
    ids = tml.sample_motions(tlib, g, B)
    times = torch.rand(B, generator=g) * 1.5
    frames = tml.calc_motion_frame(
        tlib, ids[:, None].expand(B, 2),
        times[:, None] + torch.tensor([0.0, 1.0 / 30.0]))
    prev34 = tml.frames_34d(setup["tmodel"], frames).numpy()
    contacts = frames.contacts.numpy()
    target = (prev34[:, -1, :2] + np.random.default_rng(12).normal(
        size=(B, 2)) * 2.0).astype(np.float32)
    jterrain = jter.Terrain(
        hf=jlib.terrain_hf, hf_mask=jnp.zeros(jlib.terrain_hf.shape, bool),
        hf_maxmin=jlib.terrain_maxmin, min_point=jlib.terrain_min_point,
        dxdy=jlib.terrain_dxdy)
    tterrain = tter.Terrain(
        hf=tlib.terrain_hf, hf_mask=torch.zeros_like(tlib.terrain_hf,
                                                     dtype=torch.bool),
        hf_maxmin=tlib.terrain_maxmin, min_point=tlib.terrain_min_point,
        dxdy=tlib.terrain_dxdy)
    key = jax.random.PRNGKey(5)
    settings = jgen.GenSettings(guidance_scale=2.5)
    jf, jc = jit(lambda s, k, p, c, ter, t, i: jgen.gen_mdm_motion(
        jm, s, k, p, c, ter, t, settings, terrain_idx=i))(
            s0, key, prev34, contacts, jterrain, target,
            jnp.asarray(ids.numpy(), jnp.int32))
    noise = _t(jax.random.normal(key, (B, 15, 91)))
    calls = tm.denoise_calls
    tf, tc = tgen.gen_mdm_motion(
        tm, ts, None, _t(prev34), _t(contacts), tterrain, _t(target),
        tgen.GenSettings(guidance_scale=2.5), terrain_idx=ids, noise=noise)
    assert tm.denoise_calls - calls == 11
    assert tf.shape == (B, 15, 34) and tc.shape == (B, 15, 15)
    _close(tf, jf, 2e-4, "frames")
    assert set(np.unique(tc.numpy())) <= {0.0, 1.0}
    # the port's contacts before rounding, from gen_mdm_motion's steps
    canon = _t(prev34)[:, -1]
    heading = tgen.rot.calc_heading(tgen.rot.exp_map_to_quat(canon[:, 3:6]))
    feats = tgen.features_from_frames34(tm, tgen.canonicalize(
        _t(prev34), canon[:, :2], canon[:, 2], heading), _t(contacts))
    hf = tgen.sample_local_hf(tm, tterrain, canon[:, :2], canon[:, 2],
                              heading, terrain_idx=ids)
    txy = tgen.rot.rotate_2d_vec(_t(target) - canon[:, :2], -heading)
    tdir = txy / torch.linalg.norm(txy, dim=-1, keepdim=True)
    raw = tgen.frames34_from_features(tm, tm.ddim_sample(
        ts, None, feats, hf, tdir, guidance_scale=2.5, noise=noise))[1]
    away = (raw - 0.5).abs().numpy() >= 0.05
    assert away.mean() > 0.5
    np.testing.assert_array_equal(tc.numpy()[away], np.asarray(jc)[away])


def test_sample_local_hf_single_terrain(setup):
    """One terrain shared by every row (the path beside the stacked one)."""
    jm, tm, jlib, tlib = (setup[k] for k in ("jmdm", "tmdm", "jlib", "tlib"))
    rng = np.random.default_rng(13)
    xy = rng.normal(size=(B, 2)).astype(np.float32) * 3.0
    z = rng.normal(size=(B,)).astype(np.float32) * 0.1
    heading = rng.uniform(-np.pi, np.pi, (B,)).astype(np.float32)
    hf = np.asarray(jlib.terrain_hf[1])
    jterrain = jter.Terrain(hf=jnp.asarray(hf), hf_mask=jnp.zeros(hf.shape,
                                                                  bool),
                            hf_maxmin=jnp.stack([hf + 3, hf - 3], -1),
                            min_point=jlib.terrain_min_point[1],
                            dxdy=jlib.terrain_dxdy)
    tterrain = tter.Terrain(hf=_t(hf), hf_mask=torch.zeros(hf.shape,
                                                           dtype=torch.bool),
                            hf_maxmin=_t(np.stack([hf + 3, hf - 3], -1)),
                            min_point=tlib.terrain_min_point[1],
                            dxdy=tlib.terrain_dxdy)
    want = jit(lambda ter, a, b, c: jgen.sample_local_hf(
        jm, ter, a, b, c))(jterrain, xy, z, heading)
    got = tgen.sample_local_hf(tm, tterrain, _t(xy), _t(z), _t(heading))
    assert got.shape == (B, 31, 31)
    _close(got, want, 1e-6, "local hf")
