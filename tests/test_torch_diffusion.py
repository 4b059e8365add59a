"""parc_torch.diffusion's schedules, rot changer and window sampler
against parc_tpu.diffusion, on the motion library of tests/test_mdm.py.
Where the JAX package draws random numbers, the test draws them in JAX from
the same keys and hands them to the port's deterministic bodies; the
helpers that do so are shared with tests/test_torch_transformer.py,
tests/test_torch_mdm.py and tests/test_torch_mdm_sampling.py.

Tolerances (f32):
- rates tables and the timestep embedding: 1e-6 on the tables, 5e-6 on
  the embedding (its frequencies come from two exp implementations one
  ulp apart, times steps up to 50);
- local grid points, the canonical frame, the sampled batch's heightfield
  and target: 1e-5 absolute; terrain gathers at given points and split
  features: equal;
- window features (and the batch's frames and prev states): 1e-4
  absolute. They are FK positions of slerped poses, and the JAX function
  itself moves by 2.4e-5 between its jitted and its eager form (XLA fuses
  the slerp's dot product into multiply-adds, ROADMAP Queue 3); the port
  agrees with the eager form at 1.5e-7;
- the OOD heightfields, given the JAX draws: equal; the augmentation
  through the sampled batch's heightfield (above);
- exact feature stats: 1e-5 relative;
- the rot changer: 1e-5 absolute.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.anim import motion_lib as jml
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.diffusion import rot_changer as jrc
from parc_tpu.diffusion import sampler as jsam
from parc_tpu.diffusion import schedules as jsch
from parc_torch.anim import motion_lib as tml
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.diffusion import rot_changer as trc
from parc_torch.diffusion import sampler as tsam
from parc_torch.diffusion import schedules as tsch

torch.set_num_threads(1)

SCFG = jsam.SamplerConfig()
B = 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jit(fn, **kw):
    """jax.jit at XLA's backend optimization level 0: these references
    compile about a quarter faster, and agree with the default level to
    f32 rounding."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0},
                   **kw)


@pytest.fixture
def jax_jit_opt0(monkeypatch):
    """The JAX package's own ``jax.jit`` calls at XLA's backend
    optimization level 0, as :func:`jit` compiles the tests' references."""
    monkeypatch.setattr(jax, "jit", functools.partial(
        jax.jit, compiler_options={"xla_backend_optimization_level": 0}))


def _t(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def _close(got, want, tol, msg="", rel=False):
    """|got - want| <= tol (times the largest |want| if rel)."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-12) if rel else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# shared fixtures and JAX draws (used by tests/test_torch_mdm.py too)
# ---------------------------------------------------------------------------


def build_libs():
    """The motion library of tests/test_mdm.py (built by the port, then
    copied into a JAX MotionLib), with bumpy terrains and augmentation
    bounds (some cells pinned) drawn from numpy: (JAX model, JAX lib,
    port model, port lib)."""
    tmodel = tspec().build(device="cpu")
    tlib = tml.build_motion_lib(
        tmodel, [tsyn.walking_clip(seed=0),
                 tsyn.walking_clip(seed=1, speed=1.0), tsyn.standing_clip()],
        device="cpu")
    rng = np.random.default_rng(0)
    shape = tuple(tlib.terrain_hf.shape)
    hf = (0.25 * rng.integers(-1, 2, shape)
          * (rng.random(shape) < 0.3)).astype(np.float32)
    up = np.where(rng.random(shape) < 0.3, 0.0, 1.5 * rng.random(shape))
    down = np.where(rng.random(shape) < 0.3, 0.0, 1.5 * rng.random(shape))
    tlib.terrain_hf = _t(hf)
    tlib.terrain_maxmin = _t(np.stack([hf + up, hf - down], -1)
                             .astype(np.float32))
    jlib = jml.MotionLib(**{
        f: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.long
                       else v.numpy())
        for f, v in vars(tlib).items()})
    return jspec().build(), jlib, tmodel, tlib


def _jax_boxes(cfg, key, b, height_range, active_chance):
    """The boxes jsam draws from ``key`` (its split and draw order)."""
    ij, wl, height, active = [], [], [], []
    for k in jax.random.split(key, cfg.max_num_boxes):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        ij.append(jax.random.randint(
            k1, (b, 2), 0, jnp.asarray((cfg.hf_dim_x, cfg.hf_dim_y))))
        wl.append(jax.random.randint(k2, (b, 2), cfg.box_min_len,
                                     cfg.box_max_len + 1))
        height.append(jax.random.uniform(k3, (b,), minval=height_range[0],
                                         maxval=height_range[1]))
        active.append(jax.random.uniform(k4, (b,)) < active_chance)
    return dict(ij=jnp.stack(ij), wl=jnp.stack(wl), height=jnp.stack(height),
                active=jnp.stack(active))


def _jax_augment(cfg, key, b):
    k_pool, k_boxes, k_shift = jax.random.split(key, 3)
    do, size, kind = [], [], []
    for k in jax.random.split(k_pool, 3):
        k1, k2, k3 = jax.random.split(k, 3)
        do.append(jax.random.uniform(k1, (b,)) < cfg.hf_maxpool_chance)
        size.append(jax.random.randint(k2, (b,), 2,
                                       cfg.hf_max_maxpool_size + 1))
        kind.append(jax.random.randint(k3, (b,), 0, 3))
    k1, k2 = jax.random.split(k_shift)
    return dict(pool_do=jnp.stack(do), pool_size=jnp.stack(size),
                pool_kind=jnp.stack(kind),
                boxes=_jax_boxes(cfg, k_boxes, b, (-1.0, 1.5), 0.5),
                shift_do=jax.random.uniform(k1, (b,))
                < cfg.hf_change_height_chance,
                shift_dh=jax.random.uniform(k2, (b,), minval=-0.6,
                                            maxval=0.6))


def _jax_batch(cfg, jlib, key, b, augment):
    k_m, k_t, k_f, k_fn, k_aug, _ = jax.random.split(key, 6)
    return dict(
        motion_ids=jml.sample_motions(jlib, k_m, b),
        start_unit=jax.random.uniform(k_t, (b,)),
        fut_dt=jax.random.uniform(k_f, (b,), minval=cfg.future_window_min,
                                  maxval=cfg.future_window_max),
        fut_noise=jax.random.normal(k_fn, (b, 2)),
        augment=(_jax_augment(cfg, k_aug, b)
                 if augment and cfg.use_hf_augmentation else None))


def _port(cls, tree):
    """A port draws dataclass from a dict of JAX arrays (ints as int64)."""
    def conv(v):
        if not hasattr(v, "dtype"):  # a nested draws object, or None
            return v
        v = np.asarray(v)
        return _t(v, torch.long) if v.dtype.kind in "iu" else _t(v)
    return cls(**{k: conv(v) for k, v in tree.items()})


def boxes_to_port(tree):
    return _port(tsam.BoxDraws, tree)


def augment_to_port(tree):
    return _port(tsam.AugmentDraws, {**tree,
                                     "boxes": boxes_to_port(tree["boxes"])})


def jax_boxes(cfg, key, b, height_range, active_chance):
    """The boxes jsam draws from ``key``, as port draws."""
    fn = jit(_jax_boxes, static_argnums=(0, 2, 3, 4))
    return boxes_to_port(fn(cfg, key, b, height_range, active_chance))


def jax_augment_draws(cfg, key, b):
    """The draws of jsam._augment_hf(cfg, key, ...), as port draws."""
    return augment_to_port(jit(_jax_augment, static_argnums=(0, 2))(
        cfg, key, b))


def jax_batch_draws(cfg, jlib, key, b, augment=True):
    """The draws of jsam.sample_batch(..., key, b, augment), as port
    draws."""
    tree = jit(_jax_batch, static_argnums=(0, 3, 4))(cfg, jlib, key, b,
                                                          augment)
    aug = tree["augment"]
    return _port(tsam.BatchDraws, {
        **tree, "augment": None if aug is None else augment_to_port(aug)})


@pytest.fixture(scope="module")
def libs():
    return build_libs()


# ---------------------------------------------------------------------------
# schedules and the rot changer
# ---------------------------------------------------------------------------


def test_rates_and_timestep_embedding():
    for n in (51, 1001):
        jr, tr = jsch.make_rates(n), tsch.make_rates(n)
        assert tr.num_timesteps == n
        for f in tsch.DiffusionRates.__dataclass_fields__:
            _close(getattr(tr, f), getattr(jr, f), 1e-6, f)
    t = np.arange(0, 51, dtype=np.int32)
    for dim in (64, 1024):
        _close(tsch.timestep_embedding(_t(t), dim),
               jsch.timestep_embedding(jnp.asarray(t), dim), 5e-6)
    rng = np.random.default_rng(1)
    x0, noise = rng.normal(size=(2, 4, 5, 3)).astype(np.float32)
    tt = rng.integers(0, 51, (4,))
    _close(tsch.forward_diffusion(tsch.make_rates(51), _t(x0), _t(tt),
                                  _t(noise)),
           jsch.forward_diffusion(jsch.make_rates(51), x0, jnp.asarray(tt),
                                  noise), 1e-6)


@pytest.mark.parametrize("rot_type", trc.ROT_TYPES)
def test_rot_changer(libs, rot_type):
    jmodel, _, tmodel, _ = libs
    rng = np.random.default_rng(2)
    frames = (0.5 * rng.normal(size=(6, 34))).astype(np.float32)
    jr, tr = jrc.RotChanger(jmodel, rot_type), trc.RotChanger(tmodel,
                                                              rot_type)
    assert tr.frame_dim == jr.frame_dim
    enc = tr.from_frames34(_t(frames))
    _close(enc, jit(jr.from_frames34)(frames), 1e-5)
    _close(tr.to_frames34(enc), jit(jr.to_frames34)(enc.numpy()), 1e-5)


# ---------------------------------------------------------------------------
# the window sampler
# ---------------------------------------------------------------------------


def test_window_features_grid_and_gathers(libs):
    jmodel, jlib, tmodel, tlib = libs
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 3, (B,)).astype(np.int32)
    t0 = (rng.random(B) * 2.4).astype(np.float32)
    jf, jc = jit(lambda lib, i, t: jsam.window_features(
        jmodel, SCFG, lib, i, t))(jlib, jnp.asarray(ids), jnp.asarray(t0))
    tf, tc = tsam.window_features(tmodel, SCFG, tlib, _t(ids, torch.long),
                                  _t(t0))
    _close(tf, jf, 1e-4, "features")
    for got, want in zip(tc, jc):
        _close(got, want, 1e-5, "canonical frame")
    jsplit = jsam.split_features(jmodel, jnp.asarray(tf.numpy()))
    for k, v in tsam.split_features(tmodel, tf).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jsplit[k]))
    # points off the grid and past its edges (clipped), ties included
    jpts = jit(jsam._local_hf_points, static_argnums=0)(SCFG, jc[0],
                                                            jc[2])
    tpts = tsam._local_hf_points(SCFG, tc[0], tc[2])
    _close(tpts, jpts, 1e-5, "grid points")
    pts = np.concatenate([np.asarray(jpts).reshape(B, -1, 2)[:, :200],
                          (rng.normal(size=(B, 40, 2)) * 8.0),
                          np.round(rng.normal(size=(B, 20, 2)) * 10) * 0.2
                          + 0.1], 1).astype(np.float32)[:, :, None]
    jhf, jmm = jit(jsam._gather_terrain)(jlib, jnp.asarray(ids),
                                             jnp.asarray(pts))
    thf, tmm = tsam._gather_terrain(tlib, _t(ids, torch.long), _t(pts))
    np.testing.assert_array_equal(thf.numpy(), np.asarray(jhf))
    np.testing.assert_array_equal(tmm.numpy(), np.asarray(jmm))


def test_ood_hfs_equal_given_draws():
    cfg = SCFG
    rng = np.random.default_rng(4)
    center = rng.normal(size=(64,)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jit(jsam.generate_ood_hfs, static_argnums=(0, 2))(
        cfg, key, 64, jnp.asarray(center))
    got = tsam.generate_ood_hfs(cfg, None, 64, _t(center),
                                boxes=jax_boxes(cfg, key, 64,
                                                (-cfg.max_h, cfg.max_h),
                                                0.75))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), np.broadcast_to(
        center[:, None, None], got.shape))


def test_sample_batch_given_draws(libs):
    """The augmented batch against JAX's, given its draws, with chances
    raised so that every branch of the augmentation fires (maxpool passes
    of each kind and size, boxes, height shifts; the terrain's pinned
    cells have max = min); the same draws without the augmentation give the
    same windows and the plain terrain gather."""
    jmodel, jlib, tmodel, tlib = libs
    cfg = jsam.SamplerConfig(hf_maxpool_chance=0.7,
                             hf_change_height_chance=0.5)
    key = jax.random.PRNGKey(6)
    want = jit(lambda lib, k: jsam.sample_batch(
        jmodel, cfg, lib, k, 32))(jlib, key)
    draws = jax_batch_draws(cfg, jlib, key, 32)
    aug = draws.augment
    assert aug.shift_do.any() and aug.boxes.active.any()
    for s in (2, 4, 8):
        for kind in range(3):
            assert (aug.pool_do & (aug.pool_size >= s)
                    & (aug.pool_kind == kind)).any(), (s, kind)
    got = tsam.batch_from_draws(tmodel, cfg, tlib, draws)
    for f in tsam.WindowBatch.__dataclass_fields__:
        _close(getattr(got, f), getattr(want, f),
               1e-4 if f in ("frames", "prev_states") else 1e-5, f)
    draws.augment = None
    plain = tsam.batch_from_draws(tmodel, cfg, tlib, draws)
    for f in tsam.WindowBatch.__dataclass_fields__:
        if f != "hf":
            assert torch.equal(getattr(plain, f), getattr(got, f)), f
    hf, _ = tsam._gather_terrain(tlib, got.motion_ids, tsam._local_hf_points(
        SCFG, got.canon_xy, got.canon_heading))
    assert torch.equal(plain.hf, torch.clamp(
        hf - got.canon_z[:, None, None], -SCFG.max_h, SCFG.max_h))
    assert not torch.equal(plain.hf, got.hf)
    # and the port's own draws give a batch of the same form
    own = tsam.sample_batch(tmodel, SCFG, tlib,
                            torch.Generator().manual_seed(0), 8)
    assert own.frames.shape == (8, 15, 91) and own.hf.shape == (8, 31, 31)


def test_feature_stats(libs):
    jmodel, jlib, tmodel, tlib = libs
    jm, js = jsam.compute_feature_stats_exact(jmodel, SCFG, jlib, chunk=256)
    tm, ts = tsam.compute_feature_stats_exact(tmodel, SCFG, tlib)
    _close(tm, jm, 1e-5, "mean", rel=True)
    _close(ts, js, 1e-5, "std", rel=True)
    tm2, ts2 = tsam.compute_feature_stats_exact(tmodel, SCFG, tlib, chunk=37)
    _close(tm2, tm, 1e-5, "mean, chunked", rel=True)
    _close(ts2, ts, 1e-5, "std, chunked", rel=True)
    mm, ms = tsam.compute_feature_stats(tmodel, SCFG, tlib,
                                        torch.Generator().manual_seed(0), 64)
    assert mm.shape == ms.shape == (17, 91) and bool((ms >= 1e-3).all())
