"""parc_torch.opt.motion_opt against parc_tpu.opt.motion_opt on a standing
clip on flat ground (the tie case: a flat foot's contact points sit at one
height, so min/max split their gradient among them) and a walking clip
over random boxes.

Tolerances (f32):
- compute_approx_body_constraints: runs, bodies, radii, pins exact; the
  projected points within 1e-5 (300 gradient steps in each stack);
- each loss term within 1e-5 of the total loss; the gradient within 1e-5
  of its largest JAX magnitude;
- N Adam steps (5), single and batched: frames within 2 lr (Adam's
  normalized step turns rounding noise in a near-zero gradient into up to
  lr a step, tests/test_torch_mdm.py), final loss terms within 1e-4 of the
  total;
- the port's batched optimizer against its single-clip one: frames within
  2 lr, loss terms within 1e-4 of the total (the per-clip sums run in
  another order);
- run_augment (pipeline/augment.py), both terrain augmentations: what
  reaches the optimizer (the sliced, rotated and stretched frames, the
  padded or sliced and augmented terrain, the contacts) exact but for the
  exp-map columns rotated by f32 quaternion products in each stack (1e-6);
  the saved clips' terrains and contacts exact, frames within 2 lr.
The CLI stages that run the optimizer (optimize, augment, kin_gen) and
setup_iter raise without CUDA unless asked for the CPU.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.anim import motion_data as jmd
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.opt import motion_opt as jmo
from parc_tpu.pipeline import augment as jaug
from parc_tpu.utils import terrain as jter
from parc_torch.anim import motion_data as tmd
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.opt import motion_opt as tmo
from parc_torch.pipeline import augment as taug
from parc_torch.utils import terrain as tter
from test_torch_diffusion import _close, _t

torch.set_num_threads(1)

T = 16
ITERS = 5
LR = 1e-3


@pytest.fixture(scope="module")
def clips():
    """(JAX model, port model, {name: (frames, contacts, JAX terrain, port
    terrain)}): a standing clip on flat ground and a walking clip over
    boxes, each with a small perturbation so every term is active."""
    jmodel, tmodel = jspec().build(), tspec().build(device="cpu")
    out = {}
    rng = np.random.default_rng(0)
    for name, clip in (("stand", tsyn.standing_clip()),
                       ("walk", tsyn.walking_clip(seed=1))):
        f = clip.frames[:T].astype(np.float32)
        c = clip.contacts[:T].astype(np.float32)
        if name == "stand":
            hf = np.zeros((16, 16), np.float32)
        else:
            hf = tter.add_boxes(rng, np.zeros((24, 24), np.float32),
                                num_boxes=8, box_min_height=-0.2,
                                box_max_height=0.2, box_min_len=2,
                                box_max_len=6)
            f = f + rng.normal(size=f.shape).astype(np.float32) * 0.01
        mp = np.asarray([f[0, 0] - 4.0, f[0, 1] - 4.0], np.float32)
        dxdy = np.asarray([0.4, 0.4], np.float32)
        mm = np.stack([hf + 3, hf - 3], -1)
        jt = jter.Terrain(hf=jnp.asarray(hf), hf_mask=jnp.zeros(hf.shape,
                                                                bool),
                          hf_maxmin=jnp.asarray(mm),
                          min_point=jnp.asarray(mp), dxdy=jnp.asarray(dxdy))
        tt = tter.Terrain(hf=_t(hf), hf_mask=torch.zeros(hf.shape,
                                                         dtype=torch.bool),
                          hf_maxmin=_t(mm), min_point=_t(mp), dxdy=_t(dxdy))
        out[name] = (f, c, jt, tt)
    return jmodel, tmodel, out


def _bc_port(jbc):
    return tmo.BodyConstraints(**{
        f.name: _t(getattr(jbc, f.name)).to(
            torch.long if f.name in ("body_ids", "starts", "ends")
            else None) for f in dataclasses.fields(tmo.BodyConstraints)})


def test_body_constraints(clips):
    jmodel, tmodel, data = clips
    cfg = tmo.MotionOptConfig()
    for name, (f, c, jt, tt) in data.items():
        want = jmo.compute_approx_body_constraints(
            jmodel, jt, jnp.asarray(f), jnp.asarray(c), jmo.MotionOptConfig())
        got = tmo.compute_approx_body_constraints(tmodel, tt, f, c, cfg)
        assert got.num_valid == want.num_valid > 0, name
        for field in ("body_ids", "starts", "ends", "offsets", "radius",
                      "pin", "valid"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)),
                                          f"{name} {field}")
        _close(got.points, want.points, 1e-5, f"{name} projected points")


@pytest.mark.parametrize("name", ["stand", "walk"])
def test_loss_terms_and_gradient(clips, name):
    """Every term and the gradient, with the JAX constraints handed over;
    on the standing clip the contact and slide terms sit at their ties."""
    jmodel, tmodel, data = clips
    f, c, jt, tt = data[name]
    cfg, jcfg = tmo.MotionOptConfig(), jmo.MotionOptConfig()
    jbc = jmo.compute_approx_body_constraints(
        jmodel, jt, jnp.asarray(f), jnp.asarray(c), jcfg)
    x = f + np.random.default_rng(1).normal(size=f.shape).astype(
        np.float32) * 0.01
    # XLA's default level: at backend optimization level 0 XLA:CPU gives
    # this gradient NaNs (frame 11 of the walk), eagerly and at the
    # default level it is finite
    (jtot, jl), jg = jax.jit(jax.value_and_grad(
        lambda x, bc: jmo.motion_opt_loss(jmodel, jcfg, jt, x, f, c, bc),
        has_aux=True))(jnp.asarray(x), jbc)
    xt = _t(x).requires_grad_(True)
    ttot, tl = tmo.motion_opt_loss(tmodel, cfg, tt, xt, _t(f), _t(c),
                                   _bc_port(jbc))
    ttot.backward()
    assert tl.keys() == jl.keys()
    for k in jl:
        _close(tl[k].detach(), jl[k], 1e-5 * float(jtot), f"{name} {k}")
    assert float(jl["contact"]) > 0 and float(jl["body_constraint"]) >= 0
    _close(xt.grad, jg, 1e-5, f"{name} gradient", rel=True)


def test_adam_single(clips):
    """The walking clip (the standing one runs in test_adam_batched)."""
    jmodel, tmodel, data = clips
    cfg = tmo.MotionOptConfig(iters=ITERS, lr=LR)
    jcfg = jmo.MotionOptConfig(iters=ITERS, lr=LR)
    f, c, jt, tt = data["walk"]
    jx, jl = jmo.motion_contact_optimization(
        jmodel, jt, jnp.asarray(f), jnp.asarray(c), jcfg)
    # the constraints the optimizer would estimate itself
    bc = tmo.compute_approx_body_constraints(tmodel, tt, f, c, cfg)
    tx, tl = tmo.motion_contact_optimization(tmodel, tt, f, c, cfg, bc)
    before, _ = tmo.motion_opt_loss(tmodel, cfg, tt, _t(f), _t(f), _t(c),
                                    bc)
    assert np.isfinite(float(before)) and sum(tl.values()) < float(before)
    assert not np.allclose(tx.numpy(), f)
    _close(tx, jx, 2 * LR, "frames")
    big = sum(abs(v) for v in jl.values())
    for k in jl:
        assert abs(tl[k] - jl[k]) <= 1e-4 * big, k


def test_adam_batched(clips):
    """K = 2 clips of different lengths on their own terrains, padded to
    T + 6 frames: against JAX's batched optimizer, and against the port's
    single-clip one (the sum of K totals makes the joint step K steps)."""
    jmodel, tmodel, data = clips
    cfg = tmo.MotionOptConfig(iters=ITERS, lr=LR)
    jcfg = jmo.MotionOptConfig(iters=ITERS, lr=LR)
    (fs, cs, jts, tts) = zip(*data.values())
    fs = [fs[0][:T - 4], fs[1]]
    cs = [cs[0][:T - 4], cs[1]]
    want = jmo.motion_contact_optimization_batched(
        jmodel, list(jts), [jnp.asarray(x) for x in fs],
        [jnp.asarray(x) for x in cs], jcfg, pad_to=T + 6)
    got = tmo.motion_contact_optimization_batched(
        tmodel, list(tts), fs, cs, cfg, pad_to=T + 6)
    for i, ((gx, gl), (wx, wl)) in enumerate(zip(got, want)):
        assert gx.shape == (len(fs[i]), 34)
        _close(gx, wx, 2 * LR, f"clip {i} frames")
        big = sum(abs(v) for v in wl.values())
        for k in wl:
            assert abs(gl[k] - wl[k]) <= 1e-4 * big, (i, k)
        sx, sl = tmo.motion_contact_optimization(tmodel, tts[i], fs[i],
                                                 cs[i], cfg)
        _close(gx, sx, 2 * LR, f"clip {i} batched vs single")
        for k in sl:
            assert abs(gl[k] - sl[k]) <= 1e-4 * big, (i, k)


def test_static_motion_finite(clips):
    """A perfectly static clip (zero jerk, feet exactly on the ground) keeps
    a finite gradient and loss through every term."""
    _, tmodel, data = clips
    f, c, _, tt = data["stand"]
    x = np.repeat(f[:1], T, 0)
    xt = _t(x).requires_grad_(True)
    bc = tmo.compute_approx_body_constraints(tmodel, tt, x, c)
    total, _ = tmo.motion_opt_loss(tmodel, tmo.MotionOptConfig(), tt, xt,
                                   _t(x), _t(c), bc)
    total.backward()
    assert torch.isfinite(total) and torch.isfinite(xt.grad).all()


def test_run_augment(clips, tmp_path):
    """run_augment in both stacks from one seed on a walk over boxes and a
    stand without a terrain (augment makes a flat one), each longer than
    max_motion_len (a random slice). First with each optimizer replaced by
    one that records its inputs and returns the frames unchanged: four
    clips scaling the heights of the padded terrains, four stamping boxes
    along the path on the sliced terrains (each clip's draws follow the
    last one's). Then one clip through both optimizers."""
    jmodel, tmodel, _ = clips
    walk = tsyn.walking_clip(n=24, seed=1, terrain_dim=16)
    walk.terrain.hf[:] = tter.add_boxes(
        np.random.default_rng(2), np.zeros((16, 16), np.float32),
        num_boxes=4, box_min_height=-0.2, box_max_height=0.2,
        box_min_len=2, box_max_len=5)
    tmotions = [walk, dataclasses.replace(tsyn.standing_clip(n=24),
                                          terrain=None)]
    jmotions = [jmd.MotionData(
        frames=m.frames, fps=m.fps, contacts=m.contacts,
        terrain=None if m.terrain is None else jmd.HostTerrain(
            hf=m.terrain.hf, min_point=m.terrain.min_point,
            dxdy=m.terrain.dxdy)) for m in tmotions]
    names = ["walk.npz", "stand.npz"]

    def run_both(aug, seed, n, **extra):
        kw = dict(num_new_motions=n, max_motion_len=0.5, terrain_aug=aug,
                  **extra)
        out = []
        for side, lib, mo, model, motions in (
                ("jax", jaug, jmo, jmodel, jmotions),
                ("port", taug, tmo, tmodel, tmotions)):
            cfg = lib.AugmentConfig(**kw, opt_cfg=mo.MotionOptConfig(
                iters=ITERS, auto_body_constraints=False))
            out.append(lib.run_augment(
                model, motions, str(tmp_path / side / f"{aug}{n}"), cfg,
                names=names, seed=seed))
        want, got = out
        names_ = [os.path.basename(p) for p in got]
        assert names_ == [os.path.basename(p) for p in want], aug
        return names_, [(tmd.load_motion_data(g), jmd.load_motion_data(w))
                        for g, w in zip(got, want)]

    def same_clip(a, b, frames_tol, msg):
        _close(a.frames, b.frames, frames_tol, f"{msg} frames")
        np.testing.assert_array_equal(a.contacts, b.contacts, msg)
        for f in ("hf", "min_point", "dxdy"):
            np.testing.assert_array_equal(getattr(a.terrain, f),
                                          getattr(b.terrain, f), msg)

    seen = {"jax": [], "port": []}

    def record(side, as_out):
        def run(model, terrain, frames, contacts, cfg):
            seen[side].append([np.asarray(x) for x in (
                frames, contacts, terrain.hf, terrain.min_point,
                terrain.dxdy)])
            return as_out(frames), {}
        return run
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmo, "motion_contact_optimization",
                   record("jax", lambda x: x))
        mp.setattr(tmo, "motion_contact_optimization",
                   record("port", torch.as_tensor))
        for aug, seed, extra in (
                ("height_scale", 5, dict(terrain_padding=2)),
                ("boxes_along_path", 7, dict(slice_terrain=True))):
            saved, clips_ = run_both(aug, seed, 4, **extra)
            assert {n.split("_aug")[0] for n in saved} == {"walk", "stand"}
            assert len(seen["port"]) == len(seen["jax"]) == 4
            for i, (g, w) in enumerate(zip(seen["port"], seen["jax"])):
                msg = f"{aug} clip {i}"
                assert g[0].shape == (15, 34), msg
                np.testing.assert_array_equal(
                    np.delete(g[0], [3, 4, 5], 1),
                    np.delete(w[0], [3, 4, 5], 1), msg)
                _close(g[0][:, 3:6], w[0][:, 3:6], 1e-6, f"{msg} exp maps")
                for a, b in zip(g[1:], w[1:]):
                    np.testing.assert_array_equal(a, b, msg)
            for i, (a, b) in enumerate(clips_):
                same_clip(a, b, 1e-6, f"{aug} saved clip {i}")
            seen["port"].clear()
            seen["jax"].clear()
    saved, [(a, b)] = run_both("boxes_along_path", 8, 1, slice_terrain=True)
    assert saved == ["walk_aug001.npz"]
    same_clip(a, b, 2 * LR, "optimized walk")


def test_cli_stages_need_cuda_unless_cpu(tmp_path):
    """Without a card, the stages that optimize (optimize, augment, kin_gen)
    and setup_iter raise unless the caller asks for the CPU: there is no
    silent fallback."""
    from parc_torch.pipeline import cli
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for argv in (["optimize", "--motions_dir", str(tmp_path)],
                 ["augment", "--motions_dir", str(tmp_path)],
                 ["kin_gen", "--dataset", str(tmp_path / "none.yaml")],
                 ["setup_iter", "--root", str(tmp_path)]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv + ["--out_dir", str(tmp_path / "out")])
    assert not (tmp_path / "iter_0").exists()
