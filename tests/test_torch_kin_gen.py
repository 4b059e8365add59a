"""parc_torch's kin-gen slice (procgen/mdm_path, anim/motion_edit's flips
and hesitation removal, the reference .pkl loaders, pipeline/kin_gen and
the CLI's kin_gen -> optimize -> augment chain) against parc_tpu at the tiny
MDM of tests/test_pipeline.py (11 diffusion steps, d_model 32, one layer),
from one JAX state carried over by parc_torch.convert. The numpy draws
(terrains, endpoints, the planner's seed) are the same in both stacks; the
JAX draws (the cold start's root height and each window's DDIM noise) are
rebuilt from the JAX package's key chain and handed to the port.

Tolerances (f32):
- generated frames: 1e-4 absolute (XLA fuses the slerp of the window
  features, tests/test_torch_diffusion.py); contacts equal;
- rollout scores: 1e-5 of the largest score; rollout lengths equal;
- run_kin_gen's saved clips: frames, contacts and hf_maxmin within 2 lr of
  the optimizer (2e-3: Adam's normalized step turns rounding noise in a
  near-zero gradient into up to lr a step, tests/test_torch_mdm.py) after
  5 Adam iterations, losses within 1e-5 of the largest, hf_mask, the
  heightfields, the kept rollouts and the mirrors equal;
- flips, hesitation removal and the .pkl loaders: exact.
"""

import dataclasses
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from parc_tpu.anim import motion_data as jmd
from parc_tpu.anim import motion_edit as jme
from parc_tpu.diffusion.mdm import MDM as JMDM
from parc_tpu.diffusion.mdm import MDMConfig as JCfg
from parc_tpu.diffusion.mdm import MDMState as JState
from parc_tpu.opt import motion_opt as jmo
from parc_tpu.pipeline import kin_gen as jkg
from parc_tpu.procgen import mdm_path as jmp
from parc_torch import convert
from parc_torch.anim import motion_data as tmd
from parc_torch.anim import motion_edit as tme
from parc_torch.data import synthetic as tsyn
from parc_torch.diffusion import sampler as tsam
from parc_torch.diffusion.mdm import MDM as TMDM
from parc_torch.diffusion.mdm import MDMConfig as TCfg
from parc_torch.opt import motion_opt as tmo
from parc_torch.pipeline import cli
from parc_torch.pipeline import kin_gen as tkg
from parc_torch.procgen import mdm_path as tmp
from test_torch_diffusion import SCFG, _close, _np, _t, build_libs, jit

torch.set_num_threads(1)

CFG = dict(diffusion_timesteps=11, d_model=32, num_heads=2, d_hid=32,
           num_layers=1, dropout=0.0)
B = 2
PATH = tmp.PathGenSettings(batch_size=B, max_seconds=1.0)


@pytest.fixture(scope="module")
def setup():
    """Both MDMs from one fresh JAX state (the port's exact feature
    stats), a function making the port's state, and two terrains with
    paths across them."""
    jmodel, jlib, tmodel, tlib = build_libs()
    jmdm = JMDM(jmodel, JCfg(**CFG))
    tmdm = TMDM(tmodel, TCfg(**CFG), device="cpu")
    params = jit(jmdm.net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 15, 91)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 2, 91)),
        jnp.zeros((1, 31, 31)), jnp.zeros((1, 2)))
    mean, std = tsam.compute_feature_stats_exact(tmodel, SCFG, tlib)
    s0 = JState(params=params, ema_params=params,
                opt_state=jmdm.tx.init(params), mean=jnp.asarray(mean),
                std=jnp.asarray(std), rng=jax.random.PRNGKey(1),
                step=jnp.zeros((), jnp.int32))
    ts = tmdm.init(tlib, torch.Generator().manual_seed(0), stats_samples=8)
    ts = tmdm.merge_persistent(ts, convert.mdm_state_from_numpy(_np(s0)))
    # two of kin-gen's own 20 x 20 box terrains with their A* paths: the
    # sampler then compiles (in JAX) at the shapes run_kin_gen uses below
    draws = [tkg._draw_terrain_and_path(_kin_cfg(tkg, tmp, tmo, False),
                                        np.random.default_rng(seed), "cpu")
             for seed in (11, 17)]
    hfs = [d[1] for d in draws]
    paths = [d[2] for d in draws]
    return dict(jmodel=jmodel, tmodel=tmodel, jmdm=jmdm, tmdm=tmdm, s0=s0,
                ts=ts, hfs=hfs, paths=paths)


def _terrains(hf, min_point=(0.0, 0.0)):
    host = tmd.HostTerrain(hf=hf, min_point=np.asarray(min_point, np.float32),
                           dxdy=np.asarray([0.4, 0.4], np.float32))
    j = jmd.HostTerrain(hf=hf, min_point=host.min_point, dxdy=host.dxdy)
    return j.to_device(), host.to_device("cpu")


def jax_draws(key, root_shape, noise_shape, windows):
    """The draws generate_frames_along_path / _multi make from ``key``:
    on a cold start ``rng, k_z = split(key)`` (none on a warm start,
    ``root_shape`` None), then ``rng, k = split(rng)`` per window."""
    rng, root = key, None
    if root_shape is not None:
        rng, k_z = jax.random.split(key)
        root = _t(jax.random.uniform(k_z, root_shape))
    noise = []
    for _ in range(windows):
        rng, k = jax.random.split(rng)
        noise.append(_t(jax.random.normal(k, noise_shape)))
    return tmp.PathDraws(root_u=root, noise=noise)


def _same_result(got, want, msg):
    np.testing.assert_array_equal(got.lengths, want.lengths, msg)
    _close(got.frames34, want.frames34, 1e-4, f"{msg} frames")
    np.testing.assert_array_equal(got.contacts, want.contacts, msg)
    scores = np.stack([want.contact_loss, want.pen_loss])
    for name in ("contact_loss", "pen_loss", "total_loss"):
        _close(getattr(got, name), getattr(want, name),
               1e-5 * max(float(np.abs(scores).max()), 1e-6), name)


@pytest.mark.parametrize("warm", [False, True])
def test_generate_frames_along_path(setup, warm):
    jmdm, tmdm, s0, ts = (setup[k] for k in ("jmdm", "tmdm", "s0", "ts"))
    jt, tt = _terrains(setup["hfs"][1])
    nodes = setup["paths"][1]
    start_f = start_c = None
    if warm:
        clip = tsyn.walking_clip(seed=2)
        start_f = clip.frames[:2].astype(np.float32)
        start_f[:, 0:2] += nodes[0, 0:2] - start_f[-1, 0:2]
        start_c = clip.contacts[:2].astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jmp.generate_frames_along_path(jmdm, s0, jt, nodes, start_f,
                                          start_c, key, PATH)
    draws = jax_draws(key, None if warm else (), (B, 15, 91),
                      tmp.max_windows(tmdm, PATH))
    tmdm.denoise_calls = 0
    got = tmp.generate_frames_along_path(tmdm, ts, tt, nodes, start_f,
                                         start_c, None, PATH, draws=draws)
    # 3 windows (2 + 14, 11 + 15 and 21 + 15 frames warm; 14, 9 + 15 and
    # 19 + 15 cold) of 3 DDIM steps each (11 steps, stride 5)
    assert tmdm.denoise_calls == 3 * 3
    assert got.frames34.shape == want.frames34.shape
    _same_result(got, want, f"warm={warm}")


def test_generate_frames_multi(setup):
    jmdm, tmdm, s0, ts = (setup[k] for k in ("jmdm", "tmdm", "s0", "ts"))
    pairs = [_terrains(hf) for hf in setup["hfs"]]
    key = jax.random.PRNGKey(7)
    want = jmp.generate_frames_multi(jmdm, s0, [p[0] for p in pairs],
                                     setup["paths"], key, PATH)
    draws = jax_draws(key, (2,), (2 * B, 15, 91),
                      tmp.max_windows(tmdm, PATH))
    got = tmp.generate_frames_multi(tmdm, ts, [p[1] for p in pairs],
                                    setup["paths"], None, PATH, draws=draws)
    assert len(got) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        _same_result(g, w, f"terrain {i}")


def test_score_flips_hesitation(setup):
    """score_rollouts on random frames with random contacts, the two
    flips, and remove_hesitation_frames on a clip with a long pause."""
    jmdm, tmdm = setup["jmdm"], setup["tmdm"]
    rng = np.random.default_rng(4)
    hf = rng.uniform(-0.3, 0.3, (16, 16)).astype(np.float32)
    jt, tt = _terrains(hf, (-3.0, -3.0))
    clip = tsyn.walking_clip(seed=3)
    frames = np.stack([clip.frames[:20], clip.frames[5:25]]).astype(
        np.float32)
    contacts = (rng.random((2, 20, 15)) < 0.5).astype(np.float32)
    jc, jp = jit(lambda t, f, c: jmp.score_rollouts(jmdm, t, f, c))(
        jt, frames, contacts)
    tc, tp = tmp.score_rollouts(tmdm, tt, _t(frames), _t(contacts))
    _close(tc, jc, 1e-5, "contact score", rel=True)
    _close(tp, jp, 1e-5, "pen score", rel=True)

    fm, cm_ = tme.flip_motion_about_xz(setup["tmodel"], _t(frames[0]),
                                       _t(contacts[0]))
    jfm, jcm = jme.flip_motion_about_xz(setup["jmodel"], frames[0],
                                        contacts[0])
    _close(fm, jfm, 1e-6, "flipped frames")
    np.testing.assert_array_equal(cm_.numpy(), np.asarray(jcm))
    host = tmd.HostTerrain(hf=hf, min_point=np.asarray([-3.0, -2.0]),
                           dxdy=np.asarray([0.4, 0.4]), hf_mask=hf > 0,
                           hf_maxmin=np.stack([hf + 1, hf - 1], -1))
    jhost = jmd.HostTerrain(**dataclasses.asdict(host))
    for f in ("hf", "min_point", "dxdy", "hf_mask", "hf_maxmin"):
        np.testing.assert_array_equal(
            getattr(tme.flip_terrain_about_xz(host), f),
            getattr(jme.flip_terrain_about_xz(jhost), f))

    paused = np.concatenate([clip.frames[:10]] + [clip.frames[10:11]] * 25
                            + [clip.frames[11:30]]).astype(np.float32)
    pc = rng.random((len(paused), 15)).astype(np.float32)
    got = tme.remove_hesitation_frames(paused, pc)
    want = jme.remove_hesitation_frames(paused, pc)
    assert len(got[0]) < len(paused)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


class _RefTerrain:
    """A stand-in for the reference's SubTerrain class in a pickle."""


_RefTerrain.__module__ = "util.terrain_util"
_RefTerrain.__qualname__ = _RefTerrain.__name__ = "SubTerrain"


def test_reference_pkl_loaders(tmp_path, monkeypatch):
    """A reference-format terrain .pkl and motion .pkl (foreign classes
    and torch tensors inside) load as the JAX package loads them, and
    kin-gen's terrain_style file slices the same windows from them."""
    import sys
    import types
    mod = types.ModuleType("util.terrain_util")
    mod.SubTerrain = _RefTerrain
    monkeypatch.setitem(sys.modules, "util", types.ModuleType("util"))
    monkeypatch.setitem(sys.modules, "util.terrain_util", mod)
    rng = np.random.default_rng(5)
    t = _RefTerrain()
    t.hf = torch.as_tensor(rng.uniform(0, 1, (40, 36)).astype(np.float32))
    t.min_point = torch.tensor([1.0, -2.0])
    t.dxdy = torch.tensor([0.4, 0.4])
    t.hf_mask = None
    t.hf_maxmin = None
    with open(tmp_path / "terrain.pkl", "wb") as f:
        pickle.dump(t, f)
    clip = tsyn.walking_clip(seed=4)
    with open(tmp_path / "motion.pkl", "wb") as f:
        pickle.dump({"frames": torch.as_tensor(clip.frames),
                     "contacts": torch.as_tensor(clip.contacts),
                     "fps": 30, "terrain": t, "loss": torch.tensor(1.5)}, f)
    monkeypatch.delitem(sys.modules, "util.terrain_util")
    monkeypatch.delitem(sys.modules, "util")

    for name in ("terrain.pkl", "motion.pkl"):
        got = tmd.load_reference_terrain_pkl(str(tmp_path / name))
        want = jmd.load_reference_terrain_pkl(str(tmp_path / name))
        for f in ("hf", "min_point", "dxdy"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    got = tmd.load_motion_data(str(tmp_path / "motion.pkl"))
    want = jmd.load_motion_data(str(tmp_path / "motion.pkl"))
    np.testing.assert_array_equal(got.frames, want.frames)
    np.testing.assert_array_equal(got.contacts, want.contacts)
    np.testing.assert_array_equal(got.terrain.hf, want.terrain.hf)
    assert got.losses == want.losses == {"total": 1.5}

    files = (str(tmp_path / "terrain.pkl"), str(tmp_path / "motion.pkl"))
    tcfg = tkg.KinGenConfig(terrain_style="file", terrain_files=files)
    jcfg = jkg.KinGenConfig(terrain_style="file", terrain_files=files)
    r1, r2 = np.random.default_rng(6), np.random.default_rng(6)
    for _ in range(3):
        np.testing.assert_array_equal(tkg.gen_terrain(tcfg, r1),
                                      jkg.gen_terrain(jcfg, r2))


def _kin_cfg(kin_gen, mdm_path, motion_opt, batched: bool):
    """The kin-gen config of these tests, from either stack's modules."""
    path = mdm_path.PathGenSettings(batch_size=B, max_seconds=1.0)
    return kin_gen.KinGenConfig(
        num_rollouts=B, top_k=1, max_retries=2, mirror=True,
        terrains_per_batch=2 if batched else 1, terrain_dim=10,
        max_contact_loss=1e9, max_pen_loss=1e9, max_total_loss=1e9,
        opt_cfg=motion_opt.MotionOptConfig(iters=5), path_cfg=path)


@pytest.mark.parametrize("batched", [False, True])
def test_run_kin_gen(setup, tmp_path, batched):
    """The slice as a whole: run_kin_gen in both stacks from one seed, the
    port given the JAX key chain's draws, compared on the saved clips. The
    first A* of the slot seeded 12 finds no path, so its retry runs in
    both modes (sequential: slot 0 rolls out on its second terrain;
    batched: slot 1 draws again before the round)."""
    jmdm, tmdm, s0, ts = (setup[k] for k in ("jmdm", "tmdm", "s0", "ts"))
    seed, n = (11, 2) if batched else (12, 1)
    jcfg = _kin_cfg(jkg, jmp, jmo, batched)
    tcfg = _kin_cfg(tkg, tmp, tmo, batched)
    want = jkg.run_kin_gen(jmdm, s0, n, str(tmp_path / "jax"), jcfg,
                           seed=seed)
    windows = tmp.max_windows(tmdm, tcfg.path_cfg)

    def draws(stream, call, root_shape, noise_shape):
        rng = jax.random.PRNGKey(stream)
        for _ in range(call + 1):
            rng, key = jax.random.split(rng)
        return jax_draws(key, root_shape, noise_shape, windows)

    got = tkg.run_kin_gen(tmdm, ts, n, str(tmp_path / "port"), tcfg,
                          seed=seed, path_draws=draws)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert len(got) == 2 * n                # top-1 and its mirror, per slot
    for g, w in zip(got, want):
        a, b = tmd.load_motion_data(g), jmd.load_motion_data(w)
        assert a.frames.shape == b.frames.shape
        _close(a.frames, b.frames, 2e-3, f"{g} frames")
        np.testing.assert_array_equal(a.contacts, b.contacts)
        np.testing.assert_array_equal(a.terrain.hf, b.terrain.hf)
        np.testing.assert_array_equal(a.terrain.hf_mask, b.terrain.hf_mask)
        _close(a.terrain.hf_maxmin, b.terrain.hf_maxmin, 2e-3,
               f"{g} hf_maxmin")
        assert a.losses.keys() == b.losses.keys()
        big = max(abs(v) for v in b.losses.values())
        for k in b.losses:
            assert abs(a.losses[k] - b.losses[k]) <= 1e-5 * big, k


def test_cli_chain(setup, tmp_path):
    """setup_iter -> kin_gen -> optimize -> augment -> create_dataset on
    --device cpu, from an MDM checkpoint written by the port; every clip
    the dataset lists reloads equal to what its stage saved."""
    from parc_torch.pipeline import dataset
    from parc_torch.utils import checkpoint as ckpt_lib
    tmdm, ts = setup["tmdm"], setup["ts"]
    configs = cli.main(["setup_iter", "--root", str(tmp_path / "parc"),
                        "--iter", "0", "-n", "1", "--device", "cpu"])
    with open(configs["kin_gen"]) as f:
        kcfg = yaml.safe_load(f)
    assert kcfg["device"] == "cpu"
    for i, clip in enumerate([tsyn.walking_clip(seed=0),
                              tsyn.standing_clip()]):
        tmd.save_motion_data(str(tmp_path / "clips" / "walk" / f"c{i}.npz"),
                             clip)
    small = tmp_path / "small.yaml"
    small.write_text(yaml.safe_dump({
        **CFG, "num_rollouts": B, "top_k": 1, "terrain_dim": 10,
        "max_contact_loss": float("inf"), "max_pen_loss": float("inf"),
        "max_total_loss": float("inf"), "iters": 5, "opt_cfg": {"iters": 5},
        "path_cfg": {"batch_size": B, "max_seconds": 1.0}}))
    common = ["--device", "cpu", "--config", str(small)]
    cli.main(["create_dataset", "--motions_dir", str(tmp_path / "clips"),
              "--out", kcfg["dataset"]] + common)
    ckpt_lib.save(os.path.join(kcfg["mdm_dir"], "checkpoints"), 1,
                  tmdm.persistent_state(ts))
    saved = {}
    gen = tmp_path / "gen"
    kin = cli.main(["kin_gen", "--dataset", kcfg["dataset"], "--mdm_dir",
                    kcfg["mdm_dir"], "--out_dir", str(gen / "kin"), "-n",
                    "1"] + common)
    opt = cli.main(["optimize", "--motions_dir", str(gen / "kin"),
                    "--out_dir", str(gen / "opt")] + common)
    aug = cli.main(["augment", "--motions_dir", str(gen / "kin"),
                    "--out_dir", str(gen / "aug"), "-n", "2"] + common)
    assert (len(kin), len(opt), len(aug)) == (2, 2, 2)
    for p in list(kin) + list(opt) + list(aug):
        clip = tmd.load_motion_data(p)
        assert np.all(np.isfinite(clip.frames)) and clip.terrain is not None
        saved[os.path.abspath(p)] = clip.frames
    cli.main(["create_dataset", "--motions_dir", str(gen), "--out",
              str(tmp_path / "gen.yaml")] + common)
    files = dataset.dataset_meta(str(tmp_path / "gen.yaml"))["files"]
    assert sorted(os.path.abspath(f) for f in files) == sorted(saved)
    for f in files:
        np.testing.assert_array_equal(tmd.load_motion_data(f).frames,
                                      saved[os.path.abspath(f)])
