"""The tracker on clips over kin-gen's box terrains, in parc_torch against
parc_tpu on the CPU: the PARC loop's hand-off from kinematic generation to
tracking (the dataset manifest, the per-env terrain slots of the motion
library, the env's control step, the record stage, the iteration configs
and the eval stage's diagnostics).

The terrains come from one numpy seed through each package's
``utils.terrain.add_boxes`` (bit for bit, as
tests/test_torch_terrain_procgen.py holds) at kin-gen's box count and
lengths, with heights a walk can step onto; synthetic walks ride the box
tops, so feet meet box tops and walls. The stand keeps its smaller flat
terrain, so the stack is edge-padded and each env reads its own slot.

Tolerances: the manifest's weights 1e-7, the stacked terrains and masks
equal (tests/test_torch_pipeline.py); each control step from the same
carried-across state: sim state 2e-4 and contact forces 2e-3 N + rtol 1e-5
(tests/test_pallas.py:190-193, tests/test_torch_engine.py), obs 2e-4,
reward 1e-5, done equal (tests/test_torch_envs.py); recorded frames 2e-4,
contacts and terrain equal (tests/test_torch_trainer.py); the iteration
configs equal but for the port's ``device`` key; the diagnostics report's
names and integers equal, its floats within 1e-5 relative.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.envs import base as jbase
from parc_tpu.envs import deepmimic as jdm
from parc_tpu.learning import diagnostics as jdiag
from parc_tpu.physics import engine as je
from parc_tpu.pipeline import cli as jcli
from parc_tpu.pipeline import dataset as jds
from parc_tpu.pipeline import record as jrec
from parc_tpu.utils import terrain as jter
from parc_torch import convert
from parc_torch.anim import motion_data as tmd
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.envs import base as tbase
from parc_torch.envs import deepmimic as tdm
from parc_torch.learning import diagnostics as tdiag
from parc_torch.physics import engine as te
from parc_torch.pipeline import cli
from parc_torch.pipeline import dataset as tds
from parc_torch.pipeline import record as trec
from parc_torch.utils import terrain as tter

from test_torch_diffusion import jax_jit_opt0, jit  # noqa: F401
from test_torch_trainer import _jax_lib, _np, _stacks

torch.set_num_threads(1)

N, K, STEPS, DX, DIM = 8, 2, 4, 0.4, 32
STATE = ("root_pos", "root_rot", "joint_rot", "dof_vel", "body_pos",
         "body_rot", "body_vel", "body_ang_vel")
FEET = (11, 14)  # right_foot, left_foot
FRAMES = 30  # every clip's length: the JAX side compiles its mask ops once
# (clip, start time): the walks along their boxes, the stand on its flat
# slot
ROWS = (("gen/walk_a", 0.0), ("gen/walk_a", 0.4), ("gen/walk_a", 0.8),
        ("gen/walk_b", 0.0), ("gen/walk_b", 0.3), ("gen/walk_b", 0.6),
        ("gen/walk_b", 0.9), ("bench/stand", 0.3))


def _boxes(seed):
    """A kin-gen terrain (kin_gen.gen_terrain's 16 boxes of 2-8 cells on a
    32 x 32 grid), heights 0.1-0.4 m; both packages' add_boxes give it."""
    kw = dict(num_boxes=16, box_min_height=0.1, box_max_height=0.4,
              box_min_len=2, box_max_len=8)
    hf = np.zeros((DIM, DIM), np.float32)
    got = tter.add_boxes(np.random.default_rng(seed), hf, **kw)
    np.testing.assert_array_equal(
        got, jter.add_boxes(np.random.default_rng(seed), hf, **kw))
    return got


def _walk_over(hf, seed):
    """A synthetic walk along +x from the first grid point whose 3 x 3
    neighbours share one raised height (a box top), its root riding the
    height of the grid point under it, 3 cm low: the feet press on what
    they stand on."""
    clip = tsyn.walking_clip(n=FRAMES, seed=seed, terrain_dim=DIM)
    tops = [(i, j) for i in range(4, DIM - 12) for j in range(4, DIM - 4)
            if hf[i, j] > 0 and (hf[i - 1:i + 2, j - 1:j + 2] == hf[i, j]).all()]
    i, j = tops[0]
    lo = clip.terrain.min_point
    f = clip.frames
    f[:, 0] += lo[0] + i * DX
    f[:, 1] = lo[1] + j * DX
    cells = np.clip(np.rint((f[:, 0] - lo[0]) / DX).astype(int), 0, DIM - 1)
    f[:, 2] += hf[cells, j] - 0.03
    clip.terrain.hf = hf
    return clip


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same motions directory written for each package (two walks over
    box terrains and a kin-gen clip whose losses the default thresholds
    drop, under gen/; the stand under bench/), and create_dataset_yaml's
    manifest of each: {side: manifest path}."""
    clips = {"gen/walk_a": _walk_over(_boxes(1), 1),
             "gen/walk_b": _walk_over(_boxes(2), 2),
             "gen/dropped": _walk_over(_boxes(3), 3),
             "bench/stand": tsyn.standing_clip(n=FRAMES)}
    clips["gen/dropped"].losses = {"contact": 5.0, "pen": 1.0, "total": 6.0}
    root = tmp_path_factory.mktemp("gen_tracking")
    out = {}
    for side, create in (("jax", jds.create_dataset_yaml),
                         ("torch", tds.create_dataset_yaml)):
        for name, clip in clips.items():
            tmd.save_motion_data(str(root / side / f"{name}.npz"), clip)
        kw = {} if side == "jax" else dict(device="cpu")
        out[side] = create(str(root / side), str(root / f"{side}.yaml"), **kw)
    return out


def _entries(path):
    with open(path) as f:
        return yaml.safe_load(f)["motions"]


def test_dataset_and_terrain_stack(datasets):
    """create_dataset_yaml's files, classes and weights; the clips' masks;
    the loaded libraries' edge-padded terrain stack, one slot a clip."""
    w_entries, g_entries = (_entries(datasets[s]) for s in ("jax", "torch"))

    def rel(entries, side):
        return [os.path.relpath(e["file"], os.path.join(
            os.path.dirname(datasets[side]), side)) for e in entries]
    assert rel(g_entries, "torch") == rel(w_entries, "jax") == [
        "bench/stand.npz", "gen/walk_a.npz", "gen/walk_b.npz"]
    assert [e["class"] for e in g_entries] == [e["class"] for e in w_entries]
    np.testing.assert_allclose([e["weight"] for e in g_entries],
                               [e["weight"] for e in w_entries], atol=1e-7)
    for g, w in zip(g_entries, w_entries):
        gc, wc = (tmd.load_motion_data(e["file"]) for e in (g, w))
        np.testing.assert_array_equal(gc.terrain.hf_mask, wc.terrain.hf_mask)
        np.testing.assert_array_equal(gc.terrain.hf_maxmin,
                                      wc.terrain.hf_maxmin)
        assert len(gc.hf_mask_inds) == len(wc.hf_mask_inds)
        for a, b in zip(gc.hf_mask_inds, wc.hf_mask_inds):
            np.testing.assert_array_equal(a, b)

    tlib = tds.load_dataset(tspec().build(device="cpu"), datasets["torch"],
                            device="cpu")
    jlib = jds.load_dataset(jspec().build(), datasets["jax"])
    assert tlib.terrain_hf.shape == (3, DIM, DIM)
    for f in ("terrain_hf", "terrain_maxmin", "terrain_min_point",
              "terrain_dxdy", "weights", "lengths"):
        np.testing.assert_array_equal(getattr(tlib, f).numpy(),
                                      np.asarray(getattr(jlib, f)), f)
    # each clip's own terrain in its slot; the stand's 24 x 24 edge-padded
    for k, e in enumerate(g_entries):
        hf = tmd.load_motion_data(e["file"]).terrain.hf
        h, w = hf.shape
        np.testing.assert_array_equal(tlib.terrain_hf[k, :h, :w].numpy(), hf)
    assert (tlib.terrain_hf[1:].amax((1, 2)) > 0.1).all()


def _jnp(x):
    x = x.numpy()
    return jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)


def _jax_sim(sim):
    return je.SimState(**{k: _jnp(v) for k, v in vars(sim).items()})


@pytest.fixture(scope="module")
def steps(datasets):
    """STEPS control steps of both envs over the dataset, each from the same
    state: [(JAX state before, JAX state after, port state after)]. The
    port's demo-mode reset puts the ROWS at their clips' times, and its
    reset pool serves the done envs; both are carried into JAX, so JAX
    compiles the step alone."""
    jm, tm = jspec().build(), tspec().build(device="cpu")
    tlib = tds.load_dataset(tm, datasets["torch"], device="cpu")
    jlib = _jax_lib(tlib)
    meta = tds.dataset_meta(datasets["torch"])
    keys = [f"{c}/{n}" for c, n in zip(meta["classes"], meta["names"])]
    ids = torch.tensor([keys.index(k) for k, _ in ROWS])
    cfg = dict(num_envs=N)
    jenv = jdm.DeepMimicEnv(jm, je.SimParams(), jbase.EnvConfig(**cfg))
    tenv = tdm.DeepMimicEnv(tm, te.SimParams(), tbase.EnvConfig(**cfg),
                            device="cpu")
    ts = tenv.reset(tlib, torch.Generator().manual_seed(0), motion_ids=ids,
                    start_times=torch.tensor([t for _, t in ROWS]))
    tpool = tenv.build_reset_pool(tlib, torch.Generator().manual_seed(1),
                                  ts.fail_rates, N, k=K)
    jpool = jdm.ResetPool(sim=_jax_sim(tpool.sim),
                          motion_ids=_jnp(tpool.motion_ids),
                          times=_jnp(tpool.times), obs=_jnp(tpool.obs), k=K)
    js = jbase.EnvState(sim=_jax_sim(ts.sim), rng=jax.random.PRNGKey(0),
                        **{k: _jnp(v) for k, v in vars(ts).items()
                           if k != "sim"})
    jstep = jit(lambda l, s, a, p, k: jenv.step(l, s, a, reset_pool=p,
                                                pool_slot=k))
    rng = np.random.default_rng(4)
    out = []
    for i in range(STEPS):
        act = rng.normal(0, 0.2, (N, 28)).astype(np.float32)
        slot = np.full((N,), i % K, np.int32)
        ts = convert.env_state_from_numpy(_np(js))
        j2 = jstep(jlib, js, jnp.asarray(act), jpool, jnp.asarray(slot))
        t2 = tenv.step(tlib, ts, torch.as_tensor(act), reset_pool=tpool,
                       pool_slot=torch.as_tensor(slot).long())
        out.append((js, j2, t2))
        js = j2
    return dict(out=out, tlib=tlib, ids=ids.numpy())


def _on_boxes(s, lib, ids):
    """Envs whose feet press on a raised cell (a box top or wall): contact
    force on the foot with the grid point under it above 5 cm."""
    hf = lib.terrain_hf[torch.as_tensor(ids).long()]
    uv = torch.round((s.sim.body_pos[:, FEET, :2]
                      - lib.terrain_min_point[torch.as_tensor(ids).long()]
                      [:, None]) / lib.terrain_dxdy).long().clamp(0, DIM - 1)
    under = hf[torch.arange(N)[:, None], uv[..., 0], uv[..., 1]]
    force = torch.linalg.vector_norm(s.sim.contact_forces[:, FEET], dim=-1)
    return ((under > 0.05) & (force > 0)).any(1)


@pytest.mark.parametrize("step", range(STEPS))
def test_control_step_on_boxes(steps, step):
    """One control step of the deepmimic env on the box terrains' slots,
    from the same state in both packages."""
    js, j2, t2 = steps["out"][step]
    if step == 0:  # the rows do what they are for
        assert _on_boxes(t2, steps["tlib"], steps["ids"]).sum() >= 2
        assert len(set(steps["ids"].tolist())) == 3
    for f in STATE:
        np.testing.assert_allclose(getattr(t2.sim, f).numpy(),
                                   np.asarray(getattr(j2.sim, f)), rtol=0,
                                   atol=2e-4, err_msg=f)
    np.testing.assert_allclose(t2.sim.contact_forces.numpy(),
                               np.asarray(j2.sim.contact_forces), rtol=1e-5,
                               atol=2e-3, err_msg="contact_forces")
    np.testing.assert_allclose(t2.obs.numpy(), np.asarray(j2.obs), rtol=0,
                               atol=2e-4, err_msg="obs")
    np.testing.assert_allclose(t2.reward.numpy(), np.asarray(j2.reward),
                               rtol=0, atol=1e-5, err_msg="reward")
    np.testing.assert_array_equal(t2.done.numpy(), np.asarray(j2.done))
    np.testing.assert_array_equal(t2.motion_ids.numpy(),
                                  np.asarray(j2.motion_ids))


def test_record_on_boxes(datasets, jax_jit_opt0):  # noqa: F811
    """record_motions from the same flax weights on the two box walks, 8
    steps at most: from the start neither plays through, from 80 % of
    their length both do, in both packages; each recorded clip carries its
    source clip's terrain."""
    clips = [tmd.load_motion_data(e["file"])
             for e in _entries(datasets["torch"])[1:]]
    jagent, jlib, jstate, tagent, tlib, tstate = _stacks(
        clips, dict(num_envs=2, rand_reset=False))
    kw = dict(max_steps=8, start_fractions=(0.0, 0.8))
    want = jrec.record_motions(jagent, jlib, jstate, jrec.RecordConfig(**kw))
    got = trec.record_motions(tagent, tlib, tstate, trec.RecordConfig(**kw))
    assert [g is None for g in got] == [w is None for w in want] \
        == [False, False]
    for g, w, clip in zip(got, want, clips):
        assert g.frames.shape == w.frames.shape and g.frames.shape[1] == 34
        np.testing.assert_allclose(g.frames, w.frames, atol=2e-4)
        np.testing.assert_array_equal(g.contacts, w.contacts)
        np.testing.assert_array_equal(g.terrain.hf, w.terrain.hf)
        np.testing.assert_array_equal(g.terrain.hf, clip.terrain.hf)


def test_setup_iter_configs(tmp_path):
    """The five stage configs of two iterations: the same keys and paths
    (relative to the root); the port's also name the device."""
    for it in ("0", "1"):
        jcli.main(["setup_iter", "--root", str(tmp_path / "jax"), "--iter",
                   it])
        written = cli.main(["setup_iter", "--root", str(tmp_path / "torch"),
                            "--iter", it, "--device", "cpu"])
        assert sorted(written) == sorted(
            ["train_mdm", "kin_gen", "train_tracker", "record",
             "create_dataset"])
        for name, path in written.items():
            with open(path) as f:
                got = yaml.safe_load(f)
            with open(tmp_path / "jax" / f"iter_{it}" / f"{name}.yaml") as f:
                want = yaml.safe_load(f)
            assert got.pop("device") == "cpu"
            rel = {k: (os.path.relpath(v, tmp_path / "torch")
                       if isinstance(v, str) else v) for k, v in got.items()}
            assert rel == {k: (os.path.relpath(v, tmp_path / "jax")
                               if isinstance(v, str) else v)
                           for k, v in want.items()}, name
    assert want["motions_dir"].endswith(os.path.join("iter_1", "recorded"))


def test_diagnostics_report(steps):
    """eval --diagnostics' report from flax parameters carried across with
    convert.actor_critic_from_flax, on the box-terrain rows' obs: every
    weight and activation row under the JAX package's name and values."""
    jagent, _, jstate, tagent, _, tstate = _stacks(
        [tsyn.standing_clip()], dict(num_envs=N))
    tagent.net = convert.actor_critic_from_flax(_np(jstate.params))
    obs = steps["out"][0][2].obs.numpy()
    want = jdiag.full_report(jagent, jstate, jnp.asarray(obs))
    got = tdiag.full_report(tagent, tstate, torch.as_tensor(obs))
    assert set(got) == set(want) == {"weights", "activations"}
    assert "params/actor_trunk/Dense_0" in got["weights"]
    for part in ("weights", "activations"):
        assert sorted(got[part]) == sorted(want[part]), part
        for layer, w in want[part].items():
            g = got[part][layer]
            assert set(g) == set(w), layer
            for k, v in w.items():
                if isinstance(v, int):
                    assert g[k] == v, (layer, k)
                else:
                    np.testing.assert_allclose(g[k], v, rtol=1e-5, atol=0,
                                               err_msg=f"{layer} {k}")
