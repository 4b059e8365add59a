"""The parkour slice through parc_torch's entry points, against parc_tpu
where the JAX package has the same function: the env builder, the CLI's
train_tracker on the parkour and mgdm envs (the latter with the CNN-MLP
vision policy) on the CPU, record and eval of a parkour tracker (both
build the deepmimic env with default physics, as the JAX CLI's
stage_record and stage_eval do), and the online A* + MDM replan.

Tolerances (f32): the built configs equal; astar_mdm_replan's frames
1e-4 absolute (kin-gen's, tests/test_torch_kin_gen.py), contacts, lengths
and the terrain slice equal.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch
import yaml

from parc_tpu.anim import motion_data as jmd
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.diffusion.mdm import MDM as JMDM
from parc_tpu.diffusion.mdm import MDMConfig as JCfg
from parc_tpu.envs import base as jbase
from parc_tpu.envs import builder as jbuilder
from parc_tpu.physics import engine as je
from parc_tpu.pipeline import cli as jcli
from parc_tpu.procgen import astar_mdm as jam
from parc_tpu.procgen import mdm_path as jmp
from parc_torch.anim import motion_data as tmd
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.diffusion.mdm import MDM as TMDM
from parc_torch.diffusion.mdm import MDMConfig as TCfg
from parc_torch.envs import builder as tbuilder
from parc_torch.envs.deepmimic import DeepMimicEnv
from parc_torch.envs.mgdm import MGDMEnv
from parc_torch.envs.parkour import ParkourEnv
from parc_torch.learning.vision_nets import DMCnnMlp
from parc_torch.pipeline import cli
from parc_torch.procgen import astar_mdm as tam
from parc_torch.procgen import mdm_path as tmp
from parc_torch.utils import checkpoint as ckpt
from test_torch_diffusion import _close
from test_torch_kin_gen import jax_draws
from test_torch_kin_gen import setup  # noqa: F401  (the MDMs' fixture)

torch.set_num_threads(1)

MDM_SMALL = dict(diffusion_timesteps=11, d_model=32, num_heads=2, d_hid=32,
                 num_layers=1)
NET = "fc_2layers_512units"
CONFIG = dict(
    MDM_SMALL, mgdm_num=2, plan_frames=4, ddim_stride=5, terrain_dim=20,
    terrain_seed=3, actor_net=NET, critic_net=NET, steps_per_iter=4,
    update_epochs=1, test_steps=4, start_fractions=[0.0], max_steps=4,
    iters_per_checkpoint=1,
    # physics and env settings that record and eval must not take over
    # (the env settings they do take: episode_length)
    sim={"control_mode": "pd_exp", "contact_stiffness": 9000.0,
         "friction": 0.5}, episode_length=5.0)


def _fields(dc, like=None):
    """The dataclass's fields (those of ``like`` if given: the JAX
    package's SimParams also holds ``use_pallas``)."""
    return {f.name: getattr(dc, f.name)
            for f in dataclasses.fields(like or dc)}


def test_build_env_dispatch():
    """build_env: the class and the configs that the JAX package's
    builder makes from the same dict, and the default platform."""
    tmodel = tspec().build(device="cpu")
    tmdm = TMDM(tmodel, TCfg(**MDM_SMALL), device="cpu")
    jmdm = JMDM(jspec().build(), JCfg(**MDM_SMALL))
    for name, cls in (("deepmimic", DeepMimicEnv), ("parkour", ParkourEnv),
                      ("mgdm", MGDMEnv)):
        cfg = dict(CONFIG, env_name=name, num_envs=4, terrain_dim=24)
        got = tbuilder.build_env(tmodel, cfg, mdm=tmdm, device="cpu")
        want = jbuilder.build_env(jmdm.model, cfg, mdm=jmdm)
        assert type(got) is cls and type(got).__name__ == type(want).__name__
        assert _fields(got.cfg) == _fields(want.cfg)
        assert _fields(got.sim_params) == _fields(want.sim_params,
                                                  got.sim_params)
        assert got.sim_params.friction == 0.5
        if name != "deepmimic":
            assert _fields(got.pcfg) == _fields(want.pcfg)
            np.testing.assert_array_equal(got.mgdm_terrain.hf.numpy(),
                                          np.asarray(want.mgdm_terrain.hf))
            assert got.n_dm == want.n_dm == (2 if name == "parkour" else 0)
    with pytest.raises(KeyError, match="unknown env_name"):
        tbuilder.build_env(tmodel, {"env_name": "nope"}, device="cpu")
    with pytest.raises(ValueError, match="needs an MDM"):
        tbuilder.build_env(tmodel, {"env_name": "parkour"}, device="cpu")


def _dataset(tmp_path, config):
    motions = tmp_path / "motions" / "walk"
    motions.mkdir(parents=True)
    tmd.save_motion_data(str(motions / "walk1.npz"),
                         tsyn.walking_clip(n=40, seed=1))
    tmd.save_motion_data(str(motions / "stand.npz"), tsyn.standing_clip(n=40))
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    ds = str(tmp_path / "dataset.yaml")
    common = ["--device", "cpu", "--config", str(path)]
    cli.main(["create_dataset", "--motions_dir", str(tmp_path / "motions"),
              "--out", ds] + common)
    return ds, common


@pytest.mark.parametrize("env_name", ["parkour", "mgdm"])
def test_cli_train_tracker(tmp_path, env_name, monkeypatch):
    """train_tracker --env_name parkour / mgdm for one iteration of 4 steps
    at 4 envs (the first step replans), from a fresh tiny MDM; finite
    losses and a checkpoint whose fail rates carry the terrain slot. The
    mgdm run trains the CNN-MLP vision policy."""
    config = dict(CONFIG, actor_net="dm_cnn_mlp") if env_name == "mgdm" \
        else CONFIG
    ds, common = _dataset(tmp_path, config)
    built = []
    build_env = tbuilder.build_env

    def spy(*args, **kwargs):
        built.append(build_env(*args, **kwargs))
        return built[-1]
    monkeypatch.setattr(tbuilder, "build_env", spy)
    calls = []
    gen = TMDM.ddim_sample
    monkeypatch.setattr(TMDM, "ddim_sample", lambda self, *a, **k: (
        calls.append(a[2].shape[0]), gen(self, *a, **k))[1])
    out = str(tmp_path / "tracker")
    state = cli.main(["train_tracker", "--dataset", ds, "--out_dir", out,
                      "--num_envs", "4", "--max_iters", "1",
                      "--env_name", env_name] + common)
    env = built[0]
    assert type(env) is (ParkourEnv if env_name == "parkour" else MGDMEnv)
    assert env.sim_params.control_mode == "pd_exp"
    assert env.pcfg.mgdm_num == (2 if env_name == "parkour" else 4)
    # the training rollout and the test rollout replan at their first step
    assert calls[:2] == [env.pcfg.mgdm_num] * 2
    assert float(state.sample_count) == 16
    assert ckpt.all_steps(f"{out}/checkpoints") == [1]
    restored = ckpt.restore(f"{out}/checkpoints")
    assert restored["fail_rates"].shape == (3,)
    with open(f"{out}/log.tsv") as f:
        row = dict(zip(f.readline().rstrip("\n").split("\t"),
                       f.readline().rstrip("\n").split("\t")))
    assert np.isfinite(float(row["Critic_Loss"]))
    assert np.isfinite(float(row["Actor_Loss"]))
    if env_name == "mgdm":
        assert any(k.startswith("tokenizer.") for k in restored["params"])


def test_record_eval_build_reference_env(tmp_path, monkeypatch):
    """record and eval of a parkour tracker trained under other physics
    (control_mode, contact_stiffness, a sim friction): both build a
    DeepMimicEnv with SimParams() and the EnvConfig that the JAX CLI's
    stage_record / stage_eval build from the same config; record runs to
    its end, one env per clip, the slot's fail rate dropped."""
    ds, common = _dataset(tmp_path, CONFIG)
    tracker = str(tmp_path / "tracker")
    cli.main(["train_tracker", "--dataset", ds, "--out_dir", tracker,
              "--num_envs", "4", "--max_iters", "1", "--env_name",
              "parkour"] + common)
    cfg = dict(CONFIG, env_name="parkour", dataset=ds, tracker_dir=tracker)
    built = []
    tracking_env = cli._tracking_env

    def spy(*args, **kwargs):
        built.append(tracking_env(*args, **kwargs))
        return built[-1]
    monkeypatch.setattr(cli, "_tracking_env", spy)
    results = cli.main(["record", "--dataset", ds, "--tracker_dir", tracker,
                        "--out_dir", str(tmp_path / "rec"), "--env_name",
                        "parkour"] + common)
    assert len(results) == 2
    test, _ = cli.main(["eval", "--dataset", ds, "--tracker_dir", tracker,
                        "--num_envs", "3", "--env_name", "parkour"] + common)
    assert int(test["test_steps"]) <= 4
    rec_env, eval_env = built
    want_rec = dataclasses.replace(
        jcli._dataclass_from_dict(jbase.EnvConfig, cfg), num_envs=2,
        rand_reset=False)
    want_eval = jcli._dataclass_from_dict(jbase.EnvConfig,
                                          dict(cfg, num_envs=3))
    for env, want in ((rec_env, want_rec), (eval_env, want_eval)):
        assert type(env) is DeepMimicEnv
        assert _fields(env.cfg) == _fields(want)
        assert _fields(env.sim_params) == _fields(je.SimParams(),
                                                  env.sim_params)
    assert rec_env.cfg.episode_length == 5.0
    assert rec_env.sim_params.control_mode == "pd_implicit"


def test_astar_mdm_replan(setup):  # noqa: F811
    """A warm-started replan over a terrain with a wall and a gap in it,
    2 rollouts of up to 1 s, the windows' noise from the JAX key chain;
    then a target walled in: no path in either."""
    jmdm, tmdm, s0, ts = (setup[k] for k in ("jmdm", "tmdm", "s0", "ts"))
    hf = np.zeros((24, 24), np.float32)
    hf[12, :] = 1.5
    hf[12, 16:19] = 0.0
    mp = np.asarray([-1.0, -2.0], np.float32)
    dxdy = np.asarray([0.4, 0.4], np.float32)
    clip = tsyn.walking_clip(seed=2)
    prev = clip.frames[:2].astype(np.float32)
    prev[:, 0:2] += np.asarray([1.4, 4.6], np.float32) - prev[-1, 0:2]
    contacts = clip.contacts[:2].astype(np.float32)
    target = np.asarray([7.2, 3.0])
    path = tmp.PathGenSettings(batch_size=2, max_seconds=1.0)
    key = jax.random.PRNGKey(9)
    want_clip, want_lib = jam.astar_mdm_replan(
        jmdm, s0, jmd.HostTerrain(hf=hf, min_point=mp, dxdy=dxdy), prev,
        contacts, target, key, jam.AStarMDMSettings(
            path=jmp.PathGenSettings(batch_size=2, max_seconds=1.0)))
    draws = jax_draws(key, None, (2, 15, 91), tmp.max_windows(tmdm, path))
    got_clip, got_lib = tam.astar_mdm_replan(
        tmdm, ts, tmd.HostTerrain(hf=hf, min_point=mp, dxdy=dxdy), prev,
        contacts, target, None, tam.AStarMDMSettings(path=path),
        draws=draws)
    assert got_clip.frames.shape == want_clip.frames.shape
    _close(got_clip.frames, want_clip.frames, 1e-4, "frames")
    np.testing.assert_array_equal(got_clip.contacts, want_clip.contacts)
    for f in ("hf", "min_point", "dxdy"):
        np.testing.assert_array_equal(getattr(got_clip.terrain, f),
                                      np.asarray(getattr(want_clip.terrain,
                                                         f)), f)
    assert got_lib.num_motions == 1
    assert int(got_lib.num_frames[0]) == int(want_lib.num_frames[0])
    walled = hf.copy()
    walled[14:21, 14] = walled[14:21, 20] = 5.0
    walled[14, 14:21] = walled[20, 14:21] = 5.0
    args = (prev, contacts, np.asarray([6.2, 5.2]))
    assert jam.astar_mdm_replan(
        jmdm, s0, jmd.HostTerrain(hf=walled, min_point=mp, dxdy=dxdy),
        *args, key) is None
    assert tam.astar_mdm_replan(
        tmdm, ts, tmd.HostTerrain(hf=walled, min_point=mp, dxdy=dxdy),
        *args, None) is None
