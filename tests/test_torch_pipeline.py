"""The tracker stage's host side in parc_torch (checkpoints and resume,
the best-checkpoint rule, the dataset manifest and its terrain masks, the
CLI chain) against parc_tpu's, on the CPU.

Tolerances: the manifest's weights at 1e-7, the precomputed masks and
per-frame mask cells equal, the augmentation bounds at 1e-6 (f32 heights
plus constant buffers), the loaded libraries at 1e-6; a checkpoint restores
bit for bit.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from parc_tpu.data import synthetic as jsyn
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.pipeline import dataset as jds
from parc_tpu.pipeline import train_tracker as jtt
from parc_torch.anim import motion_data as tmd
from parc_torch.anim import motion_lib as tml
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.envs import base as tbase
from parc_torch.envs import builder
from parc_torch.envs import deepmimic as tdm
from parc_torch.learning import ppo as tppo
from parc_torch.physics import engine as te
from parc_torch.pipeline import cli
from parc_torch.pipeline import dataset as tds
from parc_torch.pipeline import train_tracker as ttt
from parc_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

NET = "fc_2layers_512units"
SMALL = dict(actor_net=NET, critic_net=NET)


def _train(out_dir, num_envs, max_iters):
    cfg = tbase.EnvConfig(num_envs=num_envs)
    env = tdm.DeepMimicEnv(tspec().build(device="cpu"), te.SimParams(), cfg,
                           device="cpu")
    agent = tppo.PPOAgent(env, tppo.PPOConfig(steps_per_iter=2, **SMALL),
                          device="cpu")
    lib = tml.build_motion_lib(
        env.model, [tsyn.standing_clip(), tsyn.walking_clip(seed=1)],
        device="cpu")
    tcfg = ttt.TrainerConfig(output_dir=str(out_dir), test_steps=2,
                             test_episodes=2)
    return agent, lib, ttt.train(agent, lib, tcfg, max_iters=max_iters)


def test_checkpoint_round_trip(tmp_path):
    """A checkpoint of 4 envs restores into 2; re-running a finished run
    with the same max_iters is a no-op."""
    agent, lib, state = _train(tmp_path, 4, 1)
    ckpt_dir = tmp_path / "checkpoints"
    assert ckpt.all_steps(str(ckpt_dir)) == [1]
    saved = tppo.persistent_state(agent, state)
    assert float(saved["sample_count"]) == 2 * 4

    env2 = tdm.DeepMimicEnv(tspec().build(device="cpu"), te.SimParams(),
                            tbase.EnvConfig(num_envs=2), device="cpu")
    agent2 = tppo.PPOAgent(env2, agent.cfg, device="cpu")
    fresh = agent2.init(lib, torch.Generator().manual_seed(3))
    restored = tppo.merge_persistent(
        agent2, fresh, ckpt.restore(str(ckpt_dir)))
    assert restored.env_state.obs.shape[0] == 2
    back = tppo.persistent_state(agent2, restored)
    for group in ("params", "opt_state"):
        a = saved[group] if group == "params" else saved[group]["momentum"]
        b = back[group] if group == "params" else back[group]["momentum"]
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for f in ("mean", "var", "count", "norm_mask"):
        assert torch.equal(saved["obs_norm"][f], back["obs_norm"][f])
    assert torch.equal(saved["fail_rates"], back["fail_rates"])
    assert float(back["sample_count"]) == float(saved["sample_count"])
    # momentum is nonzero after a step, so the optimizer state round-trips
    assert any(float(v.abs().max()) > 0
               for v in back["opt_state"]["momentum"].values())

    # resume: the same max_iters is a no-op (no training, no new step)
    _, _, again = _train(tmp_path, 4, 1)
    assert float(again.sample_count) == float(saved["sample_count"])
    assert ckpt.all_steps(str(ckpt_dir)) == [1]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"))


@pytest.mark.parametrize("steps", [[100, 200, 300], [50, 250], [400], []])
def test_best_checkpoint_step(tmp_path, steps):
    rows = [("Iteration", "Samples", "Test_Reward"),
            (1, 10, 0.2), (100, 1000, 0.5), (200, 2000, 0.7),
            (300, 3000, 0.7), (400, 4000, "nan?")]
    (tmp_path / "log.tsv").write_text(
        "\n".join("\t".join(str(c) for c in r) for r in rows) + "\n")
    got = ttt.best_checkpoint_step(str(tmp_path), steps=steps)
    assert got == jtt.best_checkpoint_step(str(tmp_path), steps=steps)
    # without a log the last retained step wins
    (tmp_path / "log.tsv").unlink()
    assert ttt.best_checkpoint_step(str(tmp_path), steps=steps) == \
        jtt.best_checkpoint_step(str(tmp_path), steps=steps)


def test_cli_chain(tmp_path, capsys):
    """create_dataset -> train_tracker (2 iterations, 4 envs) -> record
    (restored into one env per clip) -> eval --diagnostics, on the CPU."""
    motions = tmp_path / "motions" / "walk"
    motions.mkdir(parents=True)
    tmd.save_motion_data(str(motions / "walk1.npz"),
                         tsyn.walking_clip(n=20, seed=1))
    tmd.save_motion_data(str(motions / "stand.npz"), tsyn.standing_clip(n=20))
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump(dict(
        SMALL, steps_per_iter=4, update_epochs=2, test_steps=4,
        start_fractions=[0.0], max_steps=4, iters_per_checkpoint=1)))
    ds = str(tmp_path / "dataset.yaml")
    tracker = str(tmp_path / "tracker")
    common = ["--device", "cpu", "--config", str(config)]
    cli.main(["create_dataset", "--motions_dir", str(tmp_path / "motions"),
              "--out", ds] + common)
    state = cli.main(["train_tracker", "--dataset", ds, "--out_dir", tracker,
                      "--num_envs", "4", "--max_iters", "2"] + common)
    assert float(state.sample_count) == 2 * 4 * 4
    assert ckpt.all_steps(f"{tracker}/checkpoints") == [1, 2]
    with open(f"{tracker}/log.tsv") as f:
        header = f.readline().rstrip("\n").split("\t")
    for key in ("Iteration", "Samples", "Test_Reward", "Samples_Per_Sec",
                "Critic_Loss", "root_pos_err", "walk_mean_fail_rate"):
        assert key in header
    results = cli.main(["record", "--dataset", ds, "--tracker_dir", tracker,
                        "--out_dir", str(tmp_path / "rec"),
                        "--checkpoint", "best"] + common)
    assert len(results) == 2
    test, report = cli.main(["eval", "--dataset", ds, "--tracker_dir",
                             tracker, "--num_envs", "4", "--diagnostics"]
                            + common)
    assert int(test["test_steps"]) <= 4
    assert set(report) == {"weights", "activations"}
    assert report["weights"]["params/actor_trunk/Dense_0"]["max_rank"] == 512
    out = capsys.readouterr().out
    assert "recorded" in out and "network diagnostics" in out
    # the parkour and mgdm envs train through this stage too
    # (tests/test_torch_parkour_cli.py); an unknown env name is refused
    with pytest.raises(KeyError, match="unknown env_name"):
        builder.build_env(cli._build_model("cpu"), {"env_name": "nope"},
                          device="cpu")


def _motions_dir(root):
    """Two classes of clips on terrain, none with masks yet; the walk's
    terrain has a raised block on its path. The clips share a length, so
    the JAX side compiles its ops once."""
    walk = tsyn.walking_clip(seed=1)
    walk.terrain.hf[10:14, 3:9] = 0.3  # a step the walk passes
    for name, clip in (("walk/walk1", walk),
                       ("walk/stand", tsyn.standing_clip()),
                       ("run/run1", tsyn.walking_clip(seed=2, speed=2.0))):
        tmd.save_motion_data(str(root / f"{name}.npz"), clip)


def test_dataset(tmp_path):
    for side in ("jax", "torch"):
        _motions_dir(tmp_path / side)
    want = jds.create_dataset_yaml(str(tmp_path / "jax"),
                                   str(tmp_path / "jax.yaml"))
    got = tds.create_dataset_yaml(str(tmp_path / "torch"),
                                  str(tmp_path / "torch.yaml"), device="cpu")
    with open(want) as f:
        w_entries = yaml.safe_load(f)["motions"]
    with open(got) as f:
        g_entries = yaml.safe_load(f)["motions"]
    assert [os.path.relpath(e["file"], tmp_path / "torch") for e in g_entries] \
        == [os.path.relpath(e["file"], tmp_path / "jax") for e in w_entries]
    assert [e["class"] for e in g_entries] == [e["class"] for e in w_entries]
    np.testing.assert_allclose([e["weight"] for e in g_entries],
                               [e["weight"] for e in w_entries], atol=1e-7)
    for g, w in zip(g_entries, w_entries):
        gc, wc = tmd.load_motion_data(g["file"]), tmd.load_motion_data(w["file"])
        np.testing.assert_array_equal(gc.terrain.hf_mask, wc.terrain.hf_mask)
        np.testing.assert_allclose(gc.terrain.hf_maxmin, wc.terrain.hf_maxmin,
                                   atol=1e-6)
        assert gc.terrain.hf_mask.any()
        assert len(gc.hf_mask_inds) == len(wc.hf_mask_inds)
        for a, b in zip(gc.hf_mask_inds, wc.hf_mask_inds):
            np.testing.assert_array_equal(a, b)

    assert tds.dataset_meta(got)["names"] == jds.dataset_meta(want)["names"]
    assert tds.dataset_meta(got)["classes"] == jds.dataset_meta(want)["classes"]
    tlib = tds.load_dataset(tspec().build(device="cpu"), got, device="cpu")
    jlib = jds.load_dataset(jspec().build(), want)
    for f in ("weights", "lengths", "terrain_hf", "terrain_maxmin",
              "frame_root_pos", "frame_contacts"):
        np.testing.assert_allclose(getattr(tlib, f).numpy(),
                                   np.asarray(getattr(jlib, f)), atol=1e-6,
                                   err_msg=f)


def test_ensure_terrains():
    clip = tsyn.walking_clip(seed=1)
    clip.terrain = None
    tds.ensure_terrains(tspec().build(device="cpu"), [clip])
    jclip = jsyn.walking_clip(seed=1)
    jclip.terrain = None
    jds.ensure_terrains(jspec().build(), [jclip])
    np.testing.assert_allclose(clip.terrain.hf, jclip.terrain.hf, atol=1e-5)
    np.testing.assert_allclose(clip.terrain.min_point,
                               jclip.terrain.min_point, atol=1e-5)
