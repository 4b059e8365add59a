"""tools/orbax_to_torch.py: runs of the JAX package carried into the port.

The JAX CLI trains a tiny tracker (fc_2layers_512units nets, 2 iterations,
a checkpoint each) and a tiny MDM (d_model 64, 2 layers, 1 epoch), each in
a process of its own, side by side; a vision tracker (dm_cnn_mlp) with a
parkour tracker's fail rates (the terrain slot last) is saved by the JAX
package's checkpoint module from an init. The converter writes each as
the port's run, which the port's entry points then take as their own.

Tolerances: every parameter, momentum buffer, AdamW moment, normalizer
field, fail rate, feature stat and step bit-equal to the JAX package's
restore; the actor's mean action and the critic on 64 fixed observations
within 1e-5 of the largest JAX output (tests/test_torch_vision_nets.py);
the denoiser on fixed inputs within 1e-4 of its largest output (the
window tolerance of tests/test_torch_mdm_sampling.py). The JAX runs cost
about two minutes of CPU here, almost all of it XLA compiling the
tracker's train_iter (twice: the JAX trainer compiles it again for its
second call) and test rollout.
"""

import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from parc_tpu.anim.motion_data import save_motion_data
from parc_tpu.data import synthetic as jsyn
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.diffusion.mdm import MDM as JMDM
from parc_tpu.diffusion.mdm import MDMConfig as JCfg
from parc_tpu.envs import base as jbase
from parc_tpu.envs.deepmimic import DeepMimicEnv as JEnv
from parc_tpu.learning import normalizer as jnorm
from parc_tpu.learning import ppo as jppo
from parc_tpu.physics import engine as je
from parc_tpu.pipeline import cli as jcli
from parc_tpu.pipeline import train_tracker as jtt
from parc_tpu.utils import checkpoint as jckpt
from parc_torch import convert
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.diffusion.mdm import MDM as TMDM
from parc_torch.diffusion.mdm import MDMConfig as TCfg
from parc_torch.learning import normalizer as tnorm
from parc_torch.pipeline import cli
from parc_torch.pipeline import dataset as tds
from parc_torch.pipeline import train_tracker as ttt
from parc_torch.utils import checkpoint as tckpt
from test_torch_diffusion import _close, jit

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NET = "fc_2layers_512units"
TRACKER = dict(actor_net=NET, critic_net=NET, steps_per_iter=4,
               update_epochs=1, test_steps=4, test_episodes=2,
               iters_per_checkpoint=1, iters_per_output=1, norm_obs_clip=8.0)
MDM = dict(d_model=64, num_heads=2, d_hid=64, num_layers=2, batch_size=4)
CONFIG = dict(TRACKER, **MDM, iters_per_epoch=2, start_fractions=[0.0])
JAX_CLI = ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
           "from parc_tpu.pipeline import cli; cli.main(sys.argv[1:])")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", ROOT / "tools" / "orbax_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _raw(run, step):
    """The JAX package's own restore of a step, without a template, as
    numpy."""
    return jax.tree.map(np.asarray, jckpt.restore(
        os.path.join(run, "checkpoints"), None, step=step))


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _equal(got[k], want[k])
        elif isinstance(want[k], torch.Tensor):
            assert got[k].dtype == want[k].dtype and torch.equal(
                got[k], want[k]), k
        else:
            assert got[k] == want[k], k


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs (tracker and MDM trained through the JAX CLI in two
    processes at once; the vision tracker saved from an init) and their
    conversions."""
    w = tmp_path_factory.mktemp("orbax")
    for name, clip in (("walk1", jsyn.walking_clip(seed=1)),
                       ("stand", jsyn.standing_clip())):
        save_motion_data(str(w / "motions" / "walk" / f"{name}.npz"), clip)
    config = w / "small.yaml"
    config.write_text(yaml.safe_dump(CONFIG))
    ds = str(w / "ds.yaml")
    jcli.main(["create_dataset", "--motions_dir", str(w / "motions"),
               "--out", ds, "--config", str(config)])
    common = ["--dataset", ds, "--config", str(config)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_CLI] + argv + common, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for argv in (["train_tracker", "--out_dir", str(w / "tracker"),
                      "--num_envs", "4", "--max_iters", "2"],
                     ["train_mdm", "--out_dir", str(w / "mdm"),
                      "--max_epochs", "1"])]
    vision = w / "vision"
    jagent, params = vision_run(vision)
    for p in procs:
        out = p.communicate(timeout=900)[0]
        assert p.returncode == 0, out[-3000:]
    tool = _tool()
    for name in ("tracker", "mdm", "vision"):
        tool.main([str(w / name), str(w / f"{name}_pt"), "--config",
                   str(config)])
    return dict(w=w, ds=ds, config=str(config), vision_agent=jagent,
                vision_params=params)


def vision_run(out):
    """A dm_cnn_mlp tracker's persistent state at steps 1 and 2 (the
    second with moved parameters and momentum) saved by the JAX package,
    its fail rates those of a parkour tracker on two clips: the terrain
    slot last."""
    env = JEnv(jspec().build(), je.SimParams(),
               jbase.EnvConfig(num_envs=2))
    agent = jppo.PPOAgent(env, jppo.PPOConfig(actor_net="dm_cnn_mlp",
                                              norm_obs_clip=8.0))
    params = jit(agent.net.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, env.obs_dim)))
    rng = np.random.default_rng(1)
    mask = (~env.obs_layout.non_norm_mask()).astype(np.float32)
    spread = rng.normal(0.5, 2.0, (64, env.obs_dim)).astype(np.float32)
    opt_state = agent.tx.init(params)
    saved = {}
    for step in (1, 2):
        state = jppo.AgentState(
            params=params, opt_state=opt_state,
            obs_norm=jnorm.update(jnorm.create(env.obs_dim, mask, clip=8.0),
                                  spread * step),
            env_state=types.SimpleNamespace(
                fail_rates=jnp.asarray([0.3, 0.7, 0.5]) / step),
            rng=jax.random.PRNGKey(0), sample_count=jnp.asarray(64.0 * step))
        jckpt.save(str(out / "checkpoints"), step,
                   jppo.persistent_state(state))
        saved[step] = params
        noise = jax.tree.map(
            lambda x: jnp.asarray(rng.normal(0, 1e-2, x.shape), x.dtype),
            params)
        params = jax.tree.map(jnp.add, params, noise)
        opt_state = jax.tree.map(lambda x: x + 1.0, opt_state)
    return agent, saved


def _persistent(run, step, clip=8.0):
    tree = _raw(run, step)
    tree["obs_norm"] = dict(tree["obs_norm"], clip=clip, sample_limit=3e8)
    tree["opt_state"] = _tool().optax_state(tree["opt_state"])
    return convert.persistent_from_numpy(tree)


@pytest.mark.parametrize("name", ["tracker", "vision"])
def test_tracker_checkpoints_bit_equal(runs, name):
    """Every step: parameters, momentum, normalizer, sample count and fail
    rates bit-equal to the JAX package's restore; the log copied, so the
    best step is the same."""
    w = runs["w"]
    src, dst = str(w / name), str(w / f"{name}_pt")
    steps = jckpt.all_steps(os.path.join(src, "checkpoints"))
    assert steps == [1, 2]
    assert tckpt.all_steps(os.path.join(dst, "checkpoints")) == steps
    for step in steps:
        got = tckpt.restore(os.path.join(dst, "checkpoints"), step=step)
        _equal(got, _persistent(src, step))
        raw = _raw(src, step)
        trunk = ("tokenizer.conv.0" if name == "vision"
                 else "actor_trunk.0")
        kernel = (raw["params"]["params"]["RayConvTokenizer_0"]["Conv_0"]
                  if name == "vision"
                  else raw["params"]["params"]["actor_trunk"]["Dense_0"])
        trace = [s for s in jax.tree.leaves(
            raw["opt_state"], is_leaf=lambda x: isinstance(x, dict)
            and "trace" in x)][0]["trace"]
        momentum = trace["params"]
        for tree, kind in ((kernel, "params"), (None, "momentum")):
            if tree is None:  # the same leaf of optax's momentum trace
                tree = (momentum["RayConvTokenizer_0"]["Conv_0"]
                        if name == "vision"
                        else momentum["actor_trunk"]["Dense_0"])
            k = tree["kernel"]
            want = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
            have = (got["params"] if kind == "params"
                    else got["opt_state"]["momentum"])[f"{trunk}.weight"]
            assert np.array_equal(have.numpy(), want), kind
        assert np.array_equal(got["fail_rates"].numpy(), raw["fail_rates"])
        assert got["obs_norm"]["clip"] == 8.0
    if name == "tracker":
        assert (ttt.best_checkpoint_step(dst)
                == jtt.best_checkpoint_step(src))
        assert (w / "tracker_pt" / "config.yaml").read_text() == (
            pathlib.Path(runs["config"]).read_text())
    else:
        assert len(got["fail_rates"]) == 3  # the terrain slot kept


@pytest.mark.parametrize("name", ["tracker", "vision"])
def test_restored_nets_match_jax(runs, name):
    """Restored as record and eval restore a tracker (cli._restored_agent,
    a parkour tracker's terrain slot dropped), the actor's mean action and
    the critic on 64 fixed observations through each stack's normalizer
    and net."""
    w = runs["w"]
    cfg = dict(CONFIG, tracker_dir=str(w / f"{name}_pt"))
    if name == "vision":
        cfg["actor_net"] = "dm_cnn_mlp"
    model = tspec().build(device="cpu")
    lib = tds.load_dataset(model, runs["ds"], device="cpu")
    env = cli._tracking_env(model, cfg, "cpu", num_envs=2)
    agent, state = cli._restored_agent(cfg, lib, env, seed=0)
    assert state.env_state.fail_rates.shape == (2,)
    if name == "vision":
        jagent, params = runs["vision_agent"], runs["vision_params"][2]
    else:
        jenv = JEnv(jspec().build(), je.SimParams(),
                    jbase.EnvConfig(num_envs=2))
        jagent = jppo.PPOAgent(jenv, jppo.PPOConfig(**{
            k: v for k, v in TRACKER.items()
            if k in jppo.PPOConfig.__dataclass_fields__}))
        params = _raw(str(w / name), 2)["params"]
    raw = _raw(str(w / name), 2)
    norm = jnorm.NormalizerState(**{f: jnp.asarray(raw["obs_norm"][f])
                                    for f in ("mean", "var", "count",
                                              "norm_mask")}, clip=8.0)
    obs = np.random.default_rng(3).normal(
        0.0, 2.0, (64, env.obs_dim)).astype(np.float32)
    want = jit(lambda p, o: jagent.net.apply(p, jnorm.normalize(norm, o)))(
        params, obs)
    with torch.no_grad():
        got = agent.net(tnorm.normalize(state.obs_norm, torch.as_tensor(obs)))
    for g, w_, what in zip(got, want, ("mean", "logstd", "value")):
        _close(g, w_, 1e-5, what, rel=True)


def test_mdm_checkpoint_and_denoiser(runs):
    """Every step of the MDM run bit-equal to the JAX package's restore
    (params, EMA params, AdamW's moments and step, stats, step); restored
    as kin_gen restores --mdm_dir, the denoiser on fixed inputs."""
    w = runs["w"]
    src, dst = str(w / "mdm"), str(w / "mdm_pt")
    steps = jckpt.all_steps(os.path.join(src, "checkpoints"))
    assert steps == [1] and tckpt.all_steps(
        os.path.join(dst, "checkpoints")) == steps
    raw = _raw(src, 1)
    raw["opt_state"] = _tool().optax_state(raw["opt_state"])
    _equal(tckpt.restore(os.path.join(dst, "checkpoints")),
           convert.mdm_state_from_numpy(raw))
    assert int(raw["step"]) == 2
    model = tspec().build(device="cpu")
    lib = tds.load_dataset(model, runs["ds"], device="cpu")
    mdm = TMDM(model, TCfg(**MDM), device="cpu")
    state = mdm.merge_persistent(
        mdm.init(lib, torch.Generator().manual_seed(0), stats_samples=8),
        tckpt.restore(os.path.join(dst, "checkpoints")))
    jmdm = JMDM(jspec().build(), JCfg(**MDM))
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (3, 15, mdm.frame_dim)).astype(np.float32)
    t = np.array([0, 17, 900], np.int32)
    prev = rng.normal(0, 1, (3, 2, mdm.frame_dim)).astype(np.float32)
    hf = rng.uniform(-0.3, 0.3, (3, 31, 31)).astype(np.float32)
    target = rng.normal(0, 1, (3, 2)).astype(np.float32)
    want = jit(jmdm.net.apply)(raw["params"], x, t, prev, hf, target)
    with torch.no_grad():
        got = state.net(*(torch.as_tensor(a) for a in (x, t, prev, hf,
                                                       target)))
    _close(got, want, 1e-4, "denoiser", rel=True)


def test_record_and_resume_from_converted_run(runs, capsys):
    """The port's record runs from the converted tracker, and its
    train_tracker resumes from it at the converted step."""
    w = runs["w"]
    common = ["--dataset", runs["ds"], "--config", runs["config"],
              "--device", "cpu"]
    recorded = cli.main(["record", "--tracker_dir", str(w / "tracker_pt"),
                         "--out_dir", str(w / "recorded")] + common)
    assert len(recorded) == 2
    out = w / "resumed"
    shutil.copytree(w / "tracker_pt", out)
    cli.main(["train_tracker", "--out_dir", str(out), "--num_envs", "2",
              "--max_iters", "3"] + common)
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    assert tckpt.all_steps(str(out / "checkpoints")) == [1, 2, 3]


def test_orbax_run_names_the_converter(runs, tmp_path):
    """Given the JAX run itself, the port's loader says it is an orbax run
    and names the converter (record's --tracker_dir, the --mdm_dir
    loader); the converter refuses a tree that is neither kind."""
    w = runs["w"]
    with pytest.raises(FileNotFoundError, match="orbax run of the JAX "
                       "package.*tools/orbax_to_torch.py"):
        cli.main(["record", "--dataset", runs["ds"], "--tracker_dir",
                  str(w / "tracker"), "--out_dir", str(tmp_path / "rec"),
                  "--config", runs["config"], "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="tools/orbax_to_torch.py"):
        tckpt.restore(str(w / "mdm" / "checkpoints"))
    jckpt.save(str(tmp_path / "other" / "checkpoints"), 1,
               {"weights": jnp.zeros(3)})
    with pytest.raises(ValueError, match="not a tracker or MDM"):
        _tool().main([str(tmp_path / "other"), str(tmp_path / "other_pt")])
