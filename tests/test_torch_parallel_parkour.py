"""The parkour env under data parallelism (parc_torch/parallel/mesh.py,
envs/parkour.py's local_shard and shard_row_permutation) against the JAX
package and against the port's own single-process step, on the CPU, and
the CLI's train_tracker under ``torch.distributed.run`` with two gloo
ranks.

Tolerances: the row permutation, the local envs' splits and the
shard-major state equal; a two-rank step against the single-process step
after the permutation at tests/test_multichip.py:159-200's tolerances
(reward 1e-5, done equal, obs 2e-4, the window buffers 1e-5), with the
same on the sim state's root and joints at 2e-4 (the control-step
tolerance); where the step replans, each rank generates its own rows with
its block of the same draws, within 1e-5 of the single process's (a
denoiser batch of 2 rows against one of 4). The ranks of the CLI run agree
to the bit (parameters, fail rates) and replan on the same steps.
"""

import dataclasses
import os
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.diffusion.mdm import MDM as JMDM
from parc_tpu.diffusion.mdm import MDMConfig as JCfg
from parc_tpu.envs import base as jbase
from parc_tpu.envs import mgdm as jmgdm
from parc_tpu.envs import parkour as jpk
from parc_tpu.parallel import mesh as jmesh
from parc_tpu.physics import engine as je
from parc_torch import convert
from parc_torch.anim import motion_data as tmd
from parc_torch.anim import motion_lib as tml
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.diffusion.mdm import MDM as TMDM
from parc_torch.diffusion.mdm import MDMConfig as TCfg
from parc_torch.envs import base as tbase
from parc_torch.envs import mgdm as tmgdm
from parc_torch.envs import parkour as tpk
from parc_torch.parallel import mesh as tmesh
from parc_torch.physics import engine as te
from parc_torch.learning import ppo as tppo
from parc_torch.pipeline import cli
from parc_torch.pipeline import train_tracker as ttrain
from parc_torch.utils import checkpoint as ckpt
from test_torch_parallel import (RANK_TIMEOUT_S, REPO, _rendezvous_failed,
                                 free_port, run_group, run_ranks)

torch.set_num_threads(1)

MDM_SMALL = dict(diffusion_timesteps=11, d_model=32, num_heads=2, d_hid=32,
                 num_layers=1)
N, NM, W = 8, 4, 2
PCFG = dict(mgdm_num=NM, plan_frames=4, ddim_stride=5)

# one rank: the local env's step on its block of the shard-major state
STEP_CHILD = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    from parc_torch.envs.parkour import ReplanDraws, TargetDraws
    from parc_torch.parallel import mesh

    inp = torch.load(sys.argv[1], weights_only=False)
    info = mesh.init_distributed(backend="gloo", device="cpu",
                                 timeout_s=inp["timeout_s"])
    rank, world = info.rank, info.world_size
    env, bundle, d = inp["env"], inp["bundle"], inp["draws"]
    local = env.local_shard(world)
    perm = torch.as_tensor(env.shard_row_permutation(world))
    k, km = env.cfg.num_envs // world, env.pcfg.mgdm_num // world
    rows, mrows = slice(rank * k, (rank + 1) * k), slice(rank * km,
                                                         (rank + 1) * km)
    draws = ReplanDraws(noise=d.noise[mrows], target=TargetDraws(
        ang_u=d.target.ang_u[mrows], rad_u=d.target.rad_u[mrows]))
    out = {}
    for name, es in inp["states"].items():
        es = mesh.local_block(env, mesh.shard_major_env_state(env, es, world),
                              rank, world)
        out[name] = local.step(bundle, es, inp["act"][perm][rows],
                               generator=torch.Generator().manual_seed(2),
                               replan_draws=draws)
    torch.save(out, f"{sys.argv[2]}/rank{rank}.pt")
    mesh.shutdown()
""")

# one rank of a torchrun launch of the CLI's train_tracker, recording what
# it writes, when it replans, and its final persistent state
CLI_CHILD = textwrap.dedent("""
    import os
    import sys
    import torch
    torch.set_num_threads(1)
    from parc_torch.envs.parkour import ParkourEnv
    from parc_torch.learning import ppo
    from parc_torch.pipeline import cli, train_tracker
    from parc_torch.utils import checkpoint as ckpt_lib

    rec = dict(saves=[], logs=[], replans=[], steps=0)
    save, logger = ckpt_lib.save, train_tracker.Logger
    step, replan = ParkourEnv.step, ParkourEnv._replan
    train_iter = ppo.PPOAgent.train_iter

    def spy_save(directory, s, state):
        rec["saves"].append(s)
        return save(directory, s, state)

    class SpyLogger(logger):
        def __init__(self, output_file=None, **kw):
            rec["logs"].append(output_file)
            super().__init__(output_file=output_file, **kw)

    def spy_step(self, *a, **kw):
        rec["steps"] += 1
        return step(self, *a, **kw)

    def spy_replan(self, *a, **kw):
        rec["replans"].append(rec["steps"])
        return replan(self, *a, **kw)

    def spy_iter(self, *a, **kw):
        rec["agent"] = self
        return train_iter(self, *a, **kw)

    ckpt_lib.save, train_tracker.Logger = spy_save, SpyLogger
    ParkourEnv.step, ParkourEnv._replan = spy_step, spy_replan
    ppo.PPOAgent.train_iter = spy_iter
    # the group's timeout, short in tests
    import functools
    from parc_torch.parallel import mesh
    mesh.init_distributed = functools.partial(
        mesh.init_distributed, timeout_s=float(os.environ["RANK_TIMEOUT_S"]))
    state = cli.main(sys.argv[2:])
    agent = rec.pop("agent")
    rec.update(end=ppo.persistent_state(agent, state),
               envs=agent.env.cfg.num_envs, mgdm=agent.env.pcfg.mgdm_num)
    torch.save(rec, f"{sys.argv[1]}/rank{os.environ['RANK']}.pt")
""")


def _jax_env(num_envs, mgdm_num):
    jmdm = JMDM(jspec().build(), JCfg(**MDM_SMALL))
    terrain = jmgdm.make_platform_terrain(np.random.default_rng(0), dim=20)
    return jpk.ParkourEnv(jmdm.model, je.SimParams(),
                          jbase.EnvConfig(num_envs=num_envs),
                          jpk.ParkourConfig(mgdm_num=mgdm_num, plan_frames=4,
                                            ddim_stride=5), jmdm, terrain)


@pytest.fixture(scope="module")
def parkour():
    """The port's parkour env (8 envs, 4 mgdm rows, a tiny fresh MDM), its
    bundle and a reset state."""
    model = tspec().build(device="cpu")
    lib = tml.build_motion_lib(
        model, [tsyn.standing_clip(), tsyn.walking_clip(seed=1)],
        device="cpu")
    mdm = TMDM(model, TCfg(**MDM_SMALL), device="cpu")
    mstate = mdm.init(lib, torch.Generator().manual_seed(0),
                      stats_samples=64)
    terrain = tmgdm.make_platform_terrain(np.random.default_rng(0), dim=20,
                                          device="cpu")
    env = tpk.ParkourEnv(model, te.SimParams(), tbase.EnvConfig(num_envs=N),
                         tpk.ParkourConfig(**PCFG), mdm, terrain,
                         device="cpu")
    bundle = env.make_lib(lib, mstate)
    es = env.reset(bundle, torch.Generator().manual_seed(1))
    return env, bundle, es


@pytest.mark.parametrize("num_envs,mgdm_num,world",
                         [(8, 4, 2), (12, 4, 4), (16, 8, 8)])
def test_shard_row_permutation_and_local_shard(num_envs, mgdm_num, world):
    """The permutation to shard-major rows and the per-rank env's split
    equal the JAX package's; a split that does not divide raises."""
    mdm = TMDM(tspec().build(device="cpu"), TCfg(**MDM_SMALL), device="cpu")
    terrain = tmgdm.make_platform_terrain(np.random.default_rng(0), dim=20,
                                          device="cpu")
    env = tpk.ParkourEnv(mdm.model, te.SimParams(),
                         tbase.EnvConfig(num_envs=num_envs),
                         tpk.ParkourConfig(mgdm_num=mgdm_num, plan_frames=4,
                                           ddim_stride=5), mdm, terrain,
                         device="cpu")
    jenv = _jax_env(num_envs, mgdm_num)
    np.testing.assert_array_equal(env.shard_row_permutation(world),
                                  jenv.shard_row_permutation(world))
    local, jlocal = env.local_shard(world), jenv.local_shard(world)
    assert type(local) is tpk.ParkourEnv
    assert (local.cfg.num_envs, local.pcfg.mgdm_num, local.n_dm) == \
        (jlocal.cfg.num_envs, jlocal.pcfg.mgdm_num, jlocal.n_dm)
    np.testing.assert_array_equal(local.mgdm_mask.numpy(), jlocal.mgdm_mask)
    with pytest.raises(ValueError):
        env.local_shard(3 * world)


def test_shard_major_local_blocks(parkour):
    """``shard_major_env_state`` and each rank's ``local_block`` against the
    JAX package's shard-major state split into contiguous blocks (as
    P('data') splits it), built through ``convert``."""
    env, _, es = parkour
    jenv = _jax_env(N, NM)

    def j(x):
        x = x.numpy()
        return jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
    jstate = jpk.ParkourState(
        sim=je.SimState(**{k: j(v) for k, v in vars(es.sim).items()}),
        rng=jax.random.PRNGKey(0),
        replan_timer=jnp.asarray(es.replan_timer, jnp.int32),
        **{k: j(v) for k, v in vars(es).items()
           if k not in ("sim", "replan_timer")})
    jmajor = jax.tree.map(np.asarray,
                          jmesh.shard_major_env_state(jenv, jstate, W))
    major = tmesh.shard_major_env_state(env, es, W)
    np.testing.assert_array_equal(major.sim.root_pos.numpy(),
                                  jmajor.sim.root_pos)
    np.testing.assert_array_equal(major.motion_ids.numpy(),
                                  jmajor.motion_ids)
    k, km = N // W, NM // W
    for r in range(W):
        got = tmesh.local_block(env, major, r, W)
        want = convert.local_env_state_from_numpy(env, jmajor, r, W)
        assert got.done.shape == (k,) and got.ref_frames34.shape[0] == km
        assert got.replan_timer == want.replan_timer == es.replan_timer
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "sim":
                for g in dataclasses.fields(a):
                    assert torch.equal(getattr(a, g.name),
                                       getattr(b, g.name)), g.name
            elif isinstance(a, torch.Tensor):
                assert torch.equal(a, b.to(a.dtype)), f.name
        assert torch.equal(got.fail_rates, es.fail_rates)
        np.testing.assert_array_equal(
            got.ref_frames34.numpy(), jmajor.ref_frames34[r * km:(r + 1) * km])


def test_trainer_raises_where_the_batch_does_not_split(parkour, monkeypatch,
                                                       tmp_path):
    """The trainer trains data-parallel over every rank of the launch:
    where num_envs (8 over 3 ranks) or mgdm_num (4 over 8 ranks) does not
    divide, it raises ValueError before it builds a state or writes a
    file (the JAX package falls back to training single-program)."""
    env, bundle, _ = parkour
    agent = tppo.PPOAgent(env, tppo.PPOConfig(
        actor_net="fc_2layers_512units", critic_net="fc_2layers_512units"),
        device="cpu")
    cfg = ttrain.TrainerConfig(output_dir=str(tmp_path / "tracker"))
    for world, what in ((3, "num_envs 8"), (8, "mgdm_num 4")):
        monkeypatch.setattr(tmesh, "default_group", lambda: "world")
        monkeypatch.setattr(tmesh, "world_size",
                            lambda group, w=world: w if group else 1)
        with pytest.raises(ValueError, match=what):
            ttrain.train(agent, bundle, cfg, max_iters=1)
    assert not (tmp_path / "tracker").exists()


@pytest.fixture(scope="module")
def two_rank_steps(parkour, tmp_path_factory):
    """One step of two ranks (gloo) and of one process from the same
    state: the replan timer parked, and a step that replans."""
    env, bundle, es = parkour
    tmp = tmp_path_factory.mktemp("parkour_dp")
    lo, hi = env.action_bounds()
    act = torch.as_tensor((lo + hi) / 2.0).expand(N, -1).contiguous()
    draws = env.draw_replan(torch.Generator().manual_seed(3))
    states = {"parked": dataclasses.replace(es, replan_timer=1000),
              "replan": dataclasses.replace(es, replan_timer=1)}
    torch.save(dict(env=env, bundle=bundle, states=states, act=act,
                    draws=draws, timeout_s=RANK_TIMEOUT_S), tmp / "in.pt")
    (tmp / "rank.py").write_text(STEP_CHILD)
    run_ranks(tmp / "rank.py", [tmp / "in.pt", tmp])
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(W)]
    single = {name: env.step(bundle, s, act,
                             generator=torch.Generator().manual_seed(2),
                             replan_draws=draws)
              for name, s in states.items()}
    return env, ranks, single


@pytest.mark.parametrize("case", ["parked", "replan"])
def test_two_rank_step_matches_single(two_rank_steps, case):
    """Each rank's step of its local env equals the single process's step
    on the rank's rows (dm and mgdm), after the permutation."""
    env, ranks, single = two_rank_steps
    want = tmesh.shard_major_env_state(env, single[case], W)
    assert not bool(want.done.any()), "setup: no dones"
    if case == "replan":
        assert want.replan_timer == env.pcfg.plan_frames
        assert not bool(want.ref_synthetic.any())
    for r, out in enumerate(ranks):
        got, w = out[case], tmesh.local_block(env, want, r, W)
        assert got.replan_timer == w.replan_timer
        np.testing.assert_allclose(got.reward.numpy(), w.reward.numpy(),
                                   atol=1e-5)
        np.testing.assert_array_equal(got.done.numpy(), w.done.numpy())
        np.testing.assert_allclose(got.obs.numpy(), w.obs.numpy(), atol=2e-4)
        for f in ("root_pos", "root_rot", "joint_rot", "dof_vel"):
            np.testing.assert_allclose(getattr(got.sim, f).numpy(),
                                       getattr(w.sim, f).numpy(), atol=2e-4,
                                       err_msg=f)
        for f in ("ref_frames34", "ref_contacts", "target_xy"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       getattr(w, f).numpy(), atol=1e-5,
                                       err_msg=f)
        np.testing.assert_array_equal(got.ref_synthetic.numpy(),
                                      w.ref_synthetic.numpy())


def test_cli_train_tracker_torchrun(tmp_path):
    """train_tracker --env_name parkour under ``python -m
    torch.distributed.run --nproc_per_node 2`` (gloo, tiny nets and MDM,
    4 envs and 2 mgdm rows in all): each rank trains 2 envs and 1 mgdm
    row, both replan on the same steps, their parameters and fail rates
    agree to the bit, only rank 0 writes the log and the checkpoint, and
    that checkpoint restores into a single-process run with 6 envs
    (tests/test_multichip.py:251-296)."""
    motions = tmp_path / "motions" / "walk"
    motions.mkdir(parents=True)
    tmd.save_motion_data(str(motions / "walk1.npz"),
                         tsyn.walking_clip(n=40, seed=1))
    tmd.save_motion_data(str(motions / "stand.npz"), tsyn.standing_clip(n=40))
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump(dict(
        MDM_SMALL, env_name="parkour", mgdm_num=2, plan_frames=4,
        ddim_stride=5, terrain_dim=20, actor_net="fc_2layers_512units",
        critic_net="fc_2layers_512units", steps_per_iter=4, update_epochs=1,
        test_steps=4, iters_per_sync_check=1)))
    ds = str(tmp_path / "dataset.yaml")
    cli.main(["create_dataset", "--motions_dir", str(tmp_path / "motions"),
              "--out", ds, "--device", "cpu"])
    out = tmp_path / "tracker"
    (tmp_path / "rank.py").write_text(CLI_CHILD)
    base = ["train_tracker", "--dataset", ds, "--out_dir", str(out),
            "--config", str(config), "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               RANK_TIMEOUT_S=str(RANK_TIMEOUT_S))
    for attempt in range(2):
        cmd = ([sys.executable, "-m", "torch.distributed.run",
                "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
                "--master_port", str(free_port()),
                str(tmp_path / "rank.py"), str(tmp_path)] + base
               + ["--num_envs", "4", "--max_iters", "2", "--dist_backend",
                  "gloo"])
        result = run_group([cmd], [env], timeout=180)
        if not (attempt == 0 and _rendezvous_failed(result)):
            break
    (rc, log), = result
    assert rc == 0, log[-8000:]
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
              for r in range(2))
    assert (r0["envs"], r0["mgdm"]) == (r1["envs"], r1["mgdm"]) == (2, 1)
    assert r0["replans"] == r1["replans"] and len(r0["replans"]) >= 2
    assert r0["saves"] == [2] and r1["saves"] == []
    assert r0["logs"] == [f"{out}/log.tsv"] and r1["logs"] == []
    assert (out / "log.tsv").exists()
    assert ckpt.all_steps(str(out / "checkpoints")) == [2]
    a, b = r0["end"], r1["end"]
    assert float(a["sample_count"]) == float(b["sample_count"]) == 2 * 4 * 4
    assert torch.equal(a["fail_rates"], b["fail_rates"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    saved = ckpt.restore(str(out / "checkpoints"))
    for k in a["params"]:
        assert torch.equal(saved["params"][k], a["params"][k]), k

    # rank 0's checkpoint resumes in one process with 6 envs (4 dm + 2 mgdm)
    state = cli.main(base + ["--num_envs", "6", "--max_iters", "3"])
    assert state.env_state.done.shape == (6,)
    assert float(state.sample_count) == 2 * 4 * 4 + 4 * 6
    assert ckpt.all_steps(str(out / "checkpoints")) == [2, 3]
