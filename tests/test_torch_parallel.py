"""parc_torch.parallel (data parallelism over torch.distributed) against the
JAX package's shard_map path (parc_tpu/parallel/mesh.py), on the CPU: two
gloo ranks, each a process started the way tests/test_distributed.py starts
its children, against ``make_mesh(2)`` over two of the test session's
virtual CPU devices.

The setup is tests/test_torch_ppo.py's deterministic one: one standing
clip, 8 envs in all (4 a rank), no random reset and no action noise, one
minibatch a PPO epoch (so the permutation does not matter), a normalizer
that has seen 256 spread samples, the elbows' bias past the action bound;
episodes end after 0.1 s, so envs finish and reset from the pool. Both
stacks start from the same persistent state and the same env state, rank r
taking its block of it.

Tolerances (tests/test_torch_ppo.py's and tests/test_torch_trainer.py's):
every train_iter metric at 1e-4 relative with a floor of 1e-4 of the
field's scale; the normalizer at 1e-5; the parameters' change at 1e-4 of
its largest magnitude plus 1e-6 of the parameter's; the momentum buffers
and the test rollout's statistics at 1e-4 of their scale; the fail rates
at 1e-6; the sharded rollout's mean reward at 1e-4. The two ranks'
parameters are bit-identical.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from parc_tpu.anim import motion_lib as jml
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.envs import base as jbase
from parc_tpu.envs import deepmimic as jdm
from parc_tpu.learning import normalizer as jnorm
from parc_tpu.learning import ppo as jppo
from parc_tpu.parallel import mesh as jmesh
from parc_tpu.physics import engine as je
from parc_tpu.pipeline import train_tracker as jtt
from parc_torch import convert
from parc_torch.anim import motion_lib as tml
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.envs import base as tbase
from parc_torch.envs import deepmimic as tdm
from parc_torch.learning import ppo as tppo
from parc_torch.physics import engine as te

torch.set_num_threads(1)

NET, N, T, W = "fc_2layers_512units", 8, 4, 2
ENV_KW = dict(num_envs=N, rand_reset=False, episode_length=0.1)
PPO_KW = dict(steps_per_iter=T, reset_pool_k=1, update_epochs=2,
              batch_size=8, exp_prob_beg=0.0, exp_prob_end=0.0,
              actor_net=NET, critic_net=NET)
TEST_STEPS, TEST_EPISODES, ROLL_STEPS = 6, 16, 5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one rank: every data-parallel piece of the port on its block, in turn
CHILD = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    from parc_torch.anim import motion_lib as ml
    from parc_torch.data.humanoid import humanoid_spec
    from parc_torch.data.synthetic import standing_clip
    from parc_torch.envs.base import EnvConfig
    from parc_torch.envs.deepmimic import DeepMimicEnv
    from parc_torch.learning import normalizer as norm_lib
    from parc_torch.learning import ppo
    from parc_torch.parallel import mesh
    from parc_torch.physics import engine
    from parc_torch.pipeline import train_tracker

    inp = torch.load(sys.argv[1], weights_only=False)
    info = mesh.init_distributed(backend="gloo", device="cpu")
    group, rank, world = mesh.default_group(), info.rank, info.world_size
    env = DeepMimicEnv(humanoid_spec().build(), engine.SimParams(),
                       EnvConfig(**inp["env_kw"]), device="cpu")
    agent = ppo.PPOAgent(env, ppo.PPOConfig(**inp["ppo_kw"]), device="cpu")
    lib = ml.build_motion_lib(env.model, [standing_clip()], device="cpu")
    local = mesh.local_agent(agent, world)
    state = local.init(lib, mesh.rank_generator(0, rank, "cpu"))
    agent.net = local.net
    state = ppo.merge_persistent(local, state, inp["start"])
    state = state.replace(env_state=mesh.local_block(
        env, inp["env_state"], rank, world))
    out = {"envs": state.env_state.done.shape[0]}

    gen = mesh.rank_generator(0, rank, "cpu")
    out["test"] = train_tracker.make_test_fn(
        local, inp["test_steps"], inp["test_episodes"], group=group)(
        lib, state, gen)
    roll = mesh.make_sharded_rollout(agent, group, inp["roll_steps"])
    out["rollout_reward"] = roll(lib, state.env_state, state.obs_norm,
                                 gen)[1]
    norm = norm_lib.update(state.obs_norm, inp["norm_batch"][rank],
                           group=group)
    out["norm"] = {f: getattr(norm, f) for f in ("mean", "var", "count")}
    params = list(agent.net.parameters())
    out["sync"] = mesh.check_param_sync(params, group)
    try:
        mesh.check_param_sync([p.detach() + 1e-3 * rank for p in params],
                              group)
        out["drift_caught"] = False
    except AssertionError:
        out["drift_caught"] = True

    train_iter = mesh.make_sharded_train_iter(agent, group)
    out["metrics"] = []
    for _ in range(2):
        state, m = train_iter(lib, state)
        out["metrics"].append(m)
    out["end"] = ppo.persistent_state(local, state)
    torch.save(out, f"{sys.argv[2]}/rank{rank}.pt")
    mesh.shutdown()
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script: str, args, world: int = W, timeout: float = 300):
    """Run ``script`` as ``world`` gloo ranks (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT set as torchrun sets them)."""
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, script, *map(str, args)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o}"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(x):
    x = x.numpy()
    return jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)


def _jax_env_state(es):
    """A JAX EnvState holding the port's EnvState ``es``."""
    sim = je.SimState(**{k: _jnp(v) for k, v in vars(es.sim).items()})
    rest = {k: _jnp(v) for k, v in vars(es).items() if k != "sim"}
    return jbase.EnvState(sim=sim, rng=jax.random.PRNGKey(0), **rest)


def _scaled_close(got, want, tol, msg):
    want = np.asarray(want, np.float64)
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.max(np.abs(want))),
                                              1e-6), err_msg=msg)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Both stacks through the same data-parallel pieces: JAX under
    shard_map on 2 devices, the port on 2 gloo ranks."""
    tmp = tmp_path_factory.mktemp("dp")
    jenv = jdm.DeepMimicEnv(jspec().build(), je.SimParams(),
                            jbase.EnvConfig(**ENV_KW))
    jagent = jppo.PPOAgent(jenv, jppo.PPOConfig(**PPO_KW))
    tenv = tdm.DeepMimicEnv(tspec().build(), te.SimParams(),
                            tbase.EnvConfig(**ENV_KW), device="cpu")
    tagent = tppo.PPOAgent(tenv, tppo.PPOConfig(**PPO_KW), device="cpu")
    tlib = tml.build_motion_lib(tenv.model, [tsyn.standing_clip()],
                                device="cpu")
    jlib = jml.MotionLib(**{k: _jnp(v) for k, v in vars(tlib).items()})
    tstate = tagent.init(tlib, torch.Generator().manual_seed(0))

    obs_dim = jenv.obs_dim
    params = jax.tree.map(np.array, jax.jit(jagent.net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, obs_dim))))
    params["params"]["actor_head"]["bias"][[9, 13]] = [1.1, -1.1]
    rng = np.random.default_rng(5)
    obs0 = tstate.env_state.obs[:1].numpy()
    spread = (obs0 * (1.0 + 0.5 * rng.normal(size=(256, obs_dim)))
              + rng.normal(size=(256, obs_dim))).astype(np.float32)
    mask = (~jenv.obs_layout.non_norm_mask()).astype(np.float32)
    jstate = jppo.AgentState(
        params=params, opt_state=jagent.tx.init(params),
        obs_norm=jnorm.update(jnorm.create(obs_dim, mask), spread),
        env_state=_jax_env_state(tstate.env_state),
        rng=jax.random.PRNGKey(0), sample_count=jnp.zeros(()))
    start = _np(jppo.persistent_state(jstate))
    norm_batch = (obs0 + rng.normal(size=(W, 16, obs_dim))).astype(
        np.float32)

    inp = tmp / "in.pt"
    torch.save(dict(env_kw=ENV_KW, ppo_kw=PPO_KW,
                    start=convert.persistent_from_numpy(start),
                    env_state=tstate.env_state,
                    norm_batch=torch.as_tensor(norm_batch),
                    test_steps=TEST_STEPS, test_episodes=TEST_EPISODES,
                    roll_steps=ROLL_STEPS), inp)
    script = tmp / "rank.py"
    script.write_text(CHILD)
    run_ranks(script, [inp, tmp])
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(W)]

    mesh = jmesh.make_mesh(W)
    state_spec = jmesh.agent_state_pspec(jstate, N)
    lib_spec = jax.tree.map(lambda _: P(), jlib)
    test_core = jtt.make_test_fn(jmesh.local_agent(jagent, W), TEST_STEPS,
                                 TEST_EPISODES, axis_name="data",
                                 n_shards=W)
    want_test = _np(jax.jit(shard_map(
        test_core, mesh=mesh, in_specs=(lib_spec, state_spec, P()),
        out_specs=P(), check_vma=False))(jlib, jstate,
                                         jax.random.PRNGKey(0)))
    roll = jmesh.make_sharded_rollout(jenv, jagent.net, jagent.a_mid,
                                      jagent.a_scale, mesh, jlib,
                                      jstate.env_state, ROLL_STEPS)
    want_reward = float(roll(jlib, jstate.env_state, jstate.params,
                             jstate.obs_norm)[1])
    want_norm = _np(jax.jit(shard_map(
        lambda b: jnorm.update(jstate.obs_norm, b, axis_name="data"),
        mesh=mesh, in_specs=(P("data"),), out_specs=P(),
        check_vma=False))(norm_batch.reshape(W * 16, obs_dim)))

    train = jmesh.make_sharded_train_iter(jagent, mesh, jlib, jstate)
    jmetrics = []
    for _ in range(2):
        jstate, m = train(jlib, jstate)
        jmetrics.append(_np(m))
    return dict(ranks=ranks, start=convert.persistent_from_numpy(start),
                jend=convert.persistent_from_numpy(
                    _np(jppo.persistent_state(jstate))),
                jmetrics=jmetrics, want_test=want_test,
                want_reward=want_reward, want_norm=want_norm)


@pytest.mark.parametrize("it", [0, 1])
def test_train_iter_metrics(dp, it):
    """The metrics (averaged over ranks, dones and fails summed) of both
    iterations, on both ranks."""
    jm = dp["jmetrics"][it]
    for r in dp["ranks"]:
        assert r["envs"] == N // W
        tm = r["metrics"][it]
        for f in tppo.TrainMetrics.__dataclass_fields__:
            _scaled_close(getattr(tm, f), getattr(jm, f), 1e-4, f)


def test_train_iter_state(dp):
    """Normalizer, sample count (2 x T x 8, summed over ranks), fail rates
    (averaged over ranks), parameters and momentum after two iterations."""
    start, jend = dp["start"], dp["jend"]
    tend = dp["ranks"][0]["end"]
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(tend["obs_norm"][f].numpy(),
                                   jend["obs_norm"][f].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    assert float(tend["sample_count"]) == float(jend["sample_count"]) \
        == 2 * T * N
    np.testing.assert_allclose(tend["fail_rates"].numpy(),
                               jend["fail_rates"].numpy(), atol=1e-6)
    moved = 0
    for k, p0 in start["params"].items():
        want = jend["params"][k] - p0
        np.testing.assert_allclose(
            (tend["params"][k] - p0).numpy(), want.numpy(), rtol=0,
            atol=1e-4 * float(want.abs().max()) + 1e-6 * float(p0.abs().max()),
            err_msg=k)
        moved += int(float(want.abs().max()) > 0)
        m_want = jend["opt_state"]["momentum"][k].numpy()
        np.testing.assert_allclose(
            tend["opt_state"]["momentum"][k].numpy(), m_want, rtol=0,
            atol=1e-4 * max(float(np.abs(m_want).max()), 1e-12),
            err_msg=f"momentum {k}")
    assert moved == len(start["params"])


def test_ranks_bit_identical(dp):
    """Every rank applies the same all-reduced gradients: the parameters,
    momentum buffers, normalizer and fail rates agree to the bit."""
    a, b = (r["end"] for r in dp["ranks"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
        assert torch.equal(a["opt_state"]["momentum"][k],
                           b["opt_state"]["momentum"][k]), k
    for f in ("mean", "var", "count"):
        assert torch.equal(a["obs_norm"][f], b["obs_norm"][f]), f
    assert torch.equal(a["fail_rates"], b["fail_rates"])


def test_normalizer_update_reduced(dp):
    """normalizer.update over a batch split across the ranks against
    ``psum`` under shard_map."""
    for r in dp["ranks"]:
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(r["norm"][f].numpy(),
                                       getattr(dp["want_norm"], f), rtol=1e-5,
                                       atol=1e-5, err_msg=f)


def test_check_param_sync(dp):
    """0 in sync; a 1e-3 drift on one rank raises on every rank
    (tests/test_multichip.py:90-113)."""
    for r in dp["ranks"]:
        assert r["sync"] == 0.0
        assert r["drift_caught"]


def test_test_rollout_reduced(dp):
    """The test rollout over both ranks' envs against
    ``make_test_fn(axis_name="data")`` under shard_map: episodes finish
    and reset inline; the stop test and the statistics are reduced."""
    want = dp["want_test"]
    for r in dp["ranks"]:
        got = r["test"]
        assert set(got) == set(want)
        assert int(got["test_steps"]) == int(want["test_steps"]) \
            == TEST_STEPS
        assert float(got["num_eps"]) == float(want["num_eps"]) \
            == TEST_EPISODES
        for k, w in want.items():
            _scaled_close(got[k], w, 1e-4, k)


def test_sharded_rollout_reward(dp):
    """The deterministic rollout's mean reward, averaged over the ranks,
    against ``make_sharded_rollout``."""
    for r in dp["ranks"]:
        np.testing.assert_allclose(float(r["rollout_reward"]),
                                   dp["want_reward"], rtol=1e-4, atol=1e-6)
