"""parc_torch.parallel (data parallelism over torch.distributed) on the
CPU: two gloo ranks, each a process started the way
tests/test_distributed.py starts its children, against the port's own
one-process path on the whole batch (data parallelism splits the batch
and reduces over it, so the two agree up to rounding). That path is held
against the JAX package at the same tolerances by the tests named below,
so nothing here compiles the JAX package's shard_map path:
- train_iter's metrics and state: tests/test_torch_ppo.py
  (test_train_iter_metrics, test_train_iter_state), the same setup;
- the test rollout: tests/test_torch_trainer.py::test_make_test_fn;
- the normalizer update: tests/test_torch_networks.py::test_normalizer;
- the deterministic rollout's steps: tests/test_torch_slice.py.

The setup is tests/test_torch_ppo.py's deterministic one: one standing
clip, 8 envs in all (4 a rank), no random reset and no action noise, one
minibatch a PPO epoch (so the permutation does not matter), a normalizer
that has seen 256 spread samples, the elbows' bias past the action bound;
episodes end after 0.1 s, so envs finish and reset from the pool. Both
runs start from the same persistent state and the same env state, rank r
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
import signal
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.envs import base as jbase
from parc_tpu.envs import deepmimic as jdm
from parc_tpu.learning import normalizer as jnorm
from parc_tpu.learning import ppo as jppo
from parc_tpu.physics import engine as je
from parc_torch import convert
from parc_torch.anim import motion_lib as tml
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.envs import base as tbase
from parc_torch.envs import deepmimic as tdm
from parc_torch.learning import normalizer as tnorm
from parc_torch.learning import ppo as tppo
from parc_torch.parallel import mesh as tmesh
from parc_torch.physics import engine as te
from parc_torch.pipeline import train_tracker as ttt

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
    info = mesh.init_distributed(backend="gloo", device="cpu",
                                 timeout_s=inp["timeout_s"])
    group, rank, world = mesh.default_group(), info.rank, info.world_size
    env = DeepMimicEnv(humanoid_spec().build(device="cpu"), engine.SimParams(),
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


# a gloo rank waits this long for the group and for each collective; the
# ranks of these tests reach every collective within seconds of each other
RANK_TIMEOUT_S = 60
# what a rank prints when the group never formed (a port another group
# took between free_port and the bind, or a rank that died early)
RENDEZVOUS_ERRORS = ("address already in use", "eaddrinuse",
                     "connection refused", "timed out", "timeout",
                     "rendezvous")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(cmds, envs, timeout: float):
    """Run the processes ``cmds`` (each in a process group of its own) to
    their end; on a timeout or a failure kill every one of them, with its
    children, before returning. Returns [(returncode, output)]."""
    procs = [subprocess.Popen(c, env=e, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True)
             for c, e in zip(cmds, envs)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 0.1)
            try:
                outs.append(p.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                outs.append(f"(killed after {timeout:.0f} s)")
                break
            if p.returncode != 0:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    outs += [p.communicate()[0] or "" for p in procs[len(outs):]]
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _rendezvous_failed(results) -> bool:
    return any(rc != 0 and any(e in o.lower() for e in RENDEZVOUS_ERRORS)
               for rc, o in results)


def run_ranks(script: str, args, world: int = W, timeout: float = 120):
    """Run ``script`` as ``world`` gloo ranks (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT set as torchrun sets them); every
    rank is killed on a timeout or when one fails, and a group that never
    formed is tried once more on a fresh port."""
    for attempt in range(2):
        port = free_port()
        envs = [dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                     LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                     PYTHONPATH=REPO) for r in range(world)]
        results = run_group([[sys.executable, str(script), *map(str, args)]]
                            * world, envs, timeout)
        if attempt == 0 and _rendezvous_failed(results):
            continue
        for r, (rc, o) in enumerate(results):
            assert rc == 0, f"rank {r} failed:\n{o}"
        return


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
    """The port on 2 gloo ranks and in one process on the whole batch,
    from one start (the JAX package's initial parameters and normalizer,
    as tests/test_torch_ppo.py starts)."""
    tmp = tmp_path_factory.mktemp("dp")
    jenv = jdm.DeepMimicEnv(jspec().build(), je.SimParams(),
                            jbase.EnvConfig(**ENV_KW))
    jagent = jppo.PPOAgent(jenv, jppo.PPOConfig(**PPO_KW))
    tenv = tdm.DeepMimicEnv(tspec().build(device="cpu"), te.SimParams(),
                            tbase.EnvConfig(**ENV_KW), device="cpu")
    tagent = tppo.PPOAgent(tenv, tppo.PPOConfig(**PPO_KW), device="cpu")
    tlib = tml.build_motion_lib(tenv.model, [tsyn.standing_clip()],
                                device="cpu")
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
    start = convert.persistent_from_numpy(
        _np(jppo.persistent_state(jstate)))
    norm_batch = (obs0 + rng.normal(size=(W, 16, obs_dim))).astype(
        np.float32)

    inp = tmp / "in.pt"
    torch.save(dict(env_kw=ENV_KW, ppo_kw=PPO_KW, start=start,
                    env_state=tstate.env_state,
                    norm_batch=torch.as_tensor(norm_batch),
                    test_steps=TEST_STEPS, test_episodes=TEST_EPISODES,
                    roll_steps=ROLL_STEPS, timeout_s=RANK_TIMEOUT_S), inp)
    script = tmp / "rank.py"
    script.write_text(CHILD)
    run_ranks(script, [inp, tmp])
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(W)]

    # the one process on all N envs, as each rank runs its block
    one = tppo.merge_persistent(tagent, tstate, start)
    gen = torch.Generator().manual_seed(0)
    test = ttt.make_test_fn(tagent, TEST_STEPS, TEST_EPISODES)(tlib, one,
                                                                 gen)
    reward = tmesh.make_sharded_rollout(tagent, None, ROLL_STEPS)(
        tlib, one.env_state, one.obs_norm, gen)[1]
    norm = tnorm.update(one.obs_norm, torch.as_tensor(
        norm_batch.reshape(W * 16, obs_dim)))
    metrics = []
    for _ in range(2):
        one, m = tagent.train_iter(tlib, one)
        metrics.append(m)
    return dict(ranks=ranks, start=start,
                end=tppo.persistent_state(tagent, one), metrics=metrics,
                test=test, reward=float(reward), norm=norm)


@pytest.mark.parametrize("it", [0, 1])
def test_train_iter_metrics(dp, it):
    """The metrics (averaged over ranks, dones and fails summed) of both
    iterations, on both ranks, against the one process's."""
    jm = dp["metrics"][it]
    for r in dp["ranks"]:
        assert r["envs"] == N // W
        tm = r["metrics"][it]
        for f in tppo.TrainMetrics.__dataclass_fields__:
            _scaled_close(getattr(tm, f), getattr(jm, f), 1e-4, f)


def test_train_iter_state(dp):
    """Normalizer, sample count (2 x T x 8, summed over ranks), fail rates
    (averaged over ranks), parameters and momentum after two iterations,
    against the one process's."""
    start, jend = dp["start"], dp["end"]
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
    """normalizer.update over a batch split across the ranks against the
    update on the whole batch."""
    for r in dp["ranks"]:
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(r["norm"][f].numpy(),
                                       getattr(dp["norm"], f).numpy(),
                                       rtol=1e-5,
                                       atol=1e-5, err_msg=f)


def test_check_param_sync(dp):
    """0 in sync; a 1e-3 drift on one rank raises on every rank
    (tests/test_multichip.py:90-113)."""
    for r in dp["ranks"]:
        assert r["sync"] == 0.0
        assert r["drift_caught"]


def test_test_rollout_reduced(dp):
    """The test rollout over both ranks' envs against the one process's
    over all envs: episodes finish and reset inline; the stop test and the
    statistics are reduced."""
    want = dp["test"]
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
    against the one process's over all envs."""
    for r in dp["ranks"]:
        np.testing.assert_allclose(float(r["rollout_reward"]),
                                   dp["reward"], rtol=1e-4, atol=1e-6)
