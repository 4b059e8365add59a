"""parc_torch.learning (distributions, TD(lambda), PPO's loss and
train_iter) against parc_tpu.learning, with the flax weights and the optax
state carried over by parc_torch.convert.

Tolerances:
- distributions: 1e-5 (f32 elementwise sums over 28 dims);
- TD(lambda): rtol/atol 1e-4 against the JAX function and the brute-force
  oracle (the tolerance of tests/test_ppo.py);
- the loss, each aux term and every parameter's gradient: 1e-4 of the
  largest magnitude of the JAX value (f32 matmuls over 2x512 trunks, summed
  in another order);
- two whole train_iters: every metric at 1e-4 (relative, with an absolute
  floor of 1e-4 of the field's scale), the normalizer at 1e-5, the params'
  change from their start at 1e-4 of the change's largest magnitude (plus
  1e-6 of the parameter's, a few f32 steps of it), the
  momentum buffers at 1e-4 of theirs (8 control steps of physics feed the
  batches: the sim state agrees at 2e-4, tests/test_torch_slice.py, and
  longer rollouts of these states drift past it).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.anim import motion_lib as jml
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.envs import base as jbase
from parc_tpu.envs import deepmimic as jdm
from parc_tpu.learning import distributions as jdist
from parc_tpu.learning import normalizer as jnorm
from parc_tpu.learning import ppo as jppo
from parc_tpu.learning import rl_util as jrl
from parc_tpu.physics import engine as je
from parc_torch import convert
from parc_torch.anim import motion_lib as tml
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.envs import base as tbase
from parc_torch.envs import deepmimic as tdm
from parc_torch.envs.base import DoneFlags
from parc_torch.learning import distributions as tdist
from parc_torch.learning import ppo as tppo
from parc_torch.learning import rl_util as trl
from parc_torch.physics import engine as te

from test_torch_diffusion import jit

torch.set_num_threads(1)

NET, N, T, ACT = "fc_2layers_512units", 8, 4, 28


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol, msg=""):
    """|got - want| <= tol * max(|want|, tiny)."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gauss():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(mean0=f(16, ACT), logstd0=0.3 * f(16, ACT), mean1=f(16, ACT),
                logstd1=0.3 * f(16, ACT), act=f(16, ACT), logits0=f(16, 7),
                logits1=f(16, 7), cat=rng.integers(0, 7, 16))


def test_gaussian(gauss):
    g = gauss
    cases = [
        (tdist.log_prob, jdist.log_prob, ("mean0", "logstd0", "act")),
        (tdist.entropy, jdist.entropy, ("logstd0",)),
        (tdist.kl, jdist.kl, ("mean0", "logstd0", "mean1", "logstd1")),
        (tdist.mode, jdist.mode, ("mean0", "logstd0")),
    ]
    for tf, jf, keys in cases:
        got = tf(*(_t(g[k]) for k in keys))
        want = jf(*(jnp.asarray(g[k]) for k in keys))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=tf.__name__)
    # a sample draws from the generator around the mean at exp(logstd)
    gen = torch.Generator().manual_seed(0)
    mean, logstd = torch.zeros(20000, 2), torch.full((20000, 2), np.log(0.5))
    s = tdist.sample(gen, mean, logstd)
    assert abs(float(s.std()) - 0.5) < 0.01 and abs(float(s.mean())) < 0.01


def test_categorical(gauss):
    g = gauss
    cases = [
        (tdist.categorical_log_prob, jdist.categorical_log_prob,
         ("logits0", "cat")),
        (tdist.categorical_entropy, jdist.categorical_entropy, ("logits0",)),
        (tdist.categorical_kl, jdist.categorical_kl, ("logits0", "logits1")),
    ]
    for tf, jf, keys in cases:
        got = tf(*(_t(g[k]) for k in keys))
        want = jf(*(jnp.asarray(g[k]) for k in keys))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=tf.__name__)
    logits = _t(g["logits0"])
    assert torch.equal(tdist.categorical_mode(logits),
                       _t(jdist.categorical_mode(jnp.asarray(g["logits0"]))))
    # the sampled frequencies follow softmax(logits)
    gen = torch.Generator().manual_seed(1)
    draws = tdist.categorical_sample(gen, logits[0].expand(20000, 7))
    freq = torch.bincount(draws, minlength=7).float() / 20000
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(logits[0], -1).numpy(),
                               atol=0.015)


# ---------------------------------------------------------------------------
# TD(lambda)
# ---------------------------------------------------------------------------


def _brute_force_td_lambda(r, next_vals, done, discount, td_lambda):
    """Independent oracle (tests/test_ppo.py): the lambda-weighted mixture
    of n-step returns, truncated at the first done (which bootstraps
    through next_vals)."""
    t_len, b_len = r.shape
    out = np.zeros_like(r)
    for b in range(b_len):
        for t in range(t_len):
            m = t
            while m < t_len - 1 and done[m, b] == DoneFlags.NULL:
                m += 1
            steps = m - t + 1
            total = 0.0
            for n in range(1, steps + 1):
                g_n = sum(discount ** k * r[t + k, b] for k in range(n))
                g_n += discount ** n * next_vals[t + n - 1, b]
                w = (td_lambda ** (n - 1) if n == steps
                     else (1 - td_lambda) * td_lambda ** (n - 1))
                total += w * g_n
            out[t, b] = total
    return out


def test_td_lambda():
    rng = np.random.default_rng(0)
    r = rng.uniform(0, 1, (8, 4)).astype(np.float32)
    nv = rng.uniform(0, 5, (8, 4)).astype(np.float32)
    done = np.zeros((8, 4), np.int64)
    done[3, 0] = DoneFlags.FAIL
    done[5, 2] = DoneFlags.TIME
    done[1, 3] = DoneFlags.TIME
    done[2, 3] = DoneFlags.FAIL
    got = trl.compute_td_lambda_return(_t(r), _t(nv), _t(done), 0.99,
                                       0.95).numpy()
    want_j = np.asarray(jrl.compute_td_lambda_return(
        jnp.asarray(r), jnp.asarray(nv), jnp.asarray(done, jnp.int32), 0.99,
        0.95))
    want_o = _brute_force_td_lambda(r, nv, done, 0.99, 0.95)
    np.testing.assert_allclose(got, want_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want_o, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the PPO loss and its gradients
# ---------------------------------------------------------------------------


def _agents(env_cfg, ppo_cfg):
    jenv = jdm.DeepMimicEnv(jspec().build(), je.SimParams(), env_cfg[0])
    tenv = tdm.DeepMimicEnv(tspec().build(device="cpu"), te.SimParams(), env_cfg[1],
                            device="cpu")
    return (jppo.PPOAgent(jenv, jppo.PPOConfig(**ppo_cfg)),
            tppo.PPOAgent(tenv, tppo.PPOConfig(**ppo_cfg), device="cpu"))


@pytest.fixture(scope="module")
def loss_setup():
    kw = dict(num_envs=4)
    jagent, tagent = _agents((jbase.EnvConfig(**kw), tbase.EnvConfig(**kw)),
                             dict(actor_net=NET, critic_net=NET))
    obs_dim = jagent.env.obs_dim
    params = jagent.net.init(jax.random.PRNGKey(0), jnp.zeros((1, obs_dim)))
    rng = np.random.default_rng(3)
    # perturb every weight so the actor head and the logits are not tiny
    params = jax.tree.map(lambda p: np.asarray(p) + rng.normal(
        0, 0.02, np.shape(p)).astype(np.float32), params)
    b = 64
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    norm_obs = f(b, obs_dim)
    mean, logstd = jagent.net.apply(params, norm_obs, method="actor")
    norm_a = np.asarray(mean) + 0.05 * f(b, ACT)
    old_logp = np.asarray(jdist.log_prob(mean, logstd, norm_a)) + 0.1 * f(b)
    batch = dict(norm_obs=norm_obs, norm_a=norm_a, old_logp=old_logp,
                 adv=f(b), tar_val=f(b),
                 rand_mask=(rng.uniform(size=b) < 0.6).astype(np.float32))
    tagent.net.load_state_dict(convert.flax_state_dict(_np(params)))
    grad_fn = jit(jax.grad(jagent._loss, has_aux=True))
    loss_fn = jit(jagent._loss)
    return jagent, tagent, params, batch, grad_fn, loss_fn


@pytest.mark.parametrize("tar_scale", [1.0, 100.0],
                         ids=["critic_trusted", "critic_guarded"])
def test_loss_and_grads(loss_setup, tar_scale):
    jagent, tagent, params, batch, grad_fn, loss_fn = loss_setup
    batch = dict(batch, tar_val=batch["tar_val"] * tar_scale)
    keys = ("norm_obs", "norm_a", "old_logp", "adv", "tar_val", "rand_mask")
    args = [jnp.asarray(batch[k]) for k in keys]
    want_loss, want_aux = loss_fn(params, *args)
    grads, _ = grad_fn(params, *args)
    tagent.net.zero_grad(set_to_none=True)
    loss, aux = tagent._loss(*(_t(batch[k]) for k in keys))
    loss.backward()
    guarded = float(want_aux["critic_loss"]) > jagent.cfg.critic_loss_guard
    assert guarded == (tar_scale > 1.0)
    _close(loss, want_loss, 1e-4, "loss")
    for k in ("actor_loss", "critic_loss", "bound_loss", "clip_frac"):
        _close(aux[k], want_aux[k], 1e-4, k)
    want_grads = convert.flax_state_dict(_np(grads))
    got_grads = {k: p.grad for k, p in tagent.net.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for k, g in got_grads.items():
        _close(g, want_grads[k], 1e-4, k)


# ---------------------------------------------------------------------------
# two whole train_iters
# ---------------------------------------------------------------------------

def _jnp(x):
    """A JAX array of a port tensor (int64 indices become int32)."""
    x = x.numpy()
    return jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)


def _jax_env_state(es):
    """A JAX EnvState holding the port's EnvState ``es``."""
    sim = je.SimState(**{k: _jnp(v) for k, v in vars(es.sim).items()})
    rest = {k: _jnp(v) for k, v in vars(es).items() if k != "sim"}
    return jbase.EnvState(sim=sim, rng=jax.random.PRNGKey(0), **rest)


TRAIN_PPO = dict(steps_per_iter=T, reset_pool_k=1, update_epochs=2,
                 batch_size=8, exp_prob_beg=0.0, exp_prob_end=0.0,
                 actor_net=NET, critic_net=NET)


@pytest.fixture(scope="module")
def trained():
    """Both stacks from the same persistent state through two train_iters:
    one standing clip, 8 envs, no random reset and no action noise, so the
    rollouts are deterministic; one minibatch of the whole batch, so the
    permutation does not matter. The elbows' action dims of the actor
    head's bias sit past the action bound, so the bound loss drives the
    actor too (without noise the actor loss has no weight). The normalizer
    starts from 256 spread samples: the 8 envs are identical, and the
    batch's own variance alone would leave dims at the 1e-5 floor, where
    normalizing multiplies f32 differences by 300. The port's reset state
    and motion library are carried into the JAX state (no eager JAX build
    or JAX reset to compile); one JAX
    train_iter compile: the state's leaves keep their types across
    iterations."""
    kw = dict(num_envs=N, rand_reset=False)
    jagent, tagent = _agents((jbase.EnvConfig(**kw), tbase.EnvConfig(**kw)),
                             TRAIN_PPO)
    tlib = tml.build_motion_lib(tagent.env.model, [tsyn.standing_clip()],
                                device="cpu")
    jlib = jml.MotionLib(**{k: _jnp(v) for k, v in vars(tlib).items()})
    tstate = tagent.init(tlib, torch.Generator().manual_seed(0))

    obs_dim = jagent.env.obs_dim
    params = jax.tree.map(np.array, jit(jagent.net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, obs_dim))))
    params["params"]["actor_head"]["bias"][[9, 13]] = [1.1, -1.1]
    rng = np.random.default_rng(5)
    obs0 = tstate.env_state.obs[:1].numpy()
    spread = (obs0 * (1.0 + 0.5 * rng.normal(size=(256, obs_dim)))
              + rng.normal(size=(256, obs_dim))).astype(np.float32)
    mask = (~jagent.env.obs_layout.non_norm_mask()).astype(np.float32)
    jstate = jppo.AgentState(
        params=params, opt_state=jagent.tx.init(params),
        obs_norm=jnorm.update(jnorm.create(obs_dim, mask), spread),
        env_state=_jax_env_state(tstate.env_state),
        rng=jax.random.PRNGKey(0), sample_count=jnp.zeros(()))
    start = _np(jppo.persistent_state(jstate))
    tstate = convert.agent_state_from_numpy(tagent, tstate, start)

    train_j = jit(lambda s: jagent.train_iter(jlib, s))
    jmetrics, tmetrics = [], []
    for _ in range(2):
        jstate, m = train_j(jstate)
        jmetrics.append(_np(m))
        tstate, m = tagent.train_iter(tlib, tstate)
        tmetrics.append(m)
    return dict(start=convert.persistent_from_numpy(start),
                jend=convert.persistent_from_numpy(
                    _np(jppo.persistent_state(jstate))),
                tend=tppo.persistent_state(tagent, tstate),
                jmetrics=jmetrics, tmetrics=tmetrics)


@pytest.mark.parametrize("it", [0, 1])
def test_train_iter_metrics(trained, it):
    jm, tm = trained["jmetrics"][it], trained["tmetrics"][it]
    for f in tppo.TrainMetrics.__dataclass_fields__:
        want = np.asarray(getattr(jm, f), np.float64)
        got = getattr(tm, f).double().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * max(np.max(np.abs(want)), 1.0),
                                   err_msg=f)


def test_train_iter_state(trained):
    start, jend, tend = trained["start"], trained["jend"], trained["tend"]
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
        # f32 holds a parameter to 6e-8 of its value: a change smaller than
        # 1e-4 of the largest one is compared at that resolution
        np.testing.assert_allclose(
            (tend["params"][k] - p0).numpy(), want.numpy(), rtol=0,
            atol=1e-4 * float(want.abs().max()) + 1e-6 * float(p0.abs().max()),
            err_msg=k)
        moved += int(float(want.abs().max()) > 0)
        _close(tend["opt_state"]["momentum"][k],
               jend["opt_state"]["momentum"][k], 1e-4, f"momentum {k}")
    # the critic, the actor trunk and the actor head all learned
    assert moved == len(start["params"])
