"""parc_torch.diffusion's MDM training (state conversion, losses,
gradients, train_step) against parc_tpu.diffusion at the small config of
tests/test_mdm.py, from one JAX state carried over by parc_torch.convert
(the sampling side: tests/test_torch_mdm_sampling.py). Dropout is 0 in
both stacks (flax's dropout masks come from JAX's generator); every other
draw the JAX package makes is drawn in JAX from its keys and handed to the
port.

Tolerances (f32):
- per-sample geometric losses and loss_fn's terms, given the JAX batch
  and draws: 1e-5 of the largest magnitude of the JAX value;
- every parameter's gradient: within 1e-4 of its largest JAX magnitude,
  with a floor of 1e-4 of the largest of any parameter (the key biases'
  gradient is zero in exact arithmetic, softmax being blind to them, and
  both stacks give rounding noise);
- one train_step, from a fresh state (adam count 0) and from a carried one
  (count 1): both adam moments within 1e-6 absolute; params and EMA params
  within 1e-6 absolute where the JAX first moment is above 1e-6 of the
  largest of any parameter, and within 2 lr where it is below (there the
  gradient is rounding noise, 1e-10 against 7e-3, and adam's normalized
  step turns noise into up to lr a step); the loss terms within 1e-5 of
  the total loss (the target term, 1 - cos near 0 averaged to 2e-6,
  cancels: relative to itself it moves by 6e-5).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from parc_tpu.diffusion import sampler as jsam
from parc_tpu.diffusion.mdm import MDM as JMDM
from parc_tpu.diffusion.mdm import MDMConfig as JCfg
from parc_tpu.diffusion.mdm import MDMState as JState
from parc_torch import convert
from parc_torch.diffusion import sampler as tsam
from parc_torch.diffusion.mdm import MDM as TMDM
from parc_torch.diffusion.mdm import LossDraws
from parc_torch.diffusion.mdm import MDMConfig as TCfg
from test_torch_diffusion import (SCFG, _close, _jax_boxes, _np, _t,
                                  boxes_to_port, build_libs,
                                  jax_batch_draws, jit)

torch.set_num_threads(1)

CFG = dict(diffusion_timesteps=51, batch_size=8, d_model=64, num_heads=4,
           d_hid=64, num_layers=2, ema_start=1, dropout=0.0)
B = 8


def _jax_loss(key, b, n, prev_shape, frame_shape):
    """The draws of JMDM.loss_fn(..., key) (its splits, k_cd split twice)."""
    k_t, k_n, k_cd, k_pn, _ = jax.random.split(key, 5)
    k1, k2, k3 = jax.random.split(k_cd, 3)
    k4, k5, k6 = jax.random.split(k_pn, 3)
    _, k8, _ = jax.random.split(k_cd, 3)
    return dict(
        t=jax.random.randint(k_t, (b,), 0, n),
        noise=jax.random.normal(k_n, frame_shape),
        u_hf=jax.random.uniform(k1, (b,)), u_target=jax.random.uniform(
            k2, (b,)), u_prev=jax.random.uniform(k3, (b,)),
        u_noised=jax.random.uniform(k4, (b,)),
        t_prev=jax.random.randint(k5, (b,), 0, n // 4),
        prev_noise=jax.random.normal(k6, prev_shape),
        ood_boxes=_jax_boxes(SCFG, k8, b, (-SCFG.max_h, SCFG.max_h), 0.75))


def jax_loss_draws(key, b=B):
    tree = jit(_jax_loss, static_argnums=(1, 2, 3, 4))(
        key, b, CFG["diffusion_timesteps"], (b, 2, 91), (b, 15, 91))
    out = {k: (boxes_to_port(v) if k == "ood_boxes" else
               _t(v, torch.long) if k.startswith("t") else _t(v))
           for k, v in tree.items()}
    return LossDraws(**out)


def _batch_to_port(batch):
    return tsam.WindowBatch(**{f: _t(getattr(batch, f)).to(
        torch.long if f == "motion_ids" else torch.float32)
        for f in tsam.WindowBatch.__dataclass_fields__})


def base_setup():
    """Both stacks from one fresh JAX state (the port's exact feature
    stats, flax's init): models, libraries, MDMs, the state, a function
    that carries a JAX state into a fresh port state, and ``sample(key)``,
    JAX's batch of the draws ``key`` makes, as the port samples it
    (tests/test_torch_diffusion.py holds the two samplers together)."""
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

    def sample(key):
        b = tsam.batch_from_draws(tmodel, SCFG, tlib, jax_batch_draws(
            SCFG, jlib, key, B))
        return jsam.WindowBatch(**{
            f: jnp.asarray(getattr(b, f).numpy()).astype(
                jnp.int32 if f == "motion_ids" else jnp.float32)
            for f in tsam.WindowBatch.__dataclass_fields__})

    def port_state(js):
        st = tmdm.init(tlib, torch.Generator().manual_seed(0),
                       stats_samples=8)
        return tmdm.merge_persistent(st, convert.mdm_state_from_numpy(
            _np(js)))

    return dict(jmodel=jmodel, jlib=jlib, tmodel=tmodel, tlib=tlib,
                jmdm=jmdm, tmdm=tmdm, s0=s0, sample=sample,
                port_state=port_state, batch=sample(jax.random.PRNGKey(2)))


@pytest.fixture(scope="module")
def setup():
    """base_setup() and the two JAX train_steps that follow its state.
    JAX's ``MDM.train_step`` (parc_tpu/diffusion/mdm.py:325-344) runs as
    its three pieces: the window sampler (its draws from JAX's key, the
    batch as the port builds it from them), the loss's value and gradient,
    and optax's update with the EMA."""
    d = base_setup()
    jmdm, sample = d["jmdm"], d["sample"]
    grad = jit(jax.value_and_grad(jmdm.loss_fn, has_aux=True))

    @jit
    def update(s, grads, rng):
        updates, opt_state = jmdm.tx.update(grads, s.opt_state, s.params)
        new = optax.apply_updates(s.params, updates)
        decay = jnp.where(s.step >= jmdm.cfg.ema_start, jmdm.cfg.ema_decay,
                          0.0)
        ema = jax.tree.map(lambda e, q: decay * e + (1 - decay) * q,
                           s.ema_params, new)
        return s.replace(params=new, ema_params=ema, opt_state=opt_state,
                         rng=rng, step=s.step + 1)

    def step(s):
        rng, k_batch, k_loss = jax.random.split(s.rng, 3)
        (total, losses), grads = grad(s.params, s, sample(k_batch), k_loss)
        return update(s, grads, rng), {"total": total, **losses}

    s1, m1 = step(d["s0"])  # adam count 1, EMA = params (ema_start 1)
    s2, m2 = step(s1)
    return dict(d, states=(d["s0"], s1, s2), metrics=(m1, m2), s1=s1,
                grad=grad)


def test_state_conversion(setup):
    """The carried state: params and EMA equal, adam's count is AdamW's
    step, the stats and the step carried."""
    s1, t = setup["s1"], setup["port_state"](setup["s1"])
    assert t.step == int(s1.step) == 1
    assert all(float(v["step"]) == 1.0 for v in t.optimizer.state.values())
    assert not np.allclose(np.asarray(convert.mdm_state_from_numpy(_np(s1))
                                      ["opt_state"]["exp_avg"]["pos_embed"]),
                           0.0)
    np.testing.assert_array_equal(t.mean.numpy(), np.asarray(s1.mean))
    assert len(t.optimizer.state) == len(list(t.net.parameters()))


def test_geometric_losses(setup):
    jm, tm, s1 = setup["jmdm"], setup["tmdm"], setup["s1"]
    ts = setup["port_state"](s1)
    batch = setup["batch"]
    rng = np.random.default_rng(9)
    pred = rng.normal(size=(B, 15, 91)).astype(np.float32)
    gt = np.asarray(jm._standardize(s1, batch.frames, batch.prev_states)[0])
    want = jit(jm._geometric_losses)(s1, pred, gt, batch)
    got = tm._geometric_losses(ts, _t(pred), _t(gt), _batch_to_port(batch))
    assert set(got) == set(want)
    assert float(np.max(np.asarray(want["hf_collision"]))) > 0
    for k in want:
        _close(got[k], want[k], 1e-5, k, rel=True)


def test_loss_fn_and_gradients(setup):
    jm, tm, s1 = setup["jmdm"], setup["tmdm"], setup["s1"]
    ts = setup["port_state"](s1)
    batch = setup["batch"]
    # a key whose draws hold an OOD row
    for seed in range(3, 100):
        key = jax.random.PRNGKey(seed)
        draws = jax_loss_draws(key)
        ood = draws.u_hf < jm.cfg.ood_chance
        if ood.any():
            break
    (jtot, jlosses), jgrads = setup["grad"](s1.params, s1, batch, key)
    # the reference's coupling: OOD rows are rows whose hf is dropped
    assert bool(ood.any()) and not bool((draws.u_hf[ood] > 0.1).any())
    ttot, tlosses = tm.loss_fn(ts.net, ts, _batch_to_port(batch), draws)
    _close(ttot, jtot, 1e-5, "total", rel=True)
    for k in jlosses:
        _close(tlosses[k], jlosses[k], 1e-5, k, rel=True)
    ttot.backward()
    want = convert.mdm_params_from_numpy(_np(jgrads))
    floor = 1e-4 * max(float(v.abs().max()) for v in want.values())
    for name, p in ts.net.named_parameters():
        tol = max(1e-4 * float(want[name].abs().max()), floor)
        _close(p.grad, want[name], tol, f"gradient {name}")


@pytest.mark.parametrize("start", [0, 1], ids=["fresh", "carried"])
def test_train_step(setup, start):
    """JAX's train_step against the port's from the same state and draws:
    the fresh state, and the one JAX's first step left (adam count 1,
    decay 0.99)."""
    tm = setup["tmdm"]
    js, jnext = setup["states"][start], setup["states"][start + 1]
    ts = setup["port_state"](js)
    _, k_batch, k_loss = jax.random.split(js.rng, 3)
    ts2, metrics = tm.train_step(
        setup["tlib"], ts, jax_batch_draws(SCFG, setup["jlib"], k_batch, B),
        jax_loss_draws(k_loss))
    assert ts2.step == start + 1
    jmetrics = setup["metrics"][start]
    for k, v in jmetrics.items():
        _close(metrics[k], v, 1e-5 * float(jmetrics["total"]), f"loss {k}")
    want = convert.mdm_state_from_numpy(_np(jnext))
    got = tm.persistent_state(ts2)
    assert got["opt_state"]["step"] == want["opt_state"]["step"] == start + 1
    mu = want["opt_state"]["exp_avg"]
    mu_max = max(float(v.abs().max()) for v in mu.values())
    noise = {k: v.abs() < 1e-6 * mu_max for k, v in mu.items()}
    lr = tm.cfg.lr
    for tree in ("params", "ema_params"):
        for name, v in want[tree].items():
            err = (got[tree][name] - v).abs()
            strict = torch.where(noise[name], torch.zeros_like(err), err)
            assert float(strict.max()) <= 1e-6, (tree, name)
            assert float(err.max()) <= 2 * lr, name
    for m in ("exp_avg", "exp_avg_sq"):
        for name, v in want["opt_state"][m].items():
            _close(got["opt_state"][m][name], v, 1e-6, f"{m} {name}")
    if start == 1:  # the EMA moved off the params
        assert not torch.equal(got["ema_params"]["pos_embed"],
                               got["params"]["pos_embed"])
