"""parc_torch.diffusion.transformer (the MDM's denoiser) against the flax
MDMTransformer at the small config of tests/test_mdm.py (d_model 64, 4
heads, d_hid 64, 2 layers), the flax weights carried over by
parc_torch.convert.mdm_params_from_numpy.

Tolerance: the deterministic forward at 2e-5 of the output's largest
magnitude (f32), with and without the condition cache, every mask, the
prev-state noise flag; the condition tokens likewise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_tpu.diffusion.transformer import MDMTransformer as JNet
from parc_torch import convert
from parc_torch.diffusion.transformer import MDMTransformer as TNet
from test_torch_diffusion import SCFG, _close, _np, _t, jit

torch.set_num_threads(1)

SMALL = dict(d_model=64, num_heads=4, d_hid=64, num_layers=2)
B = 16


def jax_net(key, **kw):
    """A flax denoiser at the small config, its params, and the port's."""
    net = JNet(frame_dim=SCFG.frame_dim(jspec().build()), **{**SMALL, **kw})
    params = jit(net.init)(key, jnp.zeros((1, 15, net.frame_dim)),
                           jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, 2, net.frame_dim)),
                           jnp.zeros((1, 31, 31)), jnp.zeros((1, 2)))
    tnet = TNet(frame_dim=net.frame_dim, **{**SMALL, **kw}, device="cpu")
    tnet.load_state_dict(convert.mdm_params_from_numpy(_np(params)))
    return net, params, tnet


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nets():
    return jax_net(jax.random.PRNGKey(7))


def _net_inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(x_t=f(B, 15, 91), t=rng.integers(0, 51, (B,)),
                prev_states=f(B, 2, 91), hf=0.3 * f(B, 31, 31),
                target_dir=f(B, 2),
                hf_mask=(rng.random(B) > 0.3).astype(np.float32),
                target_mask=(rng.random(B) > 0.3).astype(np.float32),
                prev_state_mask=(rng.random(B) > 0.3).astype(np.float32),
                prev_state_noised=(rng.random(B) > 0.5).astype(np.float32))


@pytest.mark.parametrize("case", ["plain", "masks", "noised", "cond_toks"])
def test_transformer_forward(nets, case):
    net, params, tnet = nets
    x = _net_inputs(8)
    keys = {"plain": (), "masks": ("hf_mask", "target_mask",
                                   "prev_state_mask"),
            "noised": ("prev_state_noised",),
            "cond_toks": ("hf_mask", "target_mask", "prev_state_mask",
                          "prev_state_noised")}[case]
    cond = ("prev_states", "hf", "target_dir") + keys
    tx = {k: _t(v) for k, v in x.items()}
    if case == "cond_toks":
        jc = jit(lambda p, c: net.apply(p, **c,
                                            method="encode_conditions"))(
            params, {k: x[k] for k in cond})
        tc = tnet.encode_conditions(**{k: tx[k] for k in cond})
        _close(tc, jc, 2e-5, "condition tokens", rel=True)
        want = jit(lambda p, a, t, c: net.apply(p, a, t, cond_toks=c))(
            params, x["x_t"], x["t"], jc)
        got = tnet(tx["x_t"], tx["t"], cond_toks=tc)
    else:
        want = jit(lambda p, a, t, c: net.apply(p, a, t, **c))(
            params, x["x_t"], x["t"], {k: x[k] for k in cond})
        got = tnet(tx["x_t"], tx["t"], **{k: tx[k] for k in cond})
    assert got.dtype == torch.float32
    _close(got, want, 2e-5, case, rel=True)


def test_param_count_and_names(nets):
    """Every flax parameter lands in the port's state_dict, and the full
    configuration has the ~43 M parameters of the JAX package's."""
    _, params, tnet = nets
    n_flax = sum(np.asarray(v).size for v in jax.tree.leaves(params))
    assert sum(p.numel() for p in tnet.parameters()) == n_flax
    full = TNet(frame_dim=91, device="meta")
    assert 40e6 < sum(p.numel() for p in full.parameters()) < 46e6
