"""parc_torch.learning.vision_nets and envs.perception.hf_shape against
parc_tpu.learning.vision_nets / envs.perception, on the deepmimic env's
observation layout (1312 dims, the 7 x 63 ray cone last). flax's
parameters are carried across by parc_torch.convert.

Tolerances (f32): hf_shape equal; each net's action mean and value within
1e-5 of the largest JAX output; the fixed log-std equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.envs import base as jbase
from parc_tpu.envs import perception as jperc
from parc_tpu.envs.deepmimic import DeepMimicEnv as JEnv
from parc_tpu.learning import vision_nets as jvn
from parc_tpu.physics import engine as je
from parc_tpu.data.humanoid import humanoid_spec as jspec
from parc_torch import convert
from parc_torch.data import synthetic as tsyn
from parc_torch.anim import motion_lib as tml
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.envs import base as tbase
from parc_torch.envs import perception as tperc
from parc_torch.envs.deepmimic import DeepMimicEnv as TEnv
from parc_torch.learning import vision_nets as tvn
from parc_torch.learning.ppo import PPOAgent, PPOConfig
from parc_torch.physics import engine as te
from test_torch_diffusion import _close, _np, jit

torch.set_num_threads(1)

B = 5


@pytest.fixture(scope="module")
def envs():
    jenv = JEnv(jspec().build(), je.SimParams(), jbase.EnvConfig(num_envs=4))
    tenv = TEnv(tspec().build(device="cpu"), te.SimParams(), tbase.EnvConfig(num_envs=4),
                device="cpu")
    return jenv, tenv


@pytest.mark.parametrize("mode", jperc.MODES)
def test_hf_shape(mode):
    jcfg = jbase.EnvConfig(terrain_obs_mode=mode)
    tcfg = tbase.EnvConfig(terrain_obs_mode=mode)
    shape = tperc.hf_shape(tcfg)
    assert shape == jperc.hf_shape(jcfg)
    assert shape[0] * shape[1] == tperc.num_points(tcfg)
    if mode == "HF_RAY":
        assert shape == (7, 63)
    with pytest.raises(ValueError):
        tperc.hf_shape(tbase.EnvConfig(terrain_obs_mode="nope"))


def _forward(jnet, tcls, envs, seed, **kw):
    """flax init + apply at B observations, the port net with the carried
    weights on the same observations."""
    jenv, tenv = envs
    rng = np.random.default_rng(seed)
    obs = rng.normal(0, 1, (B, jenv.obs_dim)).astype(np.float32)
    params = jit(jnet.init)(jax.random.PRNGKey(seed),
                            jnp.zeros((1, jenv.obs_dim)))
    want = jit(jnet.apply)(params, obs)
    tnet = tcls(tenv.action_dim, tenv.obs_layout, tperc.hf_shape(tenv.cfg),
                device="cpu", **kw)
    sd = convert.flax_state_dict(_np(params))
    assert set(sd) == set(tnet.state_dict())
    tnet.load_state_dict(sd)
    with torch.no_grad():
        got = tnet(torch.as_tensor(obs))
    for g, w, name in zip(got, want, ("mean", "logstd", "value")):
        assert g.shape == w.shape, name
        _close(g, w, 1e-5, name, rel=True)
    return params, tnet


def test_dm_cnn_mlp(envs):
    jenv, _ = envs
    jnet = jvn.DMCnnMlp(action_dim=jenv.action_dim, layout=jenv.obs_layout,
                        hf_shape=jperc.hf_shape(jenv.cfg))
    params, tnet = _forward(jnet, tvn.DMCnnMlp, envs, 0)
    assert tnet.tokenizer.num_tokens == 49
    # the first trunk layer meets the 49 x 128 hf features after the rest
    k = np.asarray(params["params"]["Dense_0"]["kernel"])
    assert k.shape == (1312 - 441 + 49 * 128, 1024)


def test_dm_vit(envs):
    jenv, _ = envs
    jnet = jvn.DMViT(action_dim=jenv.action_dim, layout=jenv.obs_layout,
                     hf_shape=jperc.hf_shape(jenv.cfg))
    params, tnet = _forward(jnet, tvn.DMViT, envs, 1)
    assert tnet.pos.shape == (1 + 4 + 49, 256)
    assert np.asarray(params["params"]["pos"]).shape == (54, 256)


@pytest.mark.parametrize("net", ["dm_cnn_mlp", "dm_vit"])
def test_ppo_agent_builds_vision_net(envs, net):
    """PPOAgent builds the vision policy of actor_net (f32 on the CPU),
    drawing its weights from the init generator; one act and one loss
    with its gradient."""
    _, tenv = envs
    lib = tml.build_motion_lib(tenv.model, [tsyn.standing_clip()],
                               device="cpu")
    agent = PPOAgent(tenv, PPOConfig(actor_net=net), device="cpu")
    state = agent.init(lib, torch.Generator().manual_seed(0))
    cls = tvn.DMCnnMlp if net == "dm_cnn_mlp" else tvn.DMViT
    assert isinstance(agent.net, cls) and agent.net.compute_dtype is None
    state_dict = {k: p.clone() for k, p in agent.net.state_dict().items()}
    a = agent.act(state, state.env_state.obs)
    assert a.shape == (4, 28) and torch.isfinite(a).all()
    norm_obs = torch.randn(4, tenv.obs_dim, generator=torch.Generator()
                           .manual_seed(1))
    loss, aux = agent._loss(norm_obs, torch.zeros(4, 28), torch.zeros(4),
                            torch.ones(4), torch.ones(4), torch.ones(4))
    loss.backward()
    grads = [p.grad for p in agent.net.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    # the weights come from the init generator alone
    again = PPOAgent(tenv, PPOConfig(actor_net=net), device="cpu")
    again.init(lib, torch.Generator().manual_seed(0))
    for k, p in again.net.state_dict().items():
        assert torch.equal(p, state_dict[k]), k
