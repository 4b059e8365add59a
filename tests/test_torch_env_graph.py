"""The env step split at the physics (``_physics``, then the post-physics
chain ``_after_physics``) and the chain's CUDA graph (envs/step_graph.py),
for ``DeepMimicEnv`` and ``ParkourEnv`` on the two-clip library of
tests/test_torch_envs.py (the parkour env with 2 mgdm rows of the small MDM
of tests/test_torch_parkour.py on a 32 x 32 platform).

On the CPU: the chain called on its own after the physics is the step, bit
for bit, on the pool path and the generator path; a pooled rollout never
engages the graph; the allowed-contact mask is built once, as the step used
to build it; the grid index's host bounds clamp as the tensor bounds did.

On the card (``cuda``-marked, skipped without one; no JAX there: run them
with ``python -m pytest tests/test_torch_env_graph.py -m cuda
--noconftest``): 40 pooled steps graphed against the same steps eager, bit
for bit but the fail rates (1e-6: ``index_add_``'s atomics); a reset pool
rebuilt between iterations read by the next replay; a new lib captured
again; a step's returned tensors unchanged by the next replays; a
class-level patch of ``_compute_reward`` made before the first step
showing in the graphed rewards; a rollout replaying every step."""

import numpy as np
import pytest
import torch

from parc_torch.anim import motion_lib as tml
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec
from parc_torch.diffusion.mdm import MDM, MDMConfig
from parc_torch.envs import base as tbase
from parc_torch.envs import deepmimic as tdm
from parc_torch.envs import mgdm as tmg
from parc_torch.envs import parkour as tpk
from parc_torch.envs import step_graph
from parc_torch.envs.base import DoneFlags
from parc_torch.learning.ppo import PPOAgent, PPOConfig
from parc_torch.physics import engine as te
from parc_torch.utils import terrain as terrain_lib

torch.set_num_threads(1)

N = 6
MDM_CFG = dict(diffusion_timesteps=11, d_model=32, num_heads=2, d_hid=32,
               num_layers=1)
PCFG = dict(plan_frames=4, ddim_stride=5)
KINDS = ("deepmimic", "parkour")


def _clips(speed=1.4):
    return [tsyn.standing_clip(), tsyn.walking_clip(seed=1, speed=speed)]


def _setup(kind, device, n, mgdm_num=2, **env_kw):
    """The env and the lib its step takes (the parkour env's bundle)."""
    model = humanoid_spec().build(device=device)
    lib = tml.build_motion_lib(model, _clips(), device=device)
    cfg = tbase.EnvConfig(num_envs=n, **env_kw)
    if kind == "deepmimic":
        return tdm.DeepMimicEnv(model, te.SimParams(), cfg, device=device), lib
    mdm = MDM(model, MDMConfig(**MDM_CFG), device=device)
    mdm_state = mdm.init(lib, torch.Generator(device=device).manual_seed(0),
                         stats_samples=8)
    env = tpk.ParkourEnv(
        model, te.SimParams(), cfg,
        tpk.ParkourConfig(mgdm_num=mgdm_num, **PCFG), mdm,
        tmg.make_platform_terrain(np.random.default_rng(0), dim=32,
                                  device=device), device=device)
    return env, env.make_lib(lib, mdm_state)


def _start(env, lib, device, seed=0, late=2):
    """A reset state whose every ``late``-th env is past the episode's end
    (it times out at the next step), and its generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    state = env.reset(lib, g)
    n = state.done.shape[0]
    late_rows = (torch.arange(n, device=device) % late) == 0
    return state.replace(time=state.time + 100.0 * late_rows), g


def _eager(env, bundle, state, act, pool, slot, g):
    """What ``step`` does, with the chain called eagerly on its own."""
    lib = bundle
    if isinstance(env, tpk.ParkourEnv):
        lib, mdm_state = env._unwrap(bundle)
        state = env._replan_if_due(mdm_state, state, g, None)
    state = state.replace(sim=env._physics(lib, state, act))
    return env._after_physics(lib, state, pool, slot, g)


def _assert_same(got, want, fail_rates_atol=0.0):
    """Every tensor of two states equal (the fail rates within
    ``fail_rates_atol``), every other field equal."""
    for f in vars(want):
        a, b = getattr(got, f), getattr(want, f)
        if f == "sim":
            for k in vars(b):
                assert torch.equal(getattr(a, k), getattr(b, k)), f"sim.{k}"
        elif f == "fail_rates":
            torch.testing.assert_close(a, b, rtol=0, atol=fail_rates_atol)
        elif isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f
        else:
            assert a == b, f


@pytest.mark.parametrize("pooled", [True, False], ids=["pool", "generator"])
@pytest.mark.parametrize("kind", KINDS)
def test_after_physics_is_the_step(kind, pooled):
    """The physics, then the chain on its own, give the step's state bit
    for bit; half the envs time out and reset (from the pool, or sampled
    and observed inline)."""
    env, lib = _setup(kind, "cpu", N)
    state, g = _start(env, lib, "cpu")
    pool = (env.build_reset_pool(lib, g, state.fail_rates, N, k=2)
            if pooled else None)
    slot = torch.arange(N) % 2 if pooled else None
    act = 0.1 * torch.randn((N, env.action_dim),
                            generator=torch.Generator().manual_seed(1))
    drawn = g.get_state()
    want = env.step(lib, state, act, reset_pool=pool, pool_slot=slot,
                    generator=g)
    g.set_state(drawn)
    got = _eager(env, lib, state, act, pool, slot, g)
    assert (want.done == DoneFlags.TIME).sum() >= N // 2
    _assert_same(got, want)


def test_cpu_rollout_never_engages_the_graph():
    """A pooled rollout on the CPU runs the chain eagerly: nothing is
    captured or replayed."""
    env, lib = _setup("deepmimic", "cpu", N)
    cfg = PPOConfig(actor_net="fc_2layers_512units",
                    critic_net="fc_2layers_512units", steps_per_iter=3)
    agent = PPOAgent(env, cfg, device="cpu")
    state = agent.init(lib, torch.Generator().manual_seed(0))
    before = (step_graph.StepGraph.captures, step_graph.StepGraph.replays)
    es, batch = agent.rollout(lib, state, torch.tensor(1.0))
    assert batch["reward"].shape == (3, N)
    assert (step_graph.StepGraph.captures,
            step_graph.StepGraph.replays) == before
    assert env._step_graph is None


def test_contact_mask_built_once():
    """The allowed-contact mask is made in ``__init__``, equal to the mask
    the step used to build every step, and kept across steps."""
    model = humanoid_spec().build(device="cpu")
    cfg = tbase.EnvConfig(num_envs=N, contact_bodies=("right_foot",
                                                      "left_foot"))
    env = tdm.DeepMimicEnv(model, te.SimParams(), cfg, device="cpu")
    old = torch.zeros(model.num_bodies, dtype=torch.bool)
    old[list(env.contact_body_ids)] = True
    assert torch.equal(env.contact_allowed, old)
    assert int(env.contact_allowed.sum()) == 2
    mask = env.contact_allowed
    lib = tml.build_motion_lib(model, _clips(), device="cpu")
    state, g = _start(env, lib, "cpu")
    env.step(lib, state, torch.zeros((N, env.action_dim)), generator=g)
    assert env.contact_allowed is mask
    none = tdm.DeepMimicEnv(model, te.SimParams(),
                            tbase.EnvConfig(num_envs=N), device="cpu")
    assert not none.contact_allowed.any()


def test_grid_index_host_bounds():
    """``get_grid_index`` clamps by the grid's host dims as the tensor
    bounds did, inside the grid and past each of its edges."""
    t = terrain_lib.create_terrain(12, 7, dx=0.4, min_x=-1.0, min_y=2.0,
                                   device="cpu")
    pts = torch.rand((500, 2), generator=torch.Generator().manual_seed(0))
    pts = pts * torch.tensor([8.0, 6.0]) + torch.tensor([-3.0, 0.0])
    inds = torch.round((pts - t.min_point) / t.dxdy).long()
    hi = torch.as_tensor(t.dims) - 1
    old = torch.clamp(inds, min=torch.zeros_like(hi), max=hi)
    got = terrain_lib.get_grid_index(t, pts)
    assert got.dtype == old.dtype and torch.equal(got, old)
    assert (inds < 0).any() and (inds[:, 0] > 11).any() \
        and (inds[:, 1] > 6).any()


# ----------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


NC = 256        # envs on the card
STEPS = 40


def _actions(env, device, steps, scale=0.3, seed=7):
    g = torch.Generator(device=device).manual_seed(seed)
    return [scale * torch.randn((NC, env.action_dim), generator=g,
                                device=device) for _ in range(steps)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_graphed_steps_match_eager(cuda, kind):
    """40 pooled steps replayed from one graph against the same steps run
    eagerly from the same state, pool and actions: equal bit for bit, the
    fail rates within 1e-6; envs end and reset along the way."""
    env, lib = _setup(kind, cuda, NC, mgdm_num=16)
    state, g = _start(env, lib, cuda, late=5)
    state = state.replace(time=state.time + 9.0 * torch.rand(
        (NC,), generator=g, device=cuda))
    k = 4
    pool = env.build_reset_pool(lib, g, state.fail_rates, NC, k=k)
    acts = _actions(env, cuda, STEPS)
    caps, reps = step_graph.StepGraph.captures, step_graph.StepGraph.replays
    graphed, eager = state, state
    cg, ce = (torch.zeros(NC, dtype=torch.long, device=cuda) for _ in "ab")
    gg, ge = (torch.Generator(device=cuda).manual_seed(3) for _ in "ab")
    dones = 0
    for t, act in enumerate(acts):
        graphed = env.step(lib, graphed, act, reset_pool=pool,
                           pool_slot=cg % k, generator=gg)
        eager = _eager(env, lib, eager, act, pool, ce % k, ge)
        _assert_same(graphed, eager, fail_rates_atol=1e-6)
        cg += (graphed.done != DoneFlags.NULL).long()
        ce += (eager.done != DoneFlags.NULL).long()
        dones += int((graphed.done != DoneFlags.NULL).sum())
    assert dones >= NC
    assert step_graph.StepGraph.captures == caps + 1
    assert step_graph.StepGraph.replays == reps + STEPS


@pytest.mark.cuda
def test_rebuilt_pool_is_read(cuda):
    """A pool built after the graph's capture is read by the next replay:
    envs that end there take their resets from the new pool."""
    env, lib = _setup("deepmimic", cuda, NC)
    state, g = _start(env, lib, cuda, late=NC + 1)
    slot = torch.zeros(NC, dtype=torch.long, device=cuda)
    first = env.build_reset_pool(lib, g, state.fail_rates, NC, k=1)
    act = _actions(env, cuda, 1)[0]
    state = env.step(lib, state, act, reset_pool=first, pool_slot=slot)
    second = env.build_reset_pool(lib, g, state.fail_rates, NC, k=1)
    late = state.replace(time=state.time + 100.0)
    got = env.step(lib, late, act, reset_pool=second, pool_slot=slot)
    want = _eager(env, lib, late, act, second, slot, None)
    _assert_same(got, want, fail_rates_atol=1e-6)
    assert (got.done != DoneFlags.NULL).all()
    stale = _eager(env, lib, late, act, first, slot, None)
    assert not torch.equal(got.obs, stale.obs)


@pytest.mark.cuda
def test_new_lib_recaptures(cuda):
    """The same lib replays its graph; another lib is captured again, and
    its step reads the new lib."""
    env, lib = _setup("deepmimic", cuda, NC)
    other = tml.build_motion_lib(env.model, _clips(speed=0.8), device=cuda)
    state, g = _start(env, lib, cuda)
    slot = torch.zeros(NC, dtype=torch.long, device=cuda)
    act = _actions(env, cuda, 1)[0]
    caps = step_graph.StepGraph.captures
    pool = env.build_reset_pool(lib, g, state.fail_rates, NC, k=1)
    for _ in range(2):
        env.step(lib, state, act, reset_pool=pool, pool_slot=slot)
    assert step_graph.StepGraph.captures == caps + 1
    pool2 = env.build_reset_pool(other, g, state.fail_rates, NC, k=1)
    got = env.step(other, state, act, reset_pool=pool2, pool_slot=slot)
    assert step_graph.StepGraph.captures == caps + 2
    assert env._step_graph.owner is other
    want = _eager(env, other, state, act, pool2, slot, None)
    _assert_same(got, want, fail_rates_atol=1e-6)
    assert not torch.equal(
        got.reward, _eager(env, lib, state, act, pool2, slot, None).reward)


@pytest.mark.cuda
def test_returned_tensors_survive_later_steps(cuda):
    """What a step returned is fresh memory: two more replays leave every
    tensor of it as it was."""
    env, lib = _setup("deepmimic", cuda, NC)
    state, g = _start(env, lib, cuda)
    pool = env.build_reset_pool(lib, g, state.fail_rates, NC, k=2)
    slot = torch.arange(NC, device=cuda) % 2
    acts = _actions(env, cuda, 3)
    first = env.step(lib, state, acts[0], reset_pool=pool, pool_slot=slot)
    kept = [t.clone() for t in step_graph.leaves(first)]
    ptrs = {t.data_ptr() for t in env._step_graph.static_out}
    assert not ptrs & {t.data_ptr() for t in step_graph.leaves(first)}
    nxt = first
    for act in acts[1:]:
        nxt = env.step(lib, nxt, act, reset_pool=pool, pool_slot=slot)
    for a, b in zip(step_graph.leaves(first), kept):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_class_patch_shows_in_graphed_rewards(cuda, monkeypatch):
    """A patch of ``DeepMimicEnv._compute_reward`` made before the first
    step, as the benchmark's answer fault plants it, is what the graph
    captures."""
    env, lib = _setup("deepmimic", cuda, NC)
    state, g = _start(env, lib, cuda)
    pool = env.build_reset_pool(lib, g, state.fail_rates, NC, k=1)
    slot = torch.zeros(NC, dtype=torch.long, device=cuda)
    act = _actions(env, cuda, 1)[0]
    plain = _eager(env, lib, state, act, pool, slot, None)
    orig = tdm.DeepMimicEnv._compute_reward

    def _compute_reward(self, *a, **kw):
        reward, comps = orig(self, *a, **kw)
        return 0.9 * reward, comps

    monkeypatch.setattr(tdm.DeepMimicEnv, "_compute_reward", _compute_reward)
    got = env.step(lib, state, act, reset_pool=pool, pool_slot=slot)
    assert env._step_graph is not None
    assert torch.equal(got.reward, 0.9 * plain.reward)


@pytest.mark.cuda
def test_rollout_replays_every_step(cuda):
    """``PPOAgent.rollout`` on the card: one capture, a replay a step."""
    env, lib = _setup("deepmimic", cuda, NC)
    cfg = PPOConfig(actor_net="fc_2layers_512units",
                    critic_net="fc_2layers_512units", steps_per_iter=4)
    agent = PPOAgent(env, cfg, device=cuda)
    state = agent.init(lib, torch.Generator(device=cuda).manual_seed(0))
    caps, reps = step_graph.StepGraph.captures, step_graph.StepGraph.replays
    for _ in range(2):
        es, batch = agent.rollout(lib, state, torch.tensor(1.0,
                                                           device=cuda))
        state = state.replace(env_state=es)
    assert step_graph.StepGraph.captures == caps + 1
    assert step_graph.StepGraph.replays == reps + 8
    assert torch.isfinite(batch["next_obs"]).all()
