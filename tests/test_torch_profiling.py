"""parc_torch's spans (``parc_torch.utils.profiling.annotate``) on the CPU:
off, ``annotate`` hands out one shared no-op and builds no
``record_function``; under ``torch.profiler`` the env steps, the physics
driver, the rollout's policy, the replan's DDIM loop and the MDM's training
step show their ``parc.*`` spans, nested where the work nests. The envs are
those of tests/test_torch_envs.py and tests/test_torch_parkour.py (the
two-clip library; the small MDM, the 32 x 32 platform, 2 mgdm rows) at 4
envs, the MDM that of tests/test_torch_train_mdm.py."""

import numpy as np
import pytest
import torch

from parc_torch.anim import motion_lib as tml
from parc_torch.data import synthetic as tsyn
from parc_torch.data.humanoid import humanoid_spec as tspec
from parc_torch.diffusion.mdm import MDM, MDMConfig
from parc_torch.envs import base as tbase
from parc_torch.envs import deepmimic as tdm
from parc_torch.envs import mgdm as tmg
from parc_torch.envs import parkour as tpk
from parc_torch.learning.ppo import PPOAgent, PPOConfig
from parc_torch.physics import engine as te
from parc_torch.utils import profiling
from test_torch_parkour import MDM_CFG, PCFG
from test_torch_train_mdm import _mdm_and_lib

torch.set_num_threads(1)

N = 4


@pytest.fixture(scope="module")
def stack():
    model = tspec().build(device="cpu")
    lib = tml.build_motion_lib(model, [tsyn.standing_clip(),
                                       tsyn.walking_clip(seed=1)],
                               device="cpu")
    return model, lib


def _spans(fn):
    """Run ``fn`` under a CPU torch.profiler; its result and the program's
    spans as (name, start_ns, end_ns), in order of start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    # the raw events: FunctionEvents take seconds to build for a step's
    # thousands of operations
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("parc."))
    return out, [(n, s, e) for s, e, n in spans]


def _named(spans, name):
    return [sp for sp in spans if sp[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _check_step(spans):
    """One env step: one ``parc.env.step`` holding one of each part and
    the physics driver's one span."""
    (step,) = _named(spans, "parc.env.step")
    for part in ("parc.env.reference", "parc.env.reward", "parc.env.obs",
                 "parc.env.reset", "parc.physics.control_step"):
        (sp,) = _named(spans, part)
        assert _inside(sp, step), part
    return step


def test_annotate_off_is_one_shared_noop():
    """No profiler runs: two names get the same no-op context, which
    opens no span; under a profiler each gets a record_function."""
    a, b = profiling.annotate("parc.x"), profiling.annotate("parc.y")
    assert a is b
    assert not isinstance(a, torch.profiler.record_function)
    with a:
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = profiling.annotate("parc.z")
        with on:
            torch.ones(2).sum()
    assert isinstance(on, torch.profiler.record_function)
    assert [e.name for e in prof.events() if e.name.startswith("parc.")
            ] == ["parc.z"]


def test_deepmimic_step_spans(stack):
    """A DeepMimicEnv step with an inline reset: its parts inside
    ``parc.env.step``, one control step of the physics."""
    model, lib = stack
    env = tdm.DeepMimicEnv(model, te.SimParams(),
                           tbase.EnvConfig(num_envs=N), device="cpu")
    g = torch.Generator().manual_seed(0)
    state = env.reset(lib, g)
    act = torch.zeros((N, env.action_dim))
    _, spans = _spans(lambda: env.step(lib, state, act, generator=g))
    _check_step(spans)
    assert len(spans) == 6


def test_parkour_step_spans_with_a_replan(stack):
    """A ParkourEnv step whose mgdm rows replan: one ``parc.ddim.denoise``
    a DDIM timestep, all inside ``parc.env.replan`` inside the step."""
    model, lib = stack
    mdm = MDM(model, MDMConfig(**MDM_CFG), device="cpu")
    mdm_state = mdm.init(lib, torch.Generator().manual_seed(0),
                         stats_samples=8)
    env = tpk.ParkourEnv(
        model, te.SimParams(),
        tbase.EnvConfig(num_envs=N, enable_early_termination=False),
        tpk.ParkourConfig(**PCFG), mdm,
        tmg.make_platform_terrain(np.random.default_rng(0), dim=32,
                                  device="cpu"), device="cpu")
    bundle = env.make_lib(lib, mdm_state)
    g = torch.Generator().manual_seed(1)
    state = env.reset(bundle, g)
    assert state.replan_timer == 1
    act = torch.zeros((N, env.action_dim))
    out, spans = _spans(lambda: env.step(bundle, state, act, generator=g))
    assert out.replan_timer == PCFG["plan_frames"]
    step = _check_step(spans)
    (replan,) = _named(spans, "parc.env.replan")
    assert _inside(replan, step)
    calls = _named(spans, "parc.ddim.denoise")
    timesteps = np.arange(0, MDM_CFG["diffusion_timesteps"],
                          PCFG["ddim_stride"])
    assert len(calls) == len(timesteps) == 3
    assert all(_inside(c, replan) for c in calls)


def test_rollout_spans(stack):
    """Each rollout step's policy in ``parc.ppo.act`` beside the env
    step; the reset pool's build in ``parc.env.reset_pool`` once."""
    model, lib = stack
    env = tdm.DeepMimicEnv(model, te.SimParams(),
                           tbase.EnvConfig(num_envs=N), device="cpu")
    cfg = PPOConfig(actor_net="fc_2layers_512units",
                    critic_net="fc_2layers_512units", steps_per_iter=2)
    agent = PPOAgent(env, cfg, device="cpu")
    state = agent.init(lib, torch.Generator().manual_seed(0))
    _, spans = _spans(lambda: agent.rollout(lib, state,
                                            torch.tensor(1.0)))
    acts = _named(spans, "parc.ppo.act")
    steps = _named(spans, "parc.env.step")
    assert len(acts) == len(steps) == 2
    assert all(a[2] <= s[1] for a, s in zip(acts, steps))
    (pool,) = _named(spans, "parc.env.reset_pool")
    assert pool[2] <= acts[0][1]
    assert len(_named(spans, "parc.physics.control_step")) == 2


def test_mdm_train_step_spans_in_order():
    """A training step's four parts, each once, one after the other."""
    mdm, lib = _mdm_and_lib()
    state = mdm.init(lib, torch.Generator().manual_seed(0))
    _, spans = _spans(lambda: mdm.train_step(lib, state))
    assert [n for n, _, _ in spans] == [
        "parc.mdm.batch", "parc.mdm.forward", "parc.mdm.backward",
        "parc.mdm.update"]
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))
