"""Tracker training: ``PPOAgent.train_iter`` over and over, as
``pipeline/train_tracker.train`` calls it, with no checkpoint, log or test
rollout in the window. A step is one whole iteration (rollout, targets,
update); its work is ``steps_per_iter * num_envs`` env samples.

Set-up builds the clips and terrains from the seed, the motion library,
the env and the agent (weights and env state drawn on the card from the
seed), and drives that same agent through its first ``check.steps``
iterations through ``train_iter`` itself: they warm every shape up, and
their losses, first gradients and parameter change, with the first
iteration's first actions, observations and rewards, are what the
reference is held against once the window has closed.
"""

from __future__ import annotations

import contextlib

import torch

from harness import compare, counts
from harness import traffic as traffic_lib
from harness import trace as trace_lib
from harness.cfg import build as from_json


def total_loss(cfg, m) -> torch.Tensor:
    """An iteration's mean PPO loss, as ``PPOAgent._loss`` weighs it."""
    return (m.actor_loss + cfg.critic_loss_weight * m.critic_loss
            + cfg.action_bound_weight * m.bound_loss)


def sgd_first_grad(st: dict) -> torch.Tensor:
    # SGD's momentum buffer starts at zero, so after one step it is the
    # gradient the optimizer got (after the clip)
    return st["momentum_buffer"]


def actor_params(net) -> list:
    """The policy's leaves: the actor's trunk and head (and a learnt
    log-std), which move only through the actor loss and the bound loss."""
    return [p for k, p in net.named_parameters()
            if k.startswith(("actor", "logstd"))]


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().float().flatten() for t in tensors]).cpu()


class ActorRecorder:
    """The actor's side of the first iteration's update, kept without
    changing what it computes: each minibatch's critic and actor loss (the
    PPO guard holds the actor still where the critic loss is over
    ``critic_loss_guard``) and the actor's gradient at the first minibatch
    the guard lets through, as the optimizer gets it. Read by the
    calibration's ``diagnostics``."""

    def __init__(self, agent, optimizer):
        self.agent = agent
        self.params = actor_params(agent.net)
        self.guard = agent.cfg.critic_loss_guard
        self.critic, self.actor = [], []
        self.grad = None
        self.grad_at = -1
        loss = agent._loss

        def recording_loss(*a, **kw):
            out = loss(*a, **kw)
            self.critic.append(float(out[1]["critic_loss"].detach()))
            self.actor.append(float(out[1]["actor_loss"].detach()))
            return out

        def at_step(opt, args, kwargs):
            if self.grad is None and self.critic[-1] <= self.guard:
                self.grad = flat(p.grad for p in self.params)
                self.grad_at = len(self.critic) - 1

        agent._loss = recording_loss
        self._hook = optimizer.register_step_pre_hook(at_step)

    def finish(self) -> dict:
        self._hook.remove()
        del self.agent._loss
        return {"critic_mb": self.critic, "actor_mb": self.actor,
                "actor_grad": self.grad, "actor_grad_at": self.grad_at}


def follow(agent, lib, state, steps: int, cfg, first_mean: bool = False):
    """Run ``steps`` iterations of ``agent.train_iter`` from ``state`` with
    a recorder on; returns (state, readings). The first iteration's first
    actions, its observations after one step and its first rewards are
    kept, with its update's actor readings (``ActorRecorder``);
    ``first_mean`` also keeps the policy's mean action on the first
    observations (the reference's side)."""
    rec = compare.TrainRecorder(agent.net, state.optimizer, sgd_first_grad)
    actor = ActorRecorder(agent, state.optimizer)
    first = {}
    if first_mean:
        from reference.learning import normalizer as norm_lib
        with torch.no_grad():
            obs0 = norm_lib.normalize(state.obs_norm, state.env_state.obs)
            first["mean0"] = agent.net.actor(obs0)[0].float().cpu()
    rollout = agent.rollout

    def recording_rollout(lib_, st, exp_prob):
        es, batch = rollout(lib_, st, exp_prob)
        if "norm_a0" not in first:
            first["norm_a0"] = batch["norm_a"][0].float().cpu()
            first["obs1"] = batch["obs"][1].float().cpu()
            first["reward0"] = batch["reward"][0].float().cpu()
        return es, batch

    agent.rollout = recording_rollout
    try:
        for i in range(steps):
            state, m = agent.train_iter(lib, state)
            rec.loss(total_loss(cfg, m))
            if i == 0:
                first.update(actor.finish())
    finally:
        del agent.rollout
        if "actor_mb" not in first:
            actor.finish()
    readings = rec.finish()
    readings.update(first)
    return state, readings


def checks(prog: dict, ref: dict, limits: dict) -> list:
    """The numbers compared, each with its limit. The change is held by
    its median leaf, where the critic's leaves meet the actor's: in the
    first iteration the actor's importance ratios collapse (PERF.md), so
    its few live samples, which bf16 rounding turns, steer its change, and
    the actor's leaves swing between two sound runs."""
    out = compare.training_checks(prog, ref, limits, change="median")
    out += [
        {"name": "action_gap",
         "value": compare.diff_gap(prog["norm_a0"], ref["norm_a0"],
                                   scale=ref["mean0"]),
         "limit": limits["action_gap"]},
        {"name": "obs_gap", "value": compare.diff_gap(prog["obs1"],
                                                      ref["obs1"]),
         "limit": limits["obs_gap"]},
        {"name": "reward_gap",
         "value": compare.diff_gap(prog["reward0"], ref["reward0"]),
         "limit": limits["reward_gap"]},
    ]
    return out


def guarded(r: dict, guard: float) -> list:
    return [c > guard for c in r["critic_mb"]]


def diagnostics(prog: dict, ref: dict, guard: float = 20.0) -> dict:
    """What the actor's update did on each side: the minibatches the guard
    held on each side and where they disagree, the first one it let
    through, and how far apart the actor's gradients there are."""
    gp, gr = guarded(prog, guard), guarded(ref, guard)
    out = {"guarded_prog": sum(gp), "guarded_ref": sum(gr),
           "guard_disagree": sum(a != b for a, b in zip(gp, gr)),
           "minibatches": len(gr),
           "first_driven_prog": prog["actor_grad_at"],
           "first_driven_ref": ref["actor_grad_at"]}
    if prog["actor_grad"] is not None and ref["actor_grad"] is not None:
        out["actor_grad_gap"] = compare.diff_gap(prog["actor_grad"],
                                                 ref["actor_grad"])
    return out


class Cell:
    trace_steps = 1
    span_rename = {"train_iter": "update"}

    def __init__(self, ctx):
        self.ctx = ctx
        self.spans = {}
        self.losses = []
        self.timer = None

    # ------------------------------------------------------------------
    def _build(self):
        """The program's model, motion library, env and agent."""
        from parc_torch.anim import motion_data as md
        from parc_torch.anim import motion_lib as ml
        from parc_torch.data.humanoid import humanoid_spec
        from parc_torch.envs.base import EnvConfig
        from parc_torch.envs.deepmimic import DeepMimicEnv
        from parc_torch.learning.ppo import PPOAgent, PPOConfig
        from parc_torch.physics.engine import SimParams
        ctx, dev = self.ctx, self.ctx.device
        c, w = ctx.config, ctx.workload
        self.clips = traffic_lib.make(ctx.traffic, ctx.seed)
        model = humanoid_spec().build(device=dev)
        self.lib = ml.build_motion_lib(model, [md.MotionData(
            frames=k.frames, fps=k.fps, contacts=k.contacts,
            terrain=md.HostTerrain(hf=k.hf, min_point=k.min_point,
                                   dxdy=k.dxdy, hf_maxmin=k.hf_maxmin))
            for k in self.clips], device=dev)
        self.env = DeepMimicEnv(model, from_json(SimParams, c["sim"]),
                                from_json(EnvConfig, c["env"],
                                          num_envs=w["num_envs"]),
                                device=dev)
        self.cfg = from_json(PPOConfig, c["ppo"])
        self.agent = PPOAgent(self.env, self.cfg, device=dev)
        g = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.state = self.agent.init(self.lib, g)

    def setup(self):
        self._build()
        self.state, self.prog = follow(self.agent, self.lib, self.state,
                                       self.ctx.workload["check"]["steps"],
                                       self.cfg)
        if self.ctx.trace:
            from parc_torch.utils.profiling import PhaseTimer
            self.timer = PhaseTimer()

    def step(self, traced: bool = False) -> float:
        agent = self.agent
        if traced:
            rollout = agent.rollout

            def spanned(*a):
                with trace_lib.span("bench.rollout"):
                    return rollout(*a)
            agent.rollout = spanned
            try:
                with trace_lib.span("bench.train_iter"):
                    self.state, _ = agent.train_iter(self.lib, self.state)
            finally:
                del agent.rollout
        else:
            self.state, m = agent.train_iter(self.lib, self.state,
                                             timer=self.timer)
            self.losses.append(total_loss(self.cfg, m))
        return float(self.cfg.steps_per_iter * self.env.cfg.num_envs)

    def failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def phases(self) -> dict:
        return dict(self.timer.summary()) if self.timer else {}

    def work(self) -> dict:
        from reference.learning.networks import _NET_REGISTRY
        model = counts.humanoid()
        cfg, env = self.cfg, self.env.cfg
        # the parkour env passes a bundle whose lib holds the terrains
        hf = getattr(self.lib, "lib", self.lib).terrain_hf
        return {
            "iter_flops": counts.ppo_iteration_flops(
                self.env.obs_dim, self.env.action_dim,
                _NET_REGISTRY[cfg.actor_net], _NET_REGISTRY[cfg.critic_net],
                cfg.steps_per_iter, env.num_envs, cfg.update_epochs),
            "control_step_ops": counts.control_step_operations(
                model, env.num_envs, env.sim_steps_per_control,
                self.env.sim_params.substeps),
            "control_step_bytes": counts.control_step_bytes(
                model, env.num_envs, hf.shape[0], hf.shape[1], hf.shape[2]),
        }

    def release(self):
        self.agent = self.env = self.lib = self.state = None
        self.losses = []

    def reference(self, control: bool = False) -> dict:
        """The reference's readings over the same first iterations (with
        ``control``, the fp8 control's)."""
        from reference import tracker as ref
        ctx, w = self.ctx, self.ctx.workload
        with ref.float32_exact():
            agent, lib, state = ref.build(
                self.clips, ctx.config["env"], ctx.config["sim"],
                ctx.config["ppo"], w["num_envs"], ctx.seed, ctx.device,
                control=control)
            _, got = follow(agent, lib, state, w["check"]["steps"],
                            agent.cfg, first_mean=True)
        return got

    def check(self) -> list:
        return checks(self.prog, self.reference(),
                      self.ctx.workload["check"]["limits"])


# ----------------------------------------------------------------------
# Faults planted in the program, each a context manager: the tests see
# ``correct`` come out false under each, and the calibration reads them.

@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def fault_unchanged():
    """Every iteration returns the network as it found it."""
    from parc_torch.learning.ppo import PPOAgent

    def make(orig):
        def train_iter(self, lib, agent, *a, **kw):
            keep = [p.detach().clone() for p in self.net.parameters()]
            out = orig(self, lib, agent, *a, **kw)
            with torch.no_grad():
                for p, k in zip(self.net.parameters(), keep):
                    p.copy_(k)
            return out
        return train_iter
    return _patched(PPOAgent, "train_iter", make)


def fault_half_batch():
    """The update leaves out half of the iteration's samples and takes
    its means over the rest."""
    from parc_torch.learning.ppo import PPOAgent

    def make(orig):
        def _update(self, flat, *a, **kw):
            n = flat["rand_mask"].shape[0] // 2
            return orig(self, {k: v[:n] for k, v in flat.items()}, *a, **kw)
        return _update
    return _patched(PPOAgent, "_update", make)


def fault_answer():
    """The env step's reward, altered where it is produced."""
    from parc_torch.envs.deepmimic import DeepMimicEnv

    def make(orig):
        def _compute_reward(self, *a, **kw):
            reward, comps = orig(self, *a, **kw)
            return 0.9 * reward, comps
        return _compute_reward
    return _patched(DeepMimicEnv, "_compute_reward", make)


def fault_actor_sign():
    """The actor loss with the advantages' sign turned: the policy climbs
    away from what the critic rates."""
    from parc_torch.learning.ppo import PPOAgent

    def make(orig):
        def _loss(self, norm_obs, norm_a, old_logp, adv, *a, **kw):
            return orig(self, norm_obs, norm_a, old_logp, -adv, *a, **kw)
        return _loss
    return _patched(PPOAgent, "_loss", make)


FAULTS = {"unchanged": fault_unchanged, "half_batch": fault_half_batch,
          "answer": fault_answer}
# faults read by the calibration only, which the checks need not catch
EXTRA_FAULTS = {"actor_sign": fault_actor_sign}
