"""Parkour tracker training: ``PPOAgent.train_iter`` on ``ParkourEnv``, as
``pipeline/train_tracker.train`` calls it for ``--env_name parkour``, with
no checkpoint, log or test rollout in the window. The dm rows track the
traffic's clips over their box terrains; the mgdm rows track windows that
the MDM generates in the step, every ``plan_frames`` control steps, by DDIM
on the shared platform. The MDM's weights are drawn from the seed: a
replan's cost does not depend on them.

Set-up and the check follow the tracker's (drivers/tracker_train.py), and
also keep the first replan's DDIM output (the canonical features of every
mgdm row's first generated window), whose inputs are the reset's standing
windows on both sides.
"""

from __future__ import annotations

from pathlib import Path

import torch

from harness import compare, core, counts
from harness import traffic as traffic_lib
from harness import trace as trace_lib
from harness.cfg import build as from_json

tracker = core.load_module(Path(__file__).with_name("tracker_train.py"),
                           "bench_driver_tracker_train")


def follow(agent, mdm, bundle, state, steps: int, cfg,
           first_mean: bool = False):
    """tracker_train.follow, keeping also the first DDIM sample."""
    first = {}
    sample = mdm.ddim_sample

    def recording(*a, **kw):
        out = sample(*a, **kw)
        if "replan" not in first:
            first["replan"] = out.float().cpu()
        return out

    mdm.ddim_sample = recording
    try:
        state, readings = tracker.follow(agent, bundle, state, steps, cfg,
                                         first_mean)
    finally:
        del mdm.ddim_sample
    readings.update(first)
    return state, readings


def checks(prog: dict, ref: dict, limits: dict) -> list:
    """The tracker's numbers and the first replan's gap."""
    return tracker.checks(prog, ref, limits) + [
        {"name": "replan_gap",
         "value": compare.diff_gap(prog["replan"], ref["replan"]),
         "limit": limits["replan_gap"]}]


class Cell(tracker.Cell):
    trace_steps = 1
    span_rename = {"train_iter": "update"}

    def _build(self):
        from parc_torch.anim import motion_data as md
        from parc_torch.anim import motion_lib as ml
        from parc_torch.data.humanoid import humanoid_spec
        from parc_torch.diffusion import sampler as sampler_lib
        from parc_torch.diffusion.mdm import MDM, MDMConfig
        from parc_torch.envs.base import EnvConfig
        from parc_torch.envs.parkour import ParkourConfig, ParkourEnv
        from parc_torch.learning.ppo import PPOAgent, PPOConfig
        from parc_torch.physics.engine import SimParams
        from parc_torch.utils import terrain as terrain_lib
        ctx, dev = self.ctx, self.ctx.device
        c, w = ctx.config, ctx.workload
        # the denoiser's configuration: a name under configs/, or (in the
        # tests, shrunk) the configuration itself
        self.mdm_config = (w["mdm_config"] if isinstance(w["mdm_config"], dict)
                           else core.load_json(ctx.base / "configs" /
                                               f"{w['mdm_config']}.json"))
        self.clips = traffic_lib.make(ctx.traffic, ctx.seed)
        pf = ctx.traffic["platform"]
        self.platform_hf = traffic_lib.platform_hf(pf, ctx.seed)
        model = humanoid_spec().build(device=dev)
        lib = ml.build_motion_lib(model, [md.MotionData(
            frames=k.frames, fps=k.fps, contacts=k.contacts,
            terrain=md.HostTerrain(hf=k.hf, min_point=k.min_point,
                                   dxdy=k.dxdy, hf_maxmin=k.hf_maxmin))
            for k in self.clips], device=dev)
        self.mdm = MDM(model, from_json(MDMConfig, self.mdm_config["mdm"]),
                       from_json(sampler_lib.SamplerConfig,
                                 self.mdm_config["sampler"]), device=dev)
        mdm_state = self.mdm.init(
            lib, torch.Generator(device=dev).manual_seed(ctx.seed),
            stats_samples=256)
        dim, dx = pf["dim"], float(pf["dx"])
        t = terrain_lib.create_terrain(dim, dim, dx=dx, min_x=-dim * dx / 2,
                                       min_y=-dim * dx / 2, device=dev)
        terrain = terrain_lib.Terrain(
            hf=torch.as_tensor(self.platform_hf, device=dev),
            hf_mask=t.hf_mask, hf_maxmin=t.hf_maxmin, min_point=t.min_point,
            dxdy=t.dxdy)
        self.env = ParkourEnv(
            model, from_json(SimParams, c["sim"]),
            from_json(EnvConfig, c["env"], num_envs=w["num_envs"]),
            from_json(ParkourConfig, c["parkour"],
                      mgdm_num=w["mgdm_rows"]), self.mdm, terrain,
            device=dev)
        self.cfg = from_json(PPOConfig, c["ppo"])
        self.agent = PPOAgent(self.env, self.cfg, device=dev)
        self.lib = self.env.make_lib(lib, mdm_state)
        self.state = self.agent.init(
            self.lib, torch.Generator(device=dev).manual_seed(ctx.seed))

    def setup(self):
        self._build()
        self.state, self.prog = follow(self.agent, self.mdm, self.lib,
                                       self.state,
                                       self.ctx.workload["check"]["steps"],
                                       self.cfg)
        if self.ctx.trace:
            from parc_torch.utils.profiling import PhaseTimer
            self.timer = PhaseTimer()
            self.spans = {"replan": []}
            self._events = []
            self._calls0 = self.mdm.denoise_calls
            replan = self.env._replan
            self._replans = 0
            # CUDA events around each replan of the measured window; off
            # the card the replan is counted but not timed
            cuda = self.ctx.device.type == "cuda"

            def timed(*a):
                if cuda:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                with trace_lib.span("bench.replan"):
                    out = replan(*a)
                if self.timer is not None:
                    self._replans += 1
                    if cuda:
                        ev[1].record()
                        self._events.append(ev)
                return out
            self.env._replan = timed

    def phases(self) -> dict:
        if not self.ctx.trace:
            return {}
        # the window has closed and synchronized: read the replans' events
        self.spans["replan"] = [a.elapsed_time(b) / 1e3
                                for a, b in self._events]
        self.window_calls = self.mdm.denoise_calls - self._calls0
        self.timer_summary = dict(self.timer.summary())
        self.timer = None   # the traced steps record no more events
        return self.timer_summary

    def work(self) -> dict:
        out = super().work()
        m = self.mdm.cfg
        s = self.mdm.scfg
        rows = self.env.pcfg.mgdm_num
        call = counts.denoiser_flops(m.d_model, m.d_hid, m.num_layers,
                                     s.seq_len, s.num_prev_states,
                                     self.mdm.frame_dim, rows, False)
        cond = counts.denoiser_flops(m.d_model, m.d_hid, m.num_layers,
                                     s.seq_len, s.num_prev_states,
                                     self.mdm.frame_dim, rows, True) - call
        steps = max(self._window_steps, 1)
        replans = self._replans
        out["replan_flops"] = (self.window_calls * call
                               + replans * cond) / steps
        return out

    def step(self, traced: bool = False) -> float:
        if not traced and self.timer is not None:
            self._window_steps = getattr(self, "_window_steps", 0) + 1
        return super().step(traced)

    def release(self):
        super().release()
        self.mdm = None

    def reference(self, control: bool = False) -> dict:
        from reference import parkour as ref
        from reference.tracker import float32_exact
        ctx, w = self.ctx, self.ctx.workload
        with float32_exact():
            agent, bundle, state, mdm = ref.build(
                self.clips, self.platform_hf,
                float(ctx.traffic["platform"]["dx"]), ctx.config,
                self.mdm_config, w["num_envs"], w["mgdm_rows"], ctx.seed,
                ctx.device, control=control)
            _, got = follow(agent, mdm, bundle, state, w["check"]["steps"],
                            agent.cfg, first_mean=True)
        return got

    def check(self) -> list:
        return checks(self.prog, self.reference(),
                      self.ctx.workload["check"]["limits"])


def fault_replan():
    """A replan's answer altered where it is produced: the DDIM sample's
    frames come out in reverse order."""
    from parc_torch.diffusion.mdm import MDM

    def make(orig):
        def ddim_sample(self, *a, **kw):
            return orig(self, *a, **kw).flip(1)
        return ddim_sample
    return tracker._patched(MDM, "ddim_sample", make)


FAULTS = dict(tracker.FAULTS, replan=fault_replan)
EXTRA_FAULTS = tracker.EXTRA_FAULTS
diagnostics = tracker.diagnostics
