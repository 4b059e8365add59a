"""MDM training: ``MDM.train_step`` over and over, as
``pipeline/train_mdm.train`` calls it, with no checkpoint or log in the
window. A step is one optimization step (a batch of windows sampled from
the clips, the loss and its gradient, the clip, AdamW, the EMA); its work
is the batch's windows.

Set-up builds the clips and terrains from the seed, the motion library and
the MDM (weights and the feature statistics on the card), and drives that
same state through its first ``check.steps`` steps through ``train_step``
itself; their losses, first gradients, parameter and EMA change, and the
first step's batch, are what the reference is held against once the
window has closed.
"""

from __future__ import annotations

import contextlib

import torch

from harness import compare, counts
from harness import traffic as traffic_lib
from harness import trace as trace_lib
from harness.cfg import build as from_json


def follow(mdm, lib, state, steps: int, sampler_module):
    """Run ``steps`` train steps from ``state`` with a recorder on;
    returns (state, readings). ``sampler_module`` is the side's window
    sampler, whose first batch is kept."""
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    ema0 = {k: p.detach().clone()
            for k, p in state.ema_net.named_parameters()}
    rec = compare.TrainRecorder(
        state.net, state.optimizer,
        # AdamW's first moment starts at zero: after one step it is
        # (1 - beta1) times the gradient it got (after the clip)
        lambda st: st["exp_avg"] / (1.0 - beta1))
    first = {}
    batch_from_draws = sampler_module.batch_from_draws

    def recording(*a, **kw):
        batch = batch_from_draws(*a, **kw)
        if "batch" not in first:
            first["batch"] = torch.cat([
                batch.frames.flatten(1), batch.prev_states.flatten(1),
                batch.hf.flatten(1), batch.target_dir], 1).float().cpu()
        return batch

    def forward_hook(module, args, out):
        if "pred" not in first:
            first["pred"] = out.detach().float().cpu()

    # each window's loss (the sum of its terms) at each step: read by the
    # calibration's diagnostics only
    geometric = mdm._geometric_losses
    windows = []

    def recording_losses(*a, **kw):
        out = geometric(*a, **kw)
        windows.append(sum(out.values()).detach().double().cpu())
        return out

    sampler_module.batch_from_draws = recording
    mdm._geometric_losses = recording_losses
    hook = state.net.register_forward_hook(forward_hook)
    try:
        for _ in range(steps):
            state, m = mdm.train_step(lib, state)
            rec.loss(m["total"])
    finally:
        sampler_module.batch_from_draws = batch_from_draws
        del mdm._geometric_losses
        hook.remove()
    first["window_loss"] = windows
    readings = rec.finish()
    readings["change"].update({
        f"ema.{k}": float(torch.linalg.vector_norm(p.detach() - ema0[k]))
        for k, p in state.ema_net.named_parameters()})
    readings.update(first)
    return state, readings


def checks(prog: dict, ref: dict, limits: dict) -> list:
    """The numbers compared, each with its limit: each step's loss, the
    change by its worst leaf, the first batch, and the denoiser's first
    prediction (where the fp8 control shows)."""
    return compare.training_checks(prog, ref, limits, change="worst") + [
        {"name": "batch_gap",
         "value": compare.diff_gap(prog["batch"], ref["batch"]),
         "limit": limits["batch_gap"]},
        {"name": "pred_gap",
         "value": compare.diff_gap(prog["pred"], ref["pred"]),
         "limit": limits["pred_gap"]}]


def diagnostics(prog: dict, ref: dict) -> dict:
    """Where each step's loss parts: its gap, and the share of that gap
    that its one farthest window makes, with that window's loss over the
    step's mean window loss (the reference's)."""
    out = {}
    for i, (p, r) in enumerate(zip(prog["window_loss"], ref["window_loss"])):
        d = p - r
        out[f"step{i}_gap"] = compare.rel_gap(float(p.sum()), float(r.sum()))
        k = int(d.abs().argmax())
        out[f"step{i}_top_share"] = float(d[k].abs() / d.abs().sum())
        out[f"step{i}_top_weight"] = float(r[k] / r.mean())
    return out


class Cell:
    trace_steps = 10
    span_rename = {}

    def __init__(self, ctx):
        self.ctx = ctx
        self.spans = {}
        self.losses = []

    def setup(self):
        from parc_torch.anim import motion_data as md
        from parc_torch.anim import motion_lib as ml
        from parc_torch.data.humanoid import humanoid_spec
        from parc_torch.diffusion import sampler as sampler_lib
        from parc_torch.diffusion.mdm import MDM, MDMConfig
        ctx, dev, w = self.ctx, self.ctx.device, self.ctx.workload
        c = ctx.config
        self.clips = traffic_lib.make(ctx.traffic, ctx.seed)
        model = humanoid_spec().build(device=dev)
        self.lib = ml.build_motion_lib(model, [md.MotionData(
            frames=k.frames, fps=k.fps, contacts=k.contacts,
            terrain=md.HostTerrain(hf=k.hf, min_point=k.min_point,
                                   dxdy=k.dxdy, hf_maxmin=k.hf_maxmin))
            for k in self.clips], device=dev)
        self.mdm = MDM(model, from_json(MDMConfig, c["mdm"],
                                        batch_size=w["windows"]),
                       from_json(sampler_lib.SamplerConfig, c["sampler"]),
                       device=dev)
        self.state = self.mdm.init(
            self.lib, torch.Generator(device=dev).manual_seed(ctx.seed))
        self.state, self.prog = follow(self.mdm, self.lib, self.state,
                                       w["check"]["steps"], sampler_lib)

    def step(self, traced: bool = False) -> float:
        if traced:
            with trace_lib.span("bench.train_step"):
                self.state, _ = self.mdm.train_step(self.lib, self.state)
        else:
            self.state, m = self.mdm.train_step(self.lib, self.state)
            self.losses.append(m["total"])
        return float(self.mdm.cfg.batch_size)

    def failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def phases(self) -> dict:
        return {}

    def work(self) -> dict:
        from reference.diffusion.sampler import SamplerConfig
        cfg, scfg = self.mdm.cfg, self.mdm.scfg
        frame_dim = SamplerConfig().frame_dim(counts.humanoid())
        return {"step_flops": counts.mdm_train_step_flops(
            cfg.d_model, cfg.d_hid, cfg.num_layers, scfg.seq_len,
            scfg.num_prev_states, frame_dim, cfg.batch_size)}

    def release(self):
        self.mdm = self.lib = self.state = None
        self.losses = []

    def reference(self, control: bool = False) -> dict:
        """The reference's readings over the same first steps (with
        ``control``, the fp8 control's)."""
        from reference import mdm as ref
        from reference.diffusion import sampler as ref_sampler
        from reference.tracker import float32_exact
        ctx, w = self.ctx, self.ctx.workload
        with float32_exact():
            mdm, lib, state = ref.build(
                self.clips, ctx.config["mdm"], ctx.config["sampler"],
                w["windows"], ctx.seed, ctx.device, control=control)
            _, got = follow(mdm, lib, state, w["check"]["steps"],
                            ref_sampler)
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
    """Every step returns the denoiser and its EMA as it found them."""
    from parc_torch.diffusion.mdm import MDM

    def make(orig):
        def train_step(self, lib, state, *a, **kw):
            nets = (state.net, state.ema_net)
            keep = [[p.detach().clone() for p in n.parameters()]
                    for n in nets]
            out = orig(self, lib, state, *a, **kw)
            with torch.no_grad():
                for n, k in zip(nets, keep):
                    for p, q in zip(n.parameters(), k):
                        p.copy_(q)
            return out
        return train_step
    return _patched(MDM, "train_step", make)


def fault_half_batch():
    """The loss leaves out half of the batch's windows and takes its
    means over the rest."""
    from parc_torch.diffusion.mdm import MDM

    def make(orig):
        def _geometric_losses(self, *a, **kw):
            losses = orig(self, *a, **kw)
            n = next(iter(losses.values())).shape[0] // 2
            return {k: torch.cat([v[:n], v[:n]]) for k, v in losses.items()}
        return _geometric_losses
    return _patched(MDM, "_geometric_losses", make)


def fault_answer():
    """A token altered where it is produced: the batch's last motion
    frame is its one before."""
    from parc_torch.diffusion import sampler

    def make(orig):
        def batch_from_draws(*a, **kw):
            batch = orig(*a, **kw)
            frames = batch.frames.clone()
            frames[:, -1] = frames[:, -2]
            return batch.replace(frames=frames)
        return batch_from_draws
    return _patched(sampler, "batch_from_draws", make)


FAULTS = {"unchanged": fault_unchanged, "half_batch": fault_half_batch,
          "answer": fault_answer}
