"""Motion Diffusion Model: training and sampling.

Terrain-conditioned motion diffusion with predict-x0 parameterization,
cosine schedule (1001 steps), classifier-free condition dropout, geometric
losses (velocity, FK body-position consistency, heightfield collision,
target direction), EMA weights, and DDPM/DDIM samplers.

Reference parity: diffusion/mdm.py:110-1651 (training loop :1238-1335,
losses :617-754, DDPM :1115-1145, DDIM :1156-1216, CFG :1032-1065);
hyperparameter defaults from PARC/train_gen_default.yaml.

``MDM`` is the static wrapper (configuration, schedule, character model);
everything a training run changes lives in ``MDMState``: the denoiser and
its EMA copy as modules, AdamW, the feature statistics, the generator and
the step. Random draws come from ``MDMState.generator`` (or an explicit
generator for sampling); each random function also takes its draws
explicitly, so a test can feed the JAX package's. The samplers' loops run
on the device with no host read inside: the schedule's per-step scalars are
host numpy.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from parc_torch import resolve_device
from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_lib as ml
from parc_torch.diffusion import sampler as sampler_lib
from parc_torch.diffusion import schedules
from parc_torch.diffusion.transformer import MDMTransformer
from parc_torch.utils import rotation as rot
from parc_torch.utils.profiling import annotate

_KEEP_ON_OOD = ("hf_collision", "target")


@dataclasses.dataclass(frozen=True)
class MDMConfig:
    diffusion_timesteps: int = 1001
    batch_size: int = 64
    lr: float = 1e-5
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    ema_decay: float = 0.99
    ema_start: int = 200

    # network
    d_model: int = 1024
    num_heads: int = 16
    d_hid: int = 1024
    num_layers: int = 6
    dropout: float = 0.1
    # the encoder stack in bf16 on the GPU (params/losses stay f32); set
    # False for f32 end to end. The CPU always runs f32.
    bf16_compute: bool = True

    # condition dropout (classifier-free guidance training)
    hf_dropout: float = 0.1
    target_dropout: float = 0.025
    prev_state_dropout: float = 0.1
    prev_state_noise_chance: float = 0.5
    # OOD condition resampling (reference: mdm.py:903-940 _ood_chance)
    ood_chance: float = 0.1

    # loss weights (reference: train_gen_default.yaml w_*)
    w_simple_root_pos: float = 1.0
    w_simple_root_rot: float = 1.0
    w_simple_joint_rot: float = 0.5
    w_simple_contacts: float = 1.0
    w_simple_body_pos: float = 0.5
    w_body_pos_consistency: float = 1.0
    w_vel_root_pos: float = 0.5
    w_vel_root_rot: float = 0.02
    w_vel_joint_rot: float = 0.01
    w_target: float = 0.02
    w_hf: float = 15.0


@dataclasses.dataclass
class MDMState:
    """A training run's state. ``net`` holds the trained parameters (the
    JAX package's ``params``), ``ema_net`` their EMA (``ema_params``),
    ``optimizer`` the AdamW moments (``opt_state``)."""

    net: MDMTransformer
    ema_net: MDMTransformer
    optimizer: torch.optim.AdamW
    mean: torch.Tensor   # (total_frames, frame_dim)
    std: torch.Tensor
    generator: torch.Generator
    step: int

    def replace(self, **changes) -> "MDMState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class LossDraws:
    """The draws of :meth:`MDM.loss_fn` for a batch of B windows."""

    t: torch.Tensor           # (B,) int64 diffusion step
    noise: torch.Tensor       # (B, seq_len, F) standard normal
    u_hf: torch.Tensor        # (B,) U[0, 1): hf dropout (and the OOD draw)
    u_target: torch.Tensor    # (B,) target dropout
    u_prev: torch.Tensor      # (B,) prev-state dropout (and the OOD angle)
    u_noised: torch.Tensor    # (B,) prev-state noising
    t_prev: torch.Tensor      # (B,) int64 prev-state noise step
    prev_noise: torch.Tensor  # (B, num_prev, F) standard normal
    ood_boxes: sampler_lib.BoxDraws


class MDM:
    """Static model wrapper; all mutable state in MDMState.

    ``denoise_calls`` counts :meth:`_denoise` calls: one per denoising
    step of a sampler (a classifier-free-guidance pair is one 2B forward).
    """

    def __init__(self, model: cm.CharModel, cfg: MDMConfig = MDMConfig(),
                 sampler_cfg: sampler_lib.SamplerConfig
                 = sampler_lib.SamplerConfig(), device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.scfg = sampler_cfg
        self.frame_dim = sampler_cfg.frame_dim(model)
        self.rates = schedules.make_rates(cfg.diffusion_timesteps)
        self.compute_dtype = (torch.bfloat16 if cfg.bf16_compute
                              and self.device.type != "cpu" else None)
        self.denoise_calls = 0

    # ------------------------------------------------------------------
    def init(self, lib: ml.MotionLib, generator: torch.Generator,
             stats_samples: Optional[int] = None) -> MDMState:
        """Init params + dataset feature statistics; the state keeps
        drawing from ``generator`` (on the MDM's device).

        ``stats_samples=None`` (default) computes the EXACT per-window
        mean/std over every window of every motion (reference:
        diffusion/mdm.py:480-548); pass an int for the fast Monte-Carlo
        estimate (tests / throwaway inits)."""
        if stats_samples is None:
            mean, std = sampler_lib.compute_feature_stats_exact(
                self.model, self.scfg, lib)
        else:
            mean, std = sampler_lib.compute_feature_stats(
                self.model, self.scfg, lib, generator, stats_samples)
        cfg, scfg = self.cfg, self.scfg
        net = MDMTransformer(
            frame_dim=self.frame_dim, seq_len=scfg.seq_len,
            num_prev_states=scfg.num_prev_states, d_model=cfg.d_model,
            num_heads=cfg.num_heads, d_hid=cfg.d_hid,
            num_layers=cfg.num_layers, dropout=cfg.dropout,
            compute_dtype=self.compute_dtype, generator=generator,
            device=self.device)
        ema_net = copy.deepcopy(net).requires_grad_(False)
        # optax.adamw: weight decay on every parameter, before the step
        optimizer = torch.optim.AdamW(net.parameters(), lr=cfg.lr,
                                      betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=cfg.weight_decay)
        return MDMState(net=net, ema_net=ema_net, optimizer=optimizer,
                        mean=mean, std=std, generator=generator, step=0)

    def persistent_state(self, state: MDMState) -> dict:
        """Checkpointable snapshot (copies): params, EMA params, AdamW's
        moments and step, mean, std, the step and the generator's state."""
        params = dict(state.net.named_parameters())
        opt = state.optimizer.state

        def moment(name):
            return {k: (opt[p][name].detach().clone() if p in opt
                        else torch.zeros_like(p.detach()))
                    for k, p in params.items()}

        first = next(iter(params.values()))
        return {
            "params": {k: p.detach().clone() for k, p in params.items()},
            "ema_params": {k: p.detach().clone()
                           for k, p in state.ema_net.named_parameters()},
            "opt_state": {"exp_avg": moment("exp_avg"),
                          "exp_avg_sq": moment("exp_avg_sq"),
                          "step": int(opt[first]["step"]) if first in opt
                          else 0},
            "mean": state.mean.clone(), "std": state.std.clone(),
            "step": int(state.step),
            "generator": {"device": state.generator.device.type,
                          "state": state.generator.get_state()},
        }

    def merge_persistent(self, state: MDMState, restored: dict) -> MDMState:
        """Inverse of :meth:`persistent_state` against a fresh init: the
        parameters and AdamW's moments are copied in place, the rest
        replaces ``state``'s fields. The generator's stream carries over
        when the checkpoint was written on the same device type (a CUDA
        and a CPU generator hold different states); otherwise ``state``'s
        own generator is kept."""
        dev = self.device
        params = dict(state.net.named_parameters())
        opt = restored["opt_state"]
        if set(opt["exp_avg"]) != set(params):
            raise KeyError(f"AdamW moments {sorted(opt['exp_avg'])} do not "
                           f"match the parameters {sorted(params)}")
        state.net.load_state_dict(restored["params"])
        state.ema_net.load_state_dict(restored["ema_params"])
        for k, p in params.items():
            state.optimizer.state[p] = {
                # a CPU scalar, as AdamW keeps it when not capturable
                "step": torch.tensor(float(opt["step"])),
                "exp_avg": opt["exp_avg"][k].to(dev, torch.float32).clone(),
                "exp_avg_sq": opt["exp_avg_sq"][k].to(
                    dev, torch.float32).clone()}
        gen = restored.get("generator")
        if gen is not None and gen["device"] == state.generator.device.type:
            state.generator.set_state(gen["state"].cpu())
        return state.replace(mean=restored["mean"].to(dev, torch.float32),
                             std=restored["std"].to(dev, torch.float32),
                             step=int(restored["step"]))

    # ------------------------------------------------------------------
    def _standardize(self, state: MDMState, frames, prev_states):
        np_ = self.scfg.num_prev_states
        f = (frames - state.mean[np_:]) / state.std[np_:]
        p = (prev_states - state.mean[:np_]) / state.std[:np_]
        return f, p

    def _unstandardize_frames(self, state: MDMState, frames):
        np_ = self.scfg.num_prev_states
        return frames * state.std[np_:] + state.mean[np_:]

    # ------------------------------------------------------------------
    def _geometric_losses(self, state: MDMState, pred_std, gt_std,
                          batch: sampler_lib.WindowBatch
                          ) -> Dict[str, torch.Tensor]:
        """All losses in unstandardized (canonical) space, **per sample**
        (B,) so OOD rows can be masked (reference: mdm.py:617-754)."""
        cfg, scfg, model = self.cfg, self.scfg, self.model
        pred = self._unstandardize_frames(state, pred_std)
        gt = self._unstandardize_frames(state, gt_std)
        p = sampler_lib.split_features(model, pred)
        g = sampler_lib.split_features(model, gt)

        def m(x):
            return torch.mean(x, dim=tuple(range(1, x.dim())))

        def vel(x):
            return x[:, 1:] - x[:, :-1]

        losses = {}
        losses["simple_root_pos"] = cfg.w_simple_root_pos * m(
            (p["root_pos"] - g["root_pos"]) ** 2)
        losses["simple_root_rot"] = cfg.w_simple_root_rot * m(
            (p["root_rot"] - g["root_rot"]) ** 2)
        losses["simple_joint_rot"] = cfg.w_simple_joint_rot * m(
            (p["dof"] - g["dof"]) ** 2)
        losses["simple_body_pos"] = cfg.w_simple_body_pos * m(
            (p["joint_pos"] - g["joint_pos"]) ** 2)
        losses["simple_contacts"] = cfg.w_simple_contacts * m(
            (p["contacts"] - g["contacts"]) ** 2)
        losses["vel_root_pos"] = cfg.w_vel_root_pos * m(
            (vel(p["root_pos"]) - vel(g["root_pos"])) ** 2)
        losses["vel_root_rot"] = cfg.w_vel_root_rot * m(
            (vel(p["root_rot"]) - vel(g["root_rot"])) ** 2)
        losses["vel_joint_rot"] = cfg.w_vel_joint_rot * m(
            (vel(p["dof"]) - vel(g["dof"])) ** 2)

        # FK consistency: body positions implied by predicted dofs must
        # match the predicted joint_pos features
        joint_rot = cm.dof_to_rot(model, p["dof"])
        root_quat = rot.exp_map_to_quat(p["root_rot"])
        body_pos, body_rot = cm.forward_kinematics(model, p["root_pos"],
                                                   root_quat, joint_rot)
        fk_joint_pos = body_pos[..., 1:, :] - p["root_pos"][..., None, :]
        fk_flat = fk_joint_pos.reshape(fk_joint_pos.shape[:-2] + (-1,))
        losses["body_pos_consistency"] = cfg.w_body_pos_consistency * m(
            (fk_flat - p["joint_pos"]) ** 2)

        # heightfield collision: the engine's 52-point contact cloud, moved
        # by the FK body frames, must stay above the local hf (canonical
        # coords, hf relative to canon z), each point's radius its clearance
        # (reference: util/terrain_util.py:1895-1949)
        pb = model.contact_point_body
        q = body_rot[..., pb, :]
        pts = (rot.quat_rotate(q, model.contact_point_offset.expand(
            q.shape[:-1] + (3,))) + body_pos[..., pb, :])  # (B, T, P, 3)
        bx = pts[..., 0] / scfg.hf_dx + scfg.hf_num_x_neg
        by = pts[..., 1] / scfg.hf_dx + scfg.hf_num_y
        # max height over the 4 surrounding cells: a point laterally
        # penetrating a box side still sees the tall cell
        ix0 = torch.clamp(torch.floor(bx).long(), 0, scfg.hf_dim_x - 1)
        iy0 = torch.clamp(torch.floor(by).long(), 0, scfg.hf_dim_y - 1)
        ix1 = torch.clamp(ix0 + 1, max=scfg.hf_dim_x - 1)
        iy1 = torch.clamp(iy0 + 1, max=scfg.hf_dim_y - 1)
        bidx = torch.arange(batch.hf.shape[0], device=pts.device)[:, None,
                                                                  None]
        hf = batch.hf
        hf_at = torch.maximum(
            torch.maximum(hf[bidx, ix0, iy0], hf[bidx, ix0, iy1]),
            torch.maximum(hf[bidx, ix1, iy0], hf[bidx, ix1, iy1]))
        clearance = pts[..., 2] - model.contact_point_radius
        pen = torch.clamp(hf_at - clearance, min=0.0)
        losses["hf_collision"] = cfg.w_hf * m(pen ** 2)

        # target direction: net root xy displacement should follow target
        disp = p["root_pos"][:, -1, 0:2] - p["root_pos"][:, 0, 0:2]
        norm = torch.linalg.norm(disp, dim=-1, keepdim=True)
        dir_pred = disp / torch.clamp(norm, min=1e-3)
        has_target = torch.linalg.norm(batch.target_dir, dim=-1) > 1e-6
        cos = torch.sum(dir_pred * batch.target_dir, dim=-1)
        losses["target"] = cfg.w_target * torch.where(
            has_target, 1.0 - cos, torch.zeros_like(cos))
        return losses

    # ------------------------------------------------------------------
    def draw_loss(self, generator: torch.Generator, b: int) -> LossDraws:
        dev, scfg = self.device, self.scfg
        n = self.rates.num_timesteps

        def u():
            return torch.rand((b,), generator=generator, device=dev)

        return LossDraws(
            t=torch.randint(0, n, (b,), generator=generator, device=dev),
            noise=torch.randn((b, scfg.seq_len, self.frame_dim),
                              generator=generator, device=dev),
            u_hf=u(), u_target=u(), u_prev=u(), u_noised=u(),
            t_prev=torch.randint(0, n // 4, (b,), generator=generator,
                                 device=dev),
            prev_noise=torch.randn((b, scfg.num_prev_states, self.frame_dim),
                                   generator=generator, device=dev),
            ood_boxes=sampler_lib.draw_boxes(
                scfg, generator, b, (-scfg.max_h, scfg.max_h), 0.75, dev))

    def loss_fn(self, net: MDMTransformer, state: MDMState,
                batch: sampler_lib.WindowBatch, draws: LossDraws,
                dropout_generator: Optional[torch.Generator] = None):
        """(total, per-term losses) of one batch; ``dropout_generator``
        draws the denoiser's dropout masks (None: no dropout)."""
        cfg = self.cfg
        gt_std, prev_std = self._standardize(state, batch.frames,
                                             batch.prev_states)
        x_t = schedules.forward_diffusion(self.rates, gt_std, draws.t,
                                          draws.noise)

        # condition dropout masks
        hf_mask = draws.u_hf > cfg.hf_dropout
        tgt_mask = draws.u_target > cfg.target_dropout
        prev_mask = draws.u_prev > cfg.prev_state_dropout

        # prev-state noising with indicator (autoregressive robustness)
        noised_flag = draws.u_noised > cfg.prev_state_noise_chance
        prev_noisy = schedules.forward_diffusion(self.rates, prev_std,
                                                 draws.t_prev,
                                                 draws.prev_noise)
        prev_in = torch.where(noised_flag[:, None, None], prev_noisy,
                              prev_std)

        # OOD condition resampling (reference: mdm.py:903-940): some rows
        # get a fresh synthetic heightfield and a randomly rotated target;
        # their clean-signal matching losses are zeroed so only the
        # hf-collision and target objectives train on them.
        # A reference behaviour kept on purpose: the JAX loss_fn splits its
        # condition-dropout key twice, so the OOD draw IS the hf-dropout
        # uniform (every OOD row also has its heightfield masked out) and
        # the OOD angle IS the prev-state-dropout uniform.
        ood = torch.zeros_like(hf_mask)
        if cfg.ood_chance > 0:
            ood = draws.u_hf < cfg.ood_chance
            scfg = self.scfg
            hf = batch.hf
            center_z = hf[:, scfg.hf_num_x_neg, scfg.hf_num_y]
            ood_hf = sampler_lib.generate_ood_hfs(
                scfg, None, hf.shape[0], center_z, boxes=draws.ood_boxes)
            ang = draws.u_prev * 2 * math.pi
            rot_tgt = rot.rotate_2d_vec(batch.target_dir, ang)
            batch = batch.replace(
                hf=torch.where(ood[:, None, None], ood_hf, hf),
                target_dir=torch.where(ood[:, None], rot_tgt,
                                       batch.target_dir))

        pred = net(x_t, draws.t, prev_in, batch.hf, batch.target_dir,
                   hf_mask=hf_mask.float(), target_mask=tgt_mask.float(),
                   prev_state_mask=prev_mask.float(),
                   prev_state_noised=noised_flag.float(),
                   generator=dropout_generator)

        losses = self._geometric_losses(state, pred, gt_std, batch)
        losses = {k: torch.mean(v if k in _KEEP_ON_OOD
                                else torch.where(ood, torch.zeros_like(v), v))
                  for k, v in losses.items()}
        return sum(losses.values()), losses

    # ------------------------------------------------------------------
    def _clip_grads(self, net: MDMTransformer) -> None:
        """optax.clip_by_global_norm: scale every gradient by max / norm
        where the global norm exceeds max (no epsilon), without a host
        sync."""
        grads = [p.grad for p in net.parameters() if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.cfg.grad_clip, torch.ones_like(norm),
                            self.cfg.grad_clip / norm)
        torch._foreach_mul_(grads, scale)

    def train_step(self, lib: ml.MotionLib, state: MDMState,
                   batch_draws: Optional[sampler_lib.BatchDraws] = None,
                   loss_draws: Optional[LossDraws] = None):
        """One optimization step: sample a batch, the loss and its
        gradient, the clip, AdamW, the EMA. Updates ``state``'s modules and
        optimizer in place and returns (the new state, metrics as 0-d
        tensors); no host read. Draws not given come from
        ``state.generator``, and the dropout masks always do."""
        cfg = self.cfg
        g = state.generator
        with annotate("parc.mdm.batch"):
            if batch_draws is None:
                batch_draws = sampler_lib.draw_batch(self.scfg, lib, g,
                                                     cfg.batch_size)
            with torch.no_grad():
                batch = sampler_lib.batch_from_draws(self.model, self.scfg,
                                                     lib, batch_draws)
            if loss_draws is None:
                loss_draws = self.draw_loss(g, batch.frames.shape[0])
        with annotate("parc.mdm.forward"):
            total, losses = self.loss_fn(state.net, state, batch, loss_draws,
                                         dropout_generator=g)
        with annotate("parc.mdm.backward"):
            # the last step's gradients are dropped where this one's
            # accumulate (the forward reads none)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
        with annotate("parc.mdm.update"):
            self._clip_grads(state.net)
            state.optimizer.step()
            # EMA after warmup (decay 0 before ema_start copies the params)
            decay = cfg.ema_decay if state.step >= cfg.ema_start else 0.0
            with torch.no_grad():
                ema = list(state.ema_net.parameters())
                torch._foreach_mul_(ema, decay)
                torch._foreach_add_(ema, list(state.net.parameters()),
                                    alpha=1.0 - decay)
        metrics = {"total": total.detach(),
                   **{k: v.detach() for k, v in losses.items()}}
        return state.replace(step=state.step + 1), metrics

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------

    def _masks(self, b: int, use_prev_state):
        """Ones, zeros, and the prev-state mask (a bool, or a per-sample
        (b,) {0, 1} tensor: the reference's per-env use_prev_state,
        mgdm_env.py:644-645)."""
        ones = torch.ones((b,), device=self.device)
        return ones, torch.zeros_like(ones), ones * use_prev_state

    def _denoise(self, net, state, x_t, t, prev_std, hf, target_dir,
                 guidance_scale: float = 1.0, prev_noised=None,
                 cond_cache=None, use_prev_state=True):
        self.denoise_calls += 1
        b = x_t.shape[0]
        if cond_cache is not None:
            cond_toks, uncond_toks = cond_cache
            if guidance_scale == 1.0:
                return net(x_t, t, cond_toks=cond_toks)
            # the CFG pair as one 2B-batch encoder pass
            both = net(torch.cat([x_t, x_t], 0), torch.cat([t, t], 0),
                       cond_toks=torch.cat([cond_toks, uncond_toks], 0))
            cond, uncond = both[:b], both[b:]
            return uncond + guidance_scale * (cond - uncond)

        ones, zeros, prev_m = self._masks(b, use_prev_state)

        def call(tgt_m, prev_m):
            return net(x_t, t, prev_std, hf, target_dir, hf_mask=ones,
                       target_mask=tgt_m, prev_state_mask=prev_m,
                       prev_state_noised=prev_noised)

        cond = call(ones, prev_m)
        if guidance_scale == 1.0:
            return cond
        uncond = call(zeros, zeros)
        return uncond + guidance_scale * (cond - uncond)

    def _encode_cond_cache(self, net, prev_std, hf, target_dir,
                           guidance_scale: float, prev_noised=None,
                           use_prev_state=True):
        """The timestep-independent condition tokens, once per sampling
        run (the reference's fast_forward cache): the hf CNN, target and
        prev-state tokens are reused by every denoise step."""
        ones, zeros, prev_m = self._masks(prev_std.shape[0], use_prev_state)
        cond = net.encode_conditions(prev_std, hf, target_dir, ones, ones,
                                     prev_m, prev_noised)
        uncond = (net.encode_conditions(prev_std, hf, target_dir, ones,
                                        zeros, zeros, prev_noised)
                  if guidance_scale != 1.0 else None)
        return cond, uncond

    def _post_x0(self, state, x0, hf, guidance, target_xy, inpaint_frames,
                 inpaint_mask):
        """Hooks applied to the predicted clean signal each denoise step:
        dof-limit projection, gradient guidance, in-painting (reference:
        mdm.py:1115-1145 project_dofs + apply_guidance + apply_in_paint)."""
        from parc_torch.diffusion import guidance as guid_lib
        x0 = self._project_dofs(state, x0)
        if guidance is not None and guidance.active:
            x0 = guid_lib.apply_guidance(self, state, x0, hf, target_xy,
                                         guidance)
        if inpaint_frames is not None:
            x0 = guid_lib.apply_inpaint(x0, inpaint_frames, inpaint_mask)
        return x0

    def _project_dofs(self, state: MDMState, x_std):
        """Clamp predicted joint dofs to joint limits (unstandardized
        space; reference: mdm.py project_dofs / kin_char_model:951-961)."""
        x = self._unstandardize_frames(state, x_std)
        i2 = 3 + 3 + 3 * (self.model.num_bodies - 1)
        i3 = i2 + self.model.dof_size
        dof = torch.minimum(torch.maximum(x[..., i2:i3],
                                          self.model.dof_limits_lower),
                            self.model.dof_limits_upper)
        x = torch.cat([x[..., :i2], dof, x[..., i3:]], dim=-1)
        np_ = self.scfg.num_prev_states
        return (x - state.mean[np_:]) / state.std[np_:]

    def _sampling_inputs(self, state, use_ema, prev_states, inpaint_frames):
        net = state.ema_net if use_ema else state.net
        np_ = self.scfg.num_prev_states
        prev_std = (prev_states - state.mean[:np_]) / state.std[:np_]
        if inpaint_frames is not None:
            inpaint_frames = (inpaint_frames - state.mean[np_:]) \
                / state.std[np_:]
        return net, prev_std, inpaint_frames

    def _initial_noise(self, generator, b, noise):
        if noise is not None:
            return noise
        return torch.randn((b, self.scfg.seq_len, self.frame_dim),
                           generator=generator, device=self.device)

    @torch.no_grad()
    def ddim_sample(self, state: MDMState, generator: torch.Generator,
                    prev_states, hf, target_dir, stride: int = 5,
                    guidance_scale: float = 1.0, use_ema: bool = True,
                    guidance=None, target_xy=None, inpaint_frames=None,
                    inpaint_mask=None, use_prev_state=True,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """DDIM (eta=0) sampling of one 15-frame window (standardized in/out
        handled internally; returns unstandardized canonical frames).

        guidance: optional GuidanceParams; target_xy (B, 2) canonical;
        inpaint_frames (B, T, F) unstandardized + inpaint_mask (T,) or
        (B, T) pins frames each step. ``noise`` is the initial x_T
        (drawn from ``generator`` if None)."""
        net, prev_std, inpaint_frames = self._sampling_inputs(
            state, use_ema, prev_states, inpaint_frames)
        b = prev_states.shape[0]
        ac = self.rates.alphas_cumprod
        timesteps = np.arange(0, self.rates.num_timesteps, stride)[::-1]
        x = self._initial_noise(generator, b, noise)

        strong_hf = guidance is not None and guidance.strong_hf_guidance
        # the condition cache is invalid under strong hf guidance, which
        # re-tokenizes a changing hf
        cond_cache = None if strong_hf else self._encode_cond_cache(
            net, prev_std, hf, target_dir, guidance_scale,
            use_prev_state=use_prev_state)
        one = np.float32(1.0)
        for idx, t_cur in enumerate(timesteps):
            t_batch = torch.full((b,), int(t_cur), dtype=torch.long,
                                 device=self.device)
            with annotate("parc.ddim.denoise"):
                if strong_hf:
                    from parc_torch.diffusion import guidance as guid_lib
                    x0, _ = guid_lib.hf_guidance_x0(
                        self, net, state, x, t_batch, prev_std, hf,
                        target_dir, target_xy, guidance,
                        use_prev_state=use_prev_state)
                else:
                    x0 = self._denoise(net, state, x, t_batch, prev_std, hf,
                                       target_dir, guidance_scale,
                                       cond_cache=cond_cache)
            x0 = self._post_x0(state, x0, hf, guidance, target_xy,
                               inpaint_frames, inpaint_mask)
            # f32 scalars from the host table, as the JAX package computes
            ac_t = ac[t_cur]
            ac_next = ac[timesteps[idx + 1]] if idx + 1 < len(timesteps) \
                else one
            eps = (x - float(np.sqrt(ac_t)) * x0) / float(np.sqrt(one - ac_t))
            x = (float(np.sqrt(ac_next)) * x0
                 + float(np.sqrt(np.maximum(one - ac_next, 0))) * eps)
        return self._unstandardize_frames(state, x)

    @torch.no_grad()
    def ddpm_sample(self, state: MDMState, generator: torch.Generator,
                    prev_states, hf, target_dir,
                    guidance_scale: float = 1.0, use_ema: bool = True,
                    guidance=None, target_xy=None, inpaint_frames=None,
                    inpaint_mask=None, use_prev_state=True,
                    noise: Optional[torch.Tensor] = None,
                    step_noise: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """Full ancestral DDPM sampling (predict-x0 posterior). ``noise``
        is the initial x_T and ``step_noise`` (num_timesteps, B, T, F) the
        noise of each step, first step first (drawn from ``generator`` if
        None)."""
        net, prev_std, inpaint_frames = self._sampling_inputs(
            state, use_ema, prev_states, inpaint_frames)
        b = prev_states.shape[0]
        n = self.rates.num_timesteps
        r = self.rates
        x = self._initial_noise(generator, b, noise)
        cond_cache = self._encode_cond_cache(net, prev_std, hf, target_dir,
                                             guidance_scale,
                                             use_prev_state=use_prev_state)
        half = np.float32(0.5)
        for t_rev in range(n):
            t_cur = n - 1 - t_rev
            t_batch = torch.full((b,), t_cur, dtype=torch.long,
                                 device=self.device)
            x0 = self._denoise(net, state, x, t_batch, prev_std, hf,
                               target_dir, guidance_scale,
                               cond_cache=cond_cache)
            x0 = self._post_x0(state, x0, hf, guidance, target_xy,
                               inpaint_frames, inpaint_mask)
            mean = (float(r.posterior_mean_x0_coef[t_cur]) * x0
                    + float(r.posterior_mean_xt_coef[t_cur]) * x)
            z = (step_noise[t_rev] if step_noise is not None else
                 torch.randn(x.shape, generator=generator,
                             device=self.device))
            sd = (float(np.exp(half * r.posterior_log_variance_clipped[t_cur]))
                  if t_cur > 0 else 0.0)
            x = mean + sd * z
        return self._unstandardize_frames(state, x)
