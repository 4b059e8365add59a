"""Sampling-time guidance for the MDM: gradient guidance on the predicted
clean signal, heightfield-optimizing guidance, and in-painting.

Reference parity: diffusion/mdm.py:1444-1542 (apply_guidance: target-xy /
hf-collision / speed-acc-jerk gradient steps on the denoised x0),
:1562-1651 (predict_x0_hf_guidance: 10 SGD+momentum steps optimizing the
conditioning heightfield itself, grads masked near the character and in
the target direction), :1544-1560 (apply_in_paint), and the default
weights/thresholds from diffusion/diffusion_util.py:38-57.

Each hook is a function on the standardized window; the gradients come
from ``torch.autograd.grad`` with grad enabled locally, so the samplers'
loops stay under ``torch.no_grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from reference.anim import char_model as cm
from reference.diffusion import sampler as sampler_lib
from reference.utils import rotation as rot


@dataclasses.dataclass(frozen=True)
class GuidanceParams:
    """Static guidance configuration."""

    guidance_str: float = 0.1
    # target-xy pull (reference: mdm.py:1474-1481)
    use_target: bool = False
    w_target: float = 1.0
    # heightfield penetration (reference: mdm.py:1489-1502)
    use_hf: bool = False
    w_hf: float = 10.0
    # derivative limits (reference: diffusion_util.py:49-57)
    guide_speed: bool = False
    guide_acc: bool = False
    guide_jerk: bool = False
    max_speed: float = 16.1498
    max_acc: float = 343.0243
    max_jerk: float = 14062.6680
    w_speed: float = 1.0 / 16.1498
    w_acc: float = 1.0 / 343.0243
    w_jerk: float = 1.0 / 14062.6680
    # strong hf guidance: optimize the heightfield itself
    strong_hf_guidance: bool = False
    hf_iters: int = 10
    hf_momentum: float = 0.9

    @property
    def active(self) -> bool:
        return (self.use_target or self.use_hf or self.guide_speed
                or self.guide_acc or self.guide_jerk)


def _fk(model: cm.CharModel, feats: dict):
    """FK body positions and rotations from split features."""
    joint_rot = cm.dof_to_rot(model, feats["dof"])
    root_quat = rot.exp_map_to_quat(feats["root_rot"])
    return cm.forward_kinematics(model, feats["root_pos"], root_quat,
                                 joint_rot)  # (..., T, nb, 3), (..., 4)


def _body_contact_points(model: cm.CharModel, feats):
    """Character surface sample points in canonical coords: the contact
    point cloud baked into the char model (reference:
    util/geom_util.py:788-931 get_char_point_samples)."""
    body_pos, body_rot = _fk(model, feats)
    q = body_rot[..., model.contact_point_body, :]
    return body_pos[..., model.contact_point_body, :] + rot.quat_rotate(
        q, model.contact_point_offset.expand(q.shape[:-1] + (3,)))


def _hf_at_points(mdm, hf: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Nearest-cell height of the canonical local hf at canonical xy."""
    scfg = mdm.scfg
    bx = xy[..., 0] / scfg.hf_dx + scfg.hf_num_x_neg
    by = xy[..., 1] / scfg.hf_dx + scfg.hf_num_y
    ix = torch.clamp(torch.round(bx).long(), 0, scfg.hf_dim_x - 1)
    iy = torch.clamp(torch.round(by).long(), 0, scfg.hf_dim_y - 1)
    b_idx = torch.arange(hf.shape[0], device=hf.device)
    b_idx = b_idx.reshape((-1,) + (1,) * (ix.dim() - 1))
    return hf[b_idx, ix, iy]


def guidance_loss(mdm, state, x_std: torch.Tensor, hf: torch.Tensor,
                  target_xy: Optional[torch.Tensor],
                  gp: GuidanceParams) -> torch.Tensor:
    """Scalar guidance loss of a standardized window batch.

    x_std: (B, T, F) standardized frames; hf: (B, X, Y) canonical local
    heightfield (canonical z-relative); target_xy: (B, 2) canonical-frame
    target or None.
    """
    model = mdm.model
    x = mdm._unstandardize_frames(state, x_std)
    feats = sampler_lib.split_features(model, x)
    total = torch.zeros((), device=x.device)

    if gp.use_target and target_xy is not None:
        diff = target_xy[:, None, :] - feats["root_pos"][..., 0:2]
        total = total + gp.w_target * 0.5 * torch.sum(diff ** 2)

    if gp.use_hf:
        pts = _body_contact_points(model, feats)
        ground = _hf_at_points(mdm, hf, pts[..., 0:2])
        pen = torch.clamp(pts[..., 2] - ground, max=0.0)
        total = total + gp.w_hf * 0.5 * torch.sum(pen ** 2)
    if gp.guide_speed or gp.guide_acc or gp.guide_jerk:
        body_pos, _ = _fk(model, feats)
        dt = 1.0 / mdm.scfg.fps

        # eps-guarded norms: the norm's gradient is NaN at exactly zero,
        # and static predictions hit zero vel/acc/jerk
        def mag(v):
            return torch.sqrt(torch.sum(v ** 2, dim=-1) + 1e-12)

        vel = body_pos[:, 1:] - body_pos[:, :-1]
        if gp.guide_speed:
            total = total + gp.w_speed * torch.sum(
                torch.clamp(mag(vel) - gp.max_speed * dt, min=0.0))
        acc = vel[:, 1:] - vel[:, :-1]
        if gp.guide_acc:
            total = total + gp.w_acc * torch.sum(
                torch.clamp(mag(acc) - gp.max_acc * dt ** 2, min=0.0))
        if gp.guide_jerk:
            jerk = acc[:, 1:] - acc[:, :-1]
            total = total + gp.w_jerk * torch.sum(
                torch.clamp(mag(jerk) - gp.max_jerk * dt ** 3, min=0.0))
    return total


def apply_guidance(mdm, state, x_std: torch.Tensor, hf: torch.Tensor,
                   target_xy: Optional[torch.Tensor],
                   gp: GuidanceParams) -> torch.Tensor:
    """One gradient step on the (standardized) denoised window
    (reference: mdm.py:1444-1542 applied to predicted x0)."""
    if not gp.active:
        return x_std
    with torch.enable_grad():
        xs = x_std.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(
            guidance_loss(mdm, state, xs, hf, target_xy, gp), xs)
    return x_std - gp.guidance_str * grad


def apply_inpaint(x_std: torch.Tensor, paint_std: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Overwrite masked frames with fixed (standardized) values each
    denoise step (reference: mdm.py:1544-1560 pins the final frame).

    mask: (T,) or (B, T) boolean — True = replace with paint_std.
    """
    m = mask[..., None].to(x_std.dtype)
    return m * paint_std + (1.0 - m) * x_std


def hf_guidance_x0(mdm, net, state, x_t, t_batch, prev_std, hf,
                   target_dir, target_xy, gp: GuidanceParams,
                   use_prev_state=True):
    """Strong hf guidance: optimize the conditioning heightfield so the
    denoised motion satisfies target/collision objectives, grads masked
    out near the character and in the target direction
    (reference: mdm.py:1562-1651, SGD momentum 0.9, 10 iters).

    Returns (x0_std, optimized hf): x0 from the last heightfield whose
    gradient was taken (from ``hf`` itself when ``hf_iters`` is 0).
    """
    scfg = mdm.scfg
    dev = hf.device

    # cells that must not move: around the character and toward the target
    xs = (torch.arange(scfg.hf_dim_x, device=dev) - scfg.hf_num_x_neg) \
        * scfg.hf_dx
    ys = (torch.arange(scfg.hf_dim_y, device=dev) - scfg.hf_num_y) \
        * scfg.hf_dx
    gx, gy = torch.meshgrid(xs.float(), ys.float(), indexing="ij")
    near = (torch.abs(gx) < 3 * scfg.hf_dx) & (torch.abs(gy) < 3 * scfg.hf_dx)
    if target_xy is not None:
        dot = (gx[None] * target_xy[:, 0, None, None]
               + gy[None] * target_xy[:, 1, None, None])
        frozen = near[None] | (dot > 0)
    else:
        frozen = near[None].expand(hf.shape)
    grad_mask = 1.0 - frozen.to(hf.dtype)

    def denoise(hf_cur):
        return mdm._denoise(net, state, x_t, t_batch, prev_std, hf_cur,
                            target_dir, 1.0, use_prev_state=use_prev_state)

    x0 = denoise(hf) if gp.hf_iters == 0 else None
    hf_cur, mom = hf, torch.zeros_like(hf)
    for _ in range(gp.hf_iters):
        with torch.enable_grad():
            h = hf_cur.detach().requires_grad_(True)
            x0 = denoise(h)
            (g,) = torch.autograd.grad(
                guidance_loss(mdm, state, x0, h, target_xy, gp), h)
        x0 = x0.detach()
        mom = gp.hf_momentum * mom + g * grad_mask
        hf_cur = torch.clamp(hf_cur - gp.guidance_str * mom, -scfg.max_h,
                             scfg.max_h)
    return x0, hf_cur
