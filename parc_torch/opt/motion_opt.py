"""Terrain-aware kinematic motion optimization.

Polishes MDM-generated motions against their terrain: Adam over the frame
variables (root pos, root rot exp-map, joint dofs) with losses for source
matching, smoothness, terrain penetration, tagged-contact distance, foot
sliding, body constraints and jerk. The Adam steps run as a host loop of
``torch.optim.Adam`` (optax's ``adam``: b1 0.9, b2 0.999, eps 1e-8 added
after the square root) with no host read inside it.

Gradients follow JAX's at ties: the min/max reductions are ``torch.amin`` /
``torch.amax`` and the elementwise ones ``torch.maximum``, which split the
gradient evenly among tied elements as ``jnp.min`` / ``jnp.maximum`` do
(the 52 contact points of a flat foot on flat ground tie); norms that may be
zero are ``sqrt(sum(x**2) + 1e-12)``.

Reference parity: tools/motion_opt/motion_optimization.py:17-501
(losses + Adam schedule; defaults from PARC/kin_gen_default.yaml opt:).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from parc_torch.anim import char_model as cm
from parc_torch.utils import rotation as rot
from parc_torch.utils import terrain as terrain_lib


@dataclasses.dataclass(frozen=True)
class MotionOptConfig:
    iters: int = 3000
    lr: float = 1e-3
    fps: float = 30.0
    w_source_pos: float = 1.0
    w_source_rot: float = 0.5
    w_source_dof: float = 0.5
    w_smooth: float = 0.1
    w_penetration: float = 10.0
    w_contact: float = 5.0
    w_slide: float = 2.0
    # strong relative to the source losses, like the reference's 1000:1
    # w_body_constraints:w_root_pos ratio (kin_gen_default.yaml opt:)
    w_body_constraint: float = 20.0
    w_jerk: float = 1e-6
    jerk_clamp: float = 11666.0
    contact_eps: float = 0.03
    # auto-estimated contact-run constraints (reference:
    # motion_optimization.py:34-181, kin_gen_default.yaml
    # auto_compute_body_constraints)
    auto_body_constraints: bool = True
    max_constraints: int = 32


@dataclasses.dataclass
class BodyConstraints:
    """Fixed-shape per-contact-run constraints: during frames
    [start, end], body ``body_id`` is pinned near ``point`` (a terrain-
    surface-projected average contact location). Padded to a static K with
    ``valid`` flags; a stack of C clips' constraints has fields (C, K, ...).

    Reference parity: tools/motion_opt/motion_optimization.py:34-181
    (BodyConstraint list per body) + the BODY_CONSTRAINT_LOSS application
    (:286-330, sphere |sd| pin / box clamp(sd, min=0)).
    """

    body_ids: torch.Tensor   # (K,) int64
    starts: torch.Tensor     # (K,) int64
    ends: torch.Tensor       # (K,) int64
    points: torch.Tensor     # (K, 3)
    offsets: torch.Tensor    # (K, 3) body-frame geom-center offset
    radius: torch.Tensor     # (K,)
    pin: torch.Tensor        # (K,) 1.0 = |sd| pin (sphere), 0.0 = clamp-only
    valid: torch.Tensor      # (K,) bool

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())

    @staticmethod
    def stack(items: Sequence["BodyConstraints"]) -> "BodyConstraints":
        return BodyConstraints(**{
            f.name: torch.stack([getattr(b, f.name) for b in items])
            for f in dataclasses.fields(BodyConstraints)})


def _consecutive_runs(mask) -> list:
    """[(start, end)] inclusive index ranges of consecutive True runs."""
    idx = np.nonzero(np.asarray(mask))[0]
    if len(idx) == 0:
        return []
    breaks = np.nonzero(np.diff(idx) > 1)[0]
    starts = np.concatenate([[idx[0]], idx[breaks + 1]])
    ends = np.concatenate([idx[breaks], [idx[-1]]])
    return list(zip(starts.tolist(), ends.tolist()))


def _fk(model: cm.CharModel, frames34: torch.Tensor):
    root_rot = rot.exp_map_to_quat(frames34[..., 3:6])
    joint_rot = cm.dof_to_rot(model, frames34[..., 6:])
    return cm.forward_kinematics(model, frames34[..., 0:3], root_rot,
                                 joint_rot)


def _as_tensor(model: cm.CharModel, x) -> torch.Tensor:
    """Frames or contacts (a tensor or host array) on the model's device."""
    if isinstance(x, torch.Tensor):
        return x.to(model.device)
    return torch.as_tensor(np.asarray(x, np.float32), device=model.device)


def compute_approx_body_constraints(model: cm.CharModel,
                                    terrain: terrain_lib.Terrain,
                                    frames34, contacts,
                                    cfg: MotionOptConfig = MotionOptConfig(),
                                    contact_threshold: float = 0.9,
                                    project_iters: int = 300,
                                    project_lr: float = 0.01
                                    ) -> BodyConstraints:
    """Estimate contact-run constraints from tagged contacts.

    Per end-effector body (feet/hands): consecutive contact runs become one
    constraint each, anchored at the run-average body-center position and
    projected onto the terrain surface by ``project_iters`` gradient steps
    on sdf^2 (the reference runs 1000 host SGD steps per point,
    motion_optimization.py:93-116).
    """
    dev = model.device
    frames34 = _as_tensor(model, frames34)
    with torch.no_grad():
        body_pos, body_rot = _fk(model, frames34)

    # per-body effective contact radius + mean contact-point offset from
    # the body's contact-point cloud
    nb = model.num_bodies
    cpb = model.contact_point_body.cpu().numpy()
    cpo = model.contact_point_offset.cpu().numpy()
    cpr = model.contact_point_radius.cpu().numpy()
    eff_radius = np.zeros(nb, np.float32)
    mean_off = np.zeros((nb, 3), np.float32)
    n_pts = np.zeros(nb, np.int64)
    for b in range(nb):
        sel = cpb == b
        if sel.any():
            eff_radius[b] = float(
                (np.linalg.norm(cpo[sel], axis=-1) + cpr[sel]).max())
            mean_off[b] = cpo[sel].mean(0)
            n_pts[b] = int(sel.sum())

    targets = [i for i, n in enumerate(model.body_names)
               if ("foot" in n or "hand" in n) and n_pts[i] > 0]
    off = torch.as_tensor(mean_off, device=dev).expand(body_pos.shape)
    centers = (body_pos + rot.quat_rotate(body_rot, off)).cpu().numpy()
    contacts_np = (contacts.cpu().numpy() if isinstance(contacts,
                                                        torch.Tensor)
                   else np.asarray(contacts))

    rows = []
    for b in targets:
        for s, e in _consecutive_runs(contacts_np[:, b] > contact_threshold):
            rows.append((b, s, e, centers[s:e + 1, b].mean(0),
                         eff_radius[b], 1.0 if n_pts[b] == 1 else 0.0))
    k = cfg.max_constraints
    rows = rows[:k]
    body_ids = np.zeros(k, np.int64)
    starts = np.zeros(k, np.int64)
    ends = np.full(k, -1, np.int64)
    points = np.zeros((k, 3), np.float32)
    offsets = np.zeros((k, 3), np.float32)
    radius = np.ones(k, np.float32)
    pin = np.zeros(k, np.float32)
    valid = np.zeros(k, bool)
    for i, (b, s, e, p, r, pin_i) in enumerate(rows):
        body_ids[i], starts[i], ends[i] = b, s, e
        points[i] = p
        offsets[i] = mean_off[b]
        radius[i] = r
        pin[i] = pin_i
        valid[i] = True

    pts = torch.as_tensor(points, device=dev)
    if rows:
        # project every constraint point onto the terrain surface at once
        for _ in range(project_iters):
            p = pts.detach().requires_grad_(True)
            with torch.enable_grad():
                sq = torch.sum(terrain_lib.terrain_sdf(terrain, p,
                                                       inverted=False)**2)
                g, = torch.autograd.grad(sq, p)
            pts = pts - project_lr * g

    def t(x):
        return torch.as_tensor(x, device=dev)
    return BodyConstraints(
        body_ids=t(body_ids), starts=t(starts), ends=t(ends),
        points=pts.detach(), offsets=t(offsets), radius=t(radius),
        pin=t(pin), valid=t(valid))


def _active(bc: BodyConstraints, t_len: int) -> torch.Tensor:
    """(..., T, K) frames where each constraint applies."""
    t_idx = torch.arange(t_len, device=bc.starts.device)[:, None]
    return ((t_idx >= bc.starts[..., None, :])
            & (t_idx <= bc.ends[..., None, :]) & bc.valid[..., None, :])


def body_constraint_loss(cfg: MotionOptConfig, bc: BodyConstraints,
                         body_pos: torch.Tensor,
                         body_rot: torch.Tensor) -> torch.Tensor:
    """Mean constraint violation; body_pos/rot (..., T, J, 3)/(..., T, J, 4)
    with bc fields (..., K) -> (...)."""
    t_len = body_pos.shape[-3]
    active = _active(bc, t_len)                               # (..., T, K)

    def gather(x):
        idx = bc.body_ids[..., None, :, None].expand(
            x.shape[:-2] + bc.body_ids.shape[-1:] + x.shape[-1:])
        return torch.gather(x, -2, idx)                     # (..., T, K, d)

    bp, br = gather(body_pos), gather(body_rot)
    pos = bp + rot.quat_rotate(br, bc.offsets[..., None, :, :].expand(
        bp.shape))
    diff = pos - bc.points[..., None, :, :]
    # sqrt(sum^2 + eps): gradient finite at zero distance
    dist = torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-12)
    sd = dist - bc.radius[..., None, :]
    per = torch.where(bc.pin[..., None, :] > 0.5, terrain_lib._abs(sd),
                      torch.maximum(sd, torch.zeros_like(sd)))
    return torch.sum(torch.where(active, per, torch.zeros_like(per)),
                     dim=(-2, -1)) / t_len


def constraint_slide_mask(bc: BodyConstraints, t_len: int,
                          num_bodies: int) -> torch.Tensor:
    """(..., T, J) True where a body constraint overrides the sliding loss
    (reference: motion_optimization.py:330 nulls sliding during
    constrained frames: the constraint pins the body instead)."""
    onehot = F.one_hot(bc.body_ids, num_bodies).float()      # (..., K, J)
    return torch.einsum("...tk,...kj->...tj",
                        _active(bc, t_len).float(), onehot) > 0


def _body_points(model: cm.CharModel, frames34: torch.Tensor):
    body_pos, body_rot = _fk(model, frames34)
    bidx = model.contact_point_body
    q = body_rot[..., bidx, :]
    pts = body_pos[..., bidx, :] + rot.quat_rotate(
        q, model.contact_point_offset.expand(q.shape[:-1] + (3,)))
    return pts, body_pos, body_rot


def _relu(x: torch.Tensor) -> torch.Tensor:
    """jnp.maximum(x, 0): half the gradient at 0, as JAX gives it."""
    return torch.maximum(x, torch.zeros_like(x))


def _per_body_min(model: cm.CharModel, h_above: torch.Tensor
                  ) -> torch.Tensor:
    """(..., P) point heights -> (..., J) lowest point of each body (inf
    for a body without points); ties share the gradient."""
    onehot = F.one_hot(model.contact_point_body, model.num_bodies)
    inf = torch.full((), float("inf"), device=h_above.device)
    return torch.amin(torch.where(onehot.T > 0, h_above[..., None, :], inf),
                      dim=-1)


def motion_opt_loss(model: cm.CharModel, cfg: MotionOptConfig,
                    terrain: terrain_lib.Terrain, frames34: torch.Tensor,
                    source34: torch.Tensor, contacts: torch.Tensor,
                    constraints: Optional[BodyConstraints] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss for a (T, 34) motion on its terrain."""
    losses = {}
    losses["source_pos"] = cfg.w_source_pos * torch.mean(
        (frames34[..., 0:3] - source34[..., 0:3])**2)
    losses["source_rot"] = cfg.w_source_rot * torch.mean(
        (frames34[..., 3:6] - source34[..., 3:6])**2)
    losses["source_dof"] = cfg.w_source_dof * torch.mean(
        (frames34[..., 6:] - source34[..., 6:])**2)

    acc = frames34[2:] - 2 * frames34[1:-1] + frames34[:-2]
    losses["smooth"] = cfg.w_smooth * torch.mean(acc**2)

    pts, body_pos, body_rot = _body_points(model, frames34)
    ground = terrain_lib.get_hf_val_bilinear(terrain, pts[..., 0:2])
    h_above = pts[..., 2] - model.contact_point_radius - ground

    losses["penetration"] = cfg.w_penetration * torch.mean(
        _relu(-h_above)**2)

    # tagged contacts: the body's lowest point should touch the surface
    tagged = contacts > 0.5
    cdist = torch.where(
        tagged, _relu(_per_body_min(model, h_above) - cfg.contact_eps), 0.0)
    # pseudo-huber keeps gradients bounded
    losses["contact"] = cfg.w_contact * torch.mean(
        torch.sqrt(cdist**2 + 1e-4) - 1e-2)

    # sliding: contact-tagged body points should not move horizontally
    vel = (pts[1:] - pts[:-1]) * cfg.fps
    cpb = model.contact_point_body
    pt_tagged = (tagged[..., cpb] & (h_above < cfg.contact_eps))[:-1]
    if constraints is not None:
        # a body constraint pins the body at a fixed point: it overrides
        # (nulls) the competing sliding loss during constrained frames
        # (reference: motion_optimization.py:330)
        cmask = constraint_slide_mask(constraints, frames34.shape[0],
                                      model.num_bodies)
        pt_tagged = pt_tagged & ~cmask[:-1][..., cpb]
    slide = torch.where(pt_tagged, torch.sum(vel[..., 0:2]**2, dim=-1), 0.0)
    losses["slide"] = cfg.w_slide * torch.mean(
        torch.sqrt(slide + 1e-6) - 1e-3)

    if constraints is not None:
        losses["body_constraint"] = cfg.w_body_constraint * \
            body_constraint_loss(cfg, constraints, body_pos, body_rot)

    # jerk clamp on body positions; NOT a norm: a static motion has zero
    # jerk, and a norm's gradient there is NaN
    jerk = (body_pos[3:] - 3 * body_pos[2:-1] + 3 * body_pos[1:-2]
            - body_pos[:-3]) * cfg.fps**3
    jerk_mag = torch.sqrt(torch.sum(jerk**2, dim=-1) + 1e-12)
    losses["jerk"] = cfg.w_jerk * torch.mean(
        _relu(jerk_mag - cfg.jerk_clamp)**2)

    total = sum(losses.values())
    return total, losses


def _adam(loss_fn, x0: torch.Tensor, cfg: MotionOptConfig) -> torch.Tensor:
    """``cfg.iters`` Adam steps on ``loss_fn(x) -> (total, terms)``; returns
    the final x (no host read inside the loop)."""
    x = x0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    with torch.enable_grad():
        for _ in range(cfg.iters):
            opt.zero_grad(set_to_none=True)
            total, _ = loss_fn(x)
            total.backward()
            opt.step()
    return x.detach()


def motion_contact_optimization(model: cm.CharModel,
                                terrain: terrain_lib.Terrain,
                                frames34, contacts,
                                cfg: MotionOptConfig = MotionOptConfig(),
                                constraints: Optional[BodyConstraints] = None):
    """Optimize a (T, 34) motion; returns (optimized frames, final losses).

    With ``cfg.auto_body_constraints`` (default, reference
    kin_gen_default.yaml auto_compute_body_constraints) contact-run
    constraints are estimated from the tagged contacts first.
    """
    source = _as_tensor(model, frames34)
    contacts = _as_tensor(model, contacts)
    if constraints is None and cfg.auto_body_constraints \
            and cfg.w_body_constraint > 0:
        constraints = compute_approx_body_constraints(
            model, terrain, source, contacts, cfg)

    def loss_fn(x):
        return motion_opt_loss(model, cfg, terrain, x, source, contacts,
                               constraints=constraints)

    x = _adam(loss_fn, source, cfg)
    with torch.no_grad():
        _, final = loss_fn(x)
    return x, {k: float(v) for k, v in final.items()}


def _mmean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-clip masked mean: x (K, T, ...) weighted by w (K, T) -> (K,).

    Averages over every non-K axis with w broadcast across the trailing
    dims: for a full mask this equals the mean over the clip, so each
    clip's term matches the single-clip loss exactly."""
    trailing = 1.0
    for d in x.shape[2:]:
        trailing *= d
    wb = w.reshape(w.shape + (1,) * (x.dim() - w.dim()))
    num = torch.sum(x * wb, dim=tuple(range(1, x.dim())))
    den = torch.sum(w, dim=1) * trailing
    return num / torch.clamp(den, min=1e-9)


def motion_opt_loss_batched(model: cm.CharModel, cfg: MotionOptConfig,
                            stacked: terrain_lib.Terrain,
                            terrain_idx: torch.Tensor,
                            frames34: torch.Tensor, source34: torch.Tensor,
                            contacts: torch.Tensor, valid: torch.Tensor,
                            constraints: Optional[BodyConstraints] = None
                            ) -> Tuple[torch.Tensor,
                                       Dict[str, torch.Tensor]]:
    """Per-clip totals for K length-padded motions at once.

    frames34/source34 (K, T, 34); contacts (K, T, J); valid (K, T): padded
    frames (valid 0) contribute nothing to any term, so each clip's loss
    equals its single-clip :func:`motion_opt_loss` on the unpadded motion.
    Each row reads ITS terrain from the stacked terrain. constraints, if
    given, is a K-leading stacked BodyConstraints. Returns ((K,) totals,
    dict of (K,) per-clip losses)."""
    v = valid.to(frames34.dtype)
    losses = {}
    losses["source_pos"] = cfg.w_source_pos * _mmean(
        (frames34[..., 0:3] - source34[..., 0:3])**2, v)
    losses["source_rot"] = cfg.w_source_rot * _mmean(
        (frames34[..., 3:6] - source34[..., 3:6])**2, v)
    losses["source_dof"] = cfg.w_source_dof * _mmean(
        (frames34[..., 6:] - source34[..., 6:])**2, v)

    v3 = v[:, 2:] * v[:, 1:-1] * v[:, :-2]
    acc = frames34[:, 2:] - 2 * frames34[:, 1:-1] + frames34[:, :-2]
    losses["smooth"] = cfg.w_smooth * _mmean(acc**2, v3)

    pts, body_pos, body_rot = _body_points(model, frames34)
    ground = terrain_lib.get_hf_val_bilinear_stacked(
        stacked, terrain_idx, pts[..., 0:2])
    h_above = pts[..., 2] - model.contact_point_radius - ground

    losses["penetration"] = cfg.w_penetration * _mmean(_relu(-h_above)**2,
                                                       v)

    tagged = contacts > 0.5
    cdist = torch.where(
        tagged, _relu(_per_body_min(model, h_above) - cfg.contact_eps), 0.0)
    losses["contact"] = cfg.w_contact * _mmean(
        torch.sqrt(cdist**2 + 1e-4) - 1e-2, v)

    vel = (pts[:, 1:] - pts[:, :-1]) * cfg.fps
    cpb = model.contact_point_body
    pt_tagged = (tagged[..., cpb] & (h_above < cfg.contact_eps))[:, :-1]
    if constraints is not None:
        cmask = constraint_slide_mask(constraints, frames34.shape[1],
                                      model.num_bodies)
        pt_tagged = pt_tagged & ~cmask[:, :-1][..., cpb]
    slide = torch.where(pt_tagged, torch.sum(vel[..., 0:2]**2, dim=-1), 0.0)
    v2 = v[:, 1:] * v[:, :-1]
    losses["slide"] = cfg.w_slide * _mmean(
        torch.sqrt(slide + 1e-6) - 1e-3, v2)

    if constraints is not None:
        # the single-clip loss divides its sum by T: reproduce it per clip
        # with the true (unpadded) length
        bc_sums = body_constraint_loss(cfg, constraints, body_pos,
                                       body_rot) * frames34.shape[1]
        lengths = torch.clamp(torch.sum(v, dim=1), min=1.0)
        losses["body_constraint"] = (cfg.w_body_constraint
                                     * bc_sums / lengths)

    jerk = (body_pos[:, 3:] - 3 * body_pos[:, 2:-1] + 3 * body_pos[:, 1:-2]
            - body_pos[:, :-3]) * cfg.fps**3
    jerk_mag = torch.sqrt(torch.sum(jerk**2, dim=-1) + 1e-12)
    v4 = v[:, 3:] * v[:, 2:-1] * v[:, 1:-2] * v[:, :-3]
    losses["jerk"] = cfg.w_jerk * _mmean(
        _relu(jerk_mag - cfg.jerk_clamp)**2, v4)

    totals = sum(losses.values())
    return totals, losses


def motion_contact_optimization_batched(
        model: cm.CharModel, terrains: List[terrain_lib.Terrain],
        clips_frames34, clips_contacts,
        cfg: MotionOptConfig = MotionOptConfig(),
        pad_to: Optional[int] = None):
    """Optimize K variable-length motions (each on ITS OWN terrain) in one
    Adam loop.

    Clips are padded to one length T (repeat-last-frame; padded frames are
    masked out of every loss term and receive zero gradient) and the K
    per-clip totals are SUMMED, not averaged: clips are independent, so the
    joint Adam step equals K independent steps.

    Args:
      terrains: list of K Terrain (one per clip).
      clips_frames34 / clips_contacts: lists of (T_i, 34) / (T_i, J).
      pad_to: padded length (>= max T_i); defaults to max T_i.

    Returns list of K (frames (T_i, 34), final-loss dict) pairs.
    """
    k = len(terrains)
    if not (k == len(clips_frames34) == len(clips_contacts) and k > 0):
        raise ValueError("one terrain, frames and contacts per clip")
    dev = model.device
    lengths = [int(f.shape[0]) for f in clips_frames34]
    t_pad = int(pad_to or max(lengths))
    if t_pad < max(lengths):
        raise ValueError(f"pad_to {t_pad} < longest clip {max(lengths)}")

    def pad(x):
        x = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x)).astype(np.float32)
        return (np.concatenate([x, np.repeat(x[-1:], t_pad - x.shape[0], 0)])
                if x.shape[0] < t_pad else x)

    frames = torch.as_tensor(np.stack([pad(f) for f in clips_frames34]),
                             device=dev)
    contacts_p = np.stack([pad(c) for c in clips_contacts])
    # padded frames carry no contact tags (no spurious contact loss)
    for i, li in enumerate(lengths):
        contacts_p[i, li:] = 0.0
    contacts_t = torch.as_tensor(contacts_p, device=dev)
    valid = torch.as_tensor(
        np.arange(t_pad)[None] < np.asarray(lengths)[:, None],
        dtype=torch.float32, device=dev)

    stacked = terrain_lib.stack_terrains(terrains)
    terrain_idx = torch.arange(k, device=dev)

    constraints = None
    if cfg.auto_body_constraints and cfg.w_body_constraint > 0:
        # per-clip estimation on the clip's own terrain; run starts/ends
        # index the padded timeline unchanged (the valid region is a prefix)
        constraints = BodyConstraints.stack([
            compute_approx_body_constraints(
                model, terrains[i], frames[i, :lengths[i]],
                contacts_t[i, :lengths[i]], cfg)
            for i in range(k)])

    def loss_fn(x):
        totals, per = motion_opt_loss_batched(
            model, cfg, stacked, terrain_idx, x, frames, contacts_t, valid,
            constraints=constraints)
        return torch.sum(totals), per

    x = _adam(loss_fn, frames, cfg)
    with torch.no_grad():
        _, final = loss_fn(x)
    final = {kk: vv.cpu().numpy() for kk, vv in final.items()}
    return [(x[i, :li], {kk: float(vv[i]) for kk, vv in final.items()})
            for i, li in enumerate(lengths)]
