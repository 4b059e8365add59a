"""Keypoint-based motion retargeting (no external IK library).

Reference parity: pyroki_retarget/10_humanoid_retargeting.py(+_fancy) —
retargets SMPL keypoint trajectories to a robot skeleton by optimizing
joint variables against local/global keypoint-alignment costs with scale
variables and smoothness/limit regularizers (there via pyroki+jaxls
Levenberg-Marquardt; here ``torch.optim.Adam`` over our FK, the same
machinery as opt/motion_opt).

Works in both directions (SMPL -> humanoid, humanoid -> any CharModel):
all it needs is a keypoint trajectory, a CharModel, and a body<->keypoint
mapping.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from parc_torch import resolve_device
from parc_torch.anim import char_model as cm
from parc_torch.utils import rotation as rot
from parc_torch.utils import terrain as terrain_lib

# SMPL joint names (reference: pyroki_retarget/_utils.py SMPL_JOINT_NAMES)
SMPL_JOINT_NAMES = (
    "pelvis", "left_hip", "right_hip", "spine_1", "left_knee", "right_knee",
    "spine_2", "left_ankle", "right_ankle", "spine_3", "left_foot",
    "right_foot", "neck", "left_collar", "right_collar", "head",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hand", "right_hand")

# default SMPL-joint -> humanoid-body correspondence
# (reference: _utils.get_humanoid_retarget_indices)
DEFAULT_SMPL_TO_HUMANOID: Dict[str, str] = {
    "pelvis": "pelvis",
    "spine_3": "torso",
    "head": "head",
    "left_hip": "left_thigh",
    "left_knee": "left_shin",
    "left_ankle": "left_foot",
    "right_hip": "right_thigh",
    "right_knee": "right_shin",
    "right_ankle": "right_foot",
    "left_shoulder": "left_upper_arm",
    "left_elbow": "left_lower_arm",
    "left_wrist": "left_hand",
    "right_shoulder": "right_upper_arm",
    "right_elbow": "right_lower_arm",
    "right_wrist": "right_hand",
}


@dataclasses.dataclass(frozen=True)
class RetargetConfig:
    iters: int = 1500
    lr: float = 0.02
    w_global: float = 1.0      # absolute keypoint positions
    w_local: float = 2.0       # keypoint offsets relative to the root
    w_smooth: float = 0.5      # second-difference smoothness
    w_limits: float = 10.0     # joint-limit barrier
    w_scale_reg: float = 1.0   # keep the skeleton scale near 1
    optimize_scale: bool = True


def _mapping_indices(model: cm.CharModel,
                     mapping: Dict[str, str],
                     keypoint_names: Sequence[str]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    names = list(model.body_names)
    kp_idx, body_idx = [], []
    for kp_name, body_name in mapping.items():
        if kp_name in keypoint_names and body_name in names:
            kp_idx.append(list(keypoint_names).index(kp_name))
            body_idx.append(names.index(body_name))
    return np.asarray(kp_idx, np.int32), np.asarray(body_idx, np.int32)


def keypoint_losses(pts: torch.Tensor, target: torch.Tensor,
                    q: torch.Tensor, root_pos: torch.Tensor,
                    scale: Optional[torch.Tensor], lo: torch.Tensor,
                    hi: torch.Tensor, cfg) -> Dict[str, torch.Tensor]:
    """The retargeting cost terms (shared by the CharModel and the URDF
    retargeters): ``pts`` / ``target`` (T, C, 3), ``q`` (T, D) joint
    variables with limits ``lo`` / ``hi``; ``scale`` None when the skeleton
    scale is not optimized. ``torch.maximum`` splits the gradient at a
    bound as ``jnp.maximum`` does."""
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    losses = {}
    losses["global"] = cfg.w_global * torch.mean((pts - target) ** 2)
    rel_p = pts - pts[:, 0:1]
    rel_t = target - target[:, 0:1]
    losses["local"] = cfg.w_local * torch.mean((rel_p - rel_t) ** 2)
    acc = q[2:] - 2 * q[1:-1] + q[:-2]
    racc = root_pos[2:] - 2 * root_pos[1:-1] + root_pos[:-2]
    losses["smooth"] = cfg.w_smooth * (torch.mean(acc ** 2)
                                       + torch.mean(racc ** 2))
    over = torch.maximum(q - hi, zero) + torch.maximum(lo - q, zero)
    losses["limits"] = cfg.w_limits * torch.mean(over ** 2)
    if scale is not None:
        losses["scale_reg"] = cfg.w_scale_reg * torch.mean(
            (scale - 1.0) ** 2)
    return losses


# eager Adam steps before a CUDA graph is captured (the optimizer's state
# and the gradients are allocated by then)
GRAPH_WARMUP = 3


def adam_fit(x: Dict[str, torch.Tensor],
             loss_fn: Callable[[Dict[str, torch.Tensor]],
                               Dict[str, torch.Tensor]],
             iters: int, lr: float) -> Dict[str, float]:
    """``iters`` steps of Adam (optax.adam's defaults: b1 0.9, b2 0.999,
    eps 1e-8 added to the bias-corrected sqrt(v), as torch adds it) on the
    leaf tensors ``x``, in place; returns the terms at the final ``x``.

    On CUDA, after ``GRAPH_WARMUP`` eager steps, one step (loss, backward,
    ``Adam(capturable=True)``) is captured as a CUDA graph and replayed
    for the rest: the same kernels in the same order, launched once from
    the host instead of a few hundred times an iteration."""
    params = list(x.values())
    cuda = params[0].is_cuda
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           capturable=cuda)

    def step():
        sum(loss_fn(x).values()).backward()
        opt.step()

    eager = iters if not cuda or iters <= GRAPH_WARMUP else GRAPH_WARMUP
    if cuda:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(eager):
                opt.zero_grad(set_to_none=True)
                step()
        torch.cuda.current_stream().wait_stream(side)
    else:
        for _ in range(eager):
            opt.zero_grad(set_to_none=True)
            step()
    if iters > eager:
        graph = torch.cuda.CUDAGraph()
        opt.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph):
            step()
        for _ in range(iters - eager):
            graph.replay()
    with torch.no_grad():
        return {k: v.item() for k, v in loss_fn(x).items()}


def retarget_keypoints(model: cm.CharModel, keypoints: np.ndarray,
                       keypoint_names: Sequence[str] = SMPL_JOINT_NAMES,
                       mapping: Optional[Dict[str, str]] = None,
                       cfg: RetargetConfig = RetargetConfig(),
                       fps: float = 30.0, device="cuda"):
    """Retarget a (T, K, 3) keypoint trajectory onto ``model``, on
    ``device`` (the card unless the caller asks for the CPU).

    Returns (frames34 (T, 34), final_losses dict).
    """
    model = model.to(resolve_device(device))
    dev = model.device
    mapping = mapping or DEFAULT_SMPL_TO_HUMANOID
    kp_idx, body_idx = _mapping_indices(model, mapping, keypoint_names)
    assert len(kp_idx) >= 4, "need at least 4 keypoint correspondences"
    target = torch.as_tensor(np.asarray(keypoints, np.float32)[:, kp_idx],
                             device=dev)                      # (T, C, 3)
    body_idx = torch.as_tensor(body_idx, dtype=torch.long, device=dev)
    t_len = keypoints.shape[0]
    lo, hi = model.dof_limits_lower, model.dof_limits_upper

    def loss_fn(x):
        root_pos = x["root_pos"]
        body_pos, _ = cm.forward_kinematics(
            model, root_pos, rot.exp_map_to_quat(x["root_rot"]),
            cm.dof_to_rot(model, x["dof"]))
        scale = x["scale"] if cfg.optimize_scale else None
        rel = body_pos - root_pos[..., None, :]
        if scale is not None:
            rel = rel * scale
        pts = (root_pos[..., None, :] + rel)[:, body_idx]     # (T, C, 3)
        return keypoint_losses(pts, target, x["dof"], root_pos, scale, lo,
                               hi, cfg)

    # init: root at the pelvis keypoint, zero pose
    x = {
        "root_pos": target[:, 0].clone(),
        "root_rot": torch.zeros((t_len, 3), device=dev),
        "dof": torch.zeros((t_len, model.dof_size), device=dev),
        "scale": torch.ones((), device=dev),
    }
    if not cfg.optimize_scale:
        # unused by the loss: its gradient is zero and Adam leaves it at 1
        del x["scale"]
    for v in x.values():
        v.requires_grad_(True)
    losses = adam_fit(x, loss_fn, cfg.iters, cfg.lr)
    with torch.no_grad():
        frames34 = torch.cat([x["root_pos"], x["root_rot"],
                              terrain_lib.clip(x["dof"], lo, hi)], dim=-1)
    return frames34.cpu().numpy(), losses


def keypoints_from_motion(model: cm.CharModel,
                          frames34: np.ndarray) -> np.ndarray:
    """Inverse direction helper: body keypoints of an existing clip, by FK
    on the model's device (reference: convert_parc_to_pyroki.py exports
    SMPL-joint keypoints)."""
    f = torch.as_tensor(np.asarray(frames34, np.float32),
                        device=model.device)
    with torch.no_grad():
        body_pos, _ = cm.forward_kinematics(
            model, f[:, 0:3], rot.exp_map_to_quat(f[:, 3:6]),
            cm.dof_to_rot(model, f[:, 6:]))
    return body_pos.cpu().numpy()
