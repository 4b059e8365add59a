"""Motion clip converters and inspection.

Reference parity: convert_parc_to_bvh.py (34-D frames -> BVH with ZXY euler
channels) and inspect_pkl.py (clip metadata dump). The exporter here is
generic: the skeleton is read from the CharModel tree instead of a
hand-maintained bone table, so it works for any MJCF character. The
joint rotations come from the model's device; the text is written on the
host.

Run:  python -m parc_torch.tools.convert bvh|keypoints|inspect CLIP
      [--output OUT] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_data as md
from parc_torch.utils import rotation as rot


def _quat_to_euler_zxy(q: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) -> intrinsic Z-X-Y euler angles in degrees
    (the BVH channel order used by the reference exporter)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m01 = 2 * (x * y - w * z)
    m11 = 1 - 2 * (x * x + z * z)
    m20 = 2 * (x * z - w * y)
    m21 = 2 * (y * z + w * x)
    m22 = 1 - 2 * (x * x + y * y)
    # R = Rz @ Rx @ Ry  (intrinsic z, then x, then y)
    ex = np.arcsin(np.clip(m21, -1.0, 1.0))
    ez = np.arctan2(-m01, m11)
    ey = np.arctan2(-m20, m22)
    return np.degrees(np.stack([ez, ex, ey], axis=-1))


def _frames(model: cm.CharModel, motion: md.MotionData) -> torch.Tensor:
    return torch.as_tensor(np.asarray(motion.frames, np.float32),
                           device=model.device)


def motion_to_bvh(model: cm.CharModel, motion: md.MotionData,
                  out_path: str, scale: float = 100.0) -> None:
    """Write a BVH file for a 34-D clip (root pos/rot + joint dofs).

    scale converts meters to BVH units (reference uses cm).
    """
    f = _frames(model, motion)
    frames = np.asarray(motion.frames)
    root_pos = frames[:, 0:3] * scale
    root_q = rot.exp_map_to_quat(f[:, 3:6]).cpu().numpy()
    joint_q = cm.dof_to_rot(model, f[:, 6:]).cpu().numpy()

    nb = model.num_bodies
    children = [[] for _ in range(nb)]
    for j in range(1, nb):
        children[model.parent_indices[j]].append(j)
    local_translation = model.local_translation.cpu().numpy()

    lines = ["HIERARCHY"]

    def emit(j: int, indent: int) -> None:
        pad = "  " * indent
        off = local_translation[j] * scale
        if j == 0:
            lines.append(f"ROOT {model.body_names[j]}")
            lines.append(pad + "{")
            lines.append(f"{pad}  OFFSET 0.00 0.00 0.00")
            lines.append(f"{pad}  CHANNELS 6 Xposition Yposition Zposition"
                         " Zrotation Xrotation Yrotation")
        else:
            lines.append(f"{pad}JOINT {model.body_names[j]}")
            lines.append(pad + "{")
            lines.append(f"{pad}  OFFSET {off[0]:.4f} {off[1]:.4f}"
                         f" {off[2]:.4f}")
            lines.append(f"{pad}  CHANNELS 3 Zrotation Xrotation Yrotation")
        if children[j]:
            for c in children[j]:
                emit(c, indent + 1)
        else:
            lines.append(f"{pad}  End Site")
            lines.append(pad + "  {")
            lines.append(f"{pad}    OFFSET 0.00 0.00 {0.05 * scale:.2f}")
            lines.append(pad + "  }")
        lines.append(pad + "}")

    emit(0, 0)

    n = frames.shape[0]
    lines.append("MOTION")
    lines.append(f"Frames: {n}")
    lines.append(f"Frame Time: {1.0 / float(motion.fps):.6f}")

    root_e = _quat_to_euler_zxy(root_q)
    joint_e = _quat_to_euler_zxy(joint_q)  # (n, nb-1, 3)

    order = []  # joint order matching the emitted hierarchy (DFS)

    def dfs(j):
        order.append(j)
        for c in children[j]:
            dfs(c)
    dfs(0)

    for t in range(n):
        vals = [f"{root_pos[t, 0]:.4f}", f"{root_pos[t, 1]:.4f}",
                f"{root_pos[t, 2]:.4f}",
                f"{root_e[t, 0]:.4f}", f"{root_e[t, 1]:.4f}",
                f"{root_e[t, 2]:.4f}"]
        for j in order[1:]:
            e = joint_e[t, j - 1]
            vals.extend([f"{e[0]:.4f}", f"{e[1]:.4f}", f"{e[2]:.4f}"])
        lines.append(" ".join(vals))

    with open(out_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def motion_to_keypoints(model: cm.CharModel, motion: md.MotionData,
                        out_path: str) -> dict:
    """Export SMPL-named body keypoint trajectories for retargeting
    (reference: convert_parc_to_pyroki.py — SMPL-joint positions fed to
    the pyroki retargeter; here the consumer is
    parc_torch.retarget.keypoint_ik.retarget_keypoints)."""
    from parc_torch.retarget.keypoint_ik import (DEFAULT_SMPL_TO_HUMANOID,
                                                 SMPL_JOINT_NAMES,
                                                 keypoints_from_motion)

    body_pos = keypoints_from_motion(model, np.asarray(motion.frames))
    body_to_smpl = {b: s for s, b in DEFAULT_SMPL_TO_HUMANOID.items()}
    names, kp = [], []
    for j, body in enumerate(model.body_names):
        smpl = body_to_smpl.get(body)
        if smpl is not None:
            names.append(smpl)
            kp.append(body_pos[:, j])
    kp = np.stack(kp, axis=1).astype(np.float32)  # (T, K, 3)
    np.savez(out_path, keypoints=kp, names=np.asarray(names),
             fps=np.float32(motion.fps),
             smpl_joint_names=np.asarray(SMPL_JOINT_NAMES))
    return {"keypoints": kp, "names": names}


def inspect_motion(path: str, file=sys.stdout) -> dict:
    """Print clip metadata (reference: inspect_pkl.py)."""
    motion = md.load_motion_data(path)
    info = {
        "file": path,
        "num_frames": int(motion.frames.shape[0]),
        "frame_dim": int(motion.frames.shape[-1]),
        "fps": float(motion.fps),
        "length_s": float(motion.frames.shape[0] / motion.fps),
        "has_contacts": motion.contacts is not None,
        "has_terrain": motion.terrain is not None,
        "loop_mode": getattr(motion, "loop_mode", "CLAMP"),
    }
    if motion.terrain is not None:
        info["terrain_dims"] = tuple(np.asarray(motion.terrain.hf).shape)
        info["terrain_dxdy"] = tuple(
            float(x) for x in np.asarray(motion.terrain.dxdy))
    for k, v in info.items():
        print(f"{k}: {v}", file=file)
    return info


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(prog="parc_torch.tools.convert")
    p.add_argument("command", choices=["bvh", "keypoints", "inspect"])
    p.add_argument("input")
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the forward kinematics "
                        "(default cuda)")
    args = p.parse_args(argv)
    if args.command == "inspect":
        inspect_motion(args.input)
        return
    from parc_torch.data.humanoid import humanoid_spec
    model = humanoid_spec().build(device=args.device)
    motion = md.load_motion_data(args.input)
    if args.command == "keypoints":
        out = args.output or args.input.rsplit(".", 1)[0] + "_keypoints.npz"
        motion_to_keypoints(model, motion, out)
    else:
        out = args.output or args.input.rsplit(".", 1)[0] + ".bvh"
        motion_to_bvh(model, motion, out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
