"""Offline matplotlib rendering of motions + terrains (still frames).

Complements the interactive HTML viewer for CI artifacts and notebooks —
the non-interactive slice of MOTION_FORGE's display (terrain heightmap,
skeleton poses, planned path). matplotlib is imported inside the
functions that draw, so the module imports without it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from parc_torch import resolve_device
from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_data as md
from parc_torch.viewer.html_viewer import body_positions


def _body_positions(model: cm.CharModel, frames: np.ndarray) -> np.ndarray:
    """(T, B, 3) world body positions, by forward kinematics on the
    model's device, as one host array."""
    return body_positions(model, frames).cpu().numpy()


def render_motion_strip(model: cm.CharModel, motion: md.MotionData,
                        out_path: str, num_poses: int = 6,
                        path_nodes: Optional[np.ndarray] = None,
                        device="cuda") -> None:
    """Top-down terrain heightmap with evenly spaced skeleton poses
    (forward kinematics on ``device``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frames = np.asarray(motion.frames)
    bp = _body_positions(model.to(resolve_device(device)), frames)
    fig, ax = plt.subplots(figsize=(8, 8))

    if motion.terrain is not None:
        hf = np.asarray(motion.terrain.hf)
        mp = np.asarray(motion.terrain.min_point)
        dd = np.asarray(motion.terrain.dxdy)
        extent = (mp[1] - dd[1] / 2, mp[1] + hf.shape[1] * dd[1] - dd[1] / 2,
                  mp[0] - dd[0] / 2, mp[0] + hf.shape[0] * dd[0] - dd[0] / 2)
        ax.imshow(hf, origin="lower", extent=extent, cmap="cividis")
        # imshow maps array x->rows; we plotted transposed axes, so swap
        ax.set_xlabel("y [m]")
        ax.set_ylabel("x [m]")

    idxs = np.linspace(0, frames.shape[0] - 1, num_poses).astype(int)
    for k, t in enumerate(idxs):
        alpha = 0.3 + 0.7 * k / max(len(idxs) - 1, 1)
        for j in range(1, model.num_bodies):
            p = model.parent_indices[j]
            ax.plot([bp[t, p, 1], bp[t, j, 1]], [bp[t, p, 0], bp[t, j, 0]],
                    "-", color="lime", alpha=alpha, lw=1.5)
    ax.plot(bp[:, 0, 1], bp[:, 0, 0], "w--", lw=0.8, alpha=0.7,
            label="root path")
    if path_nodes is not None:
        pn = np.asarray(path_nodes)
        ax.plot(pn[:, 1], pn[:, 0], "o-", color="orange", ms=3,
                label="A* path")
    ax.legend(loc="upper right")
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def render_pose_3d(model: cm.CharModel, motion: md.MotionData,
                   frame_idx: int, out_path: str, device="cuda") -> None:
    """Single 3-D pose + terrain surface (forward kinematics on
    ``device``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frames = np.asarray(motion.frames)
    bp = _body_positions(model.to(resolve_device(device)), frames)[frame_idx]
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    if motion.terrain is not None:
        hf = np.asarray(motion.terrain.hf)
        mp = np.asarray(motion.terrain.min_point)
        dd = np.asarray(motion.terrain.dxdy)
        xs = mp[0] + np.arange(hf.shape[0]) * dd[0]
        ys = mp[1] + np.arange(hf.shape[1]) * dd[1]
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        ax.plot_surface(gx, gy, hf, cmap="cividis", alpha=0.7,
                        linewidth=0)
    for j in range(1, model.num_bodies):
        p = model.parent_indices[j]
        ax.plot([bp[p, 0], bp[j, 0]], [bp[p, 1], bp[j, 1]],
                [bp[p, 2], bp[j, 2]], "-o", color="lime", ms=2)
    ax.set_box_aspect((1, 1, 0.5))
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
