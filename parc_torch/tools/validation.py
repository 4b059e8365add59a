"""MDM validation harness: fixed-seed generation over terrain+path
fixtures, saved outputs, metric summary.

Reference parity: tools/motion_tests/mdm_validation_test.py:28-120 +
mdm_validation_test.yaml — deterministic (seeded) autoregressive generation
along pre-planned paths on a fixed library of terrains, with results saved
as clips for metric evaluation (compute_losses). This is the reference's
substitute for a unit-test suite for generation quality (SURVEY §4).

Generation and metrics run on the MDM's device. Each fixture's draws come
from its own ``torch.Generator`` seeded ``seed + fixture index`` (the JAX
package's ``PRNGKey(seed + fi)``), or explicitly as
``mdm_path.PathDraws``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from parc_torch.anim import motion_data as md
from parc_torch.diffusion.mdm import MDM, MDMState
from parc_torch.procgen import mdm_path as mdm_path_lib
from parc_torch.tools import metrics as metrics_lib
from parc_torch.utils import terrain as terrain_lib


@dataclasses.dataclass
class ValidationFixture:
    """One validation case: a terrain and a pre-planned node path."""

    name: str
    terrain: terrain_lib.Terrain
    path_nodes: np.ndarray          # (K, 3) world xyz


def run_validation(mdm: MDM, state: MDMState,
                   fixtures: Sequence[ValidationFixture],
                   output_dir: Optional[str] = None,
                   seed: int = 0,
                   path_cfg: Optional[mdm_path_lib.PathGenSettings] = None,
                   top_k: int = 4,
                   jerk_threshold: float = 11666.39,
                   draws: Optional[Sequence[mdm_path_lib.PathDraws]] = None
                   ) -> List[Dict]:
    """Seeded generation on every fixture; returns per-rollout metric rows
    for the top_k lowest-loss rollouts.

    Outputs are saved as .npz clips when output_dir is given (same layout
    the reference uses for its compute_losses sweep). ``draws``, one per
    fixture, replaces the fixtures' generators.
    """
    path_cfg = path_cfg or mdm_path_lib.PathGenSettings()
    rows: List[Dict] = []
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)

    for fi, fx in enumerate(fixtures):
        gen = torch.Generator(device=mdm.device).manual_seed(seed + fi)
        nodes = np.asarray(fx.path_nodes)
        t0 = time.time()
        # cold start (None): the chain builds its own standing anchor and
        # un-conditions the first window (reference path-start regime)
        result = mdm_path_lib.generate_frames_along_path(
            mdm, state, fx.terrain, nodes, None, None, gen, path_cfg,
            draws=None if draws is None else draws[fi])
        gen_time = time.time() - t0
        host = md.HostTerrain(hf=fx.terrain.hf.cpu().numpy(),
                              min_point=fx.terrain.min_point.cpu().numpy(),
                              dxdy=fx.terrain.dxdy.cpu().numpy())
        order = np.argsort(result.total_loss)[:top_k]
        for rank, i in enumerate(order):
            n = int(result.lengths[i])
            motion = md.MotionData(
                frames=np.asarray(result.frames34[i][:n]),
                fps=path_cfg.fps,
                contacts=np.asarray(result.contacts[i][:n]),
                terrain=host)
            m = metrics_lib.compute_motion_metrics(
                mdm.model, motion, jerk_threshold,
                final_node_xyz=nodes[-1])
            rows.append({"fixture": fx.name, "rollout": rank,
                         "gen_time_s": gen_time, **m.as_dict()})
            if output_dir:
                md.save_motion_data(
                    os.path.join(output_dir, f"{fx.name}_{rank:03d}.npz"),
                    motion)
    return rows


def sweep_checkpoints(mdm: MDM, state_like: MDMState, ckpt_dir: str,
                      fixtures: Sequence[ValidationFixture],
                      output_dir: Optional[str] = None,
                      **kwargs) -> List[Dict]:
    """Run the validation harness on EVERY retained checkpoint (reference:
    tools/motion_tests/compute_losses.py sweeps model_{epoch} history).

    ``state_like`` is a state of ``mdm`` that each checkpoint is restored
    into. Returns the per-rollout metric rows tagged with their checkpoint
    step; pair with :func:`summarize` per step for a loss-vs-epoch
    table."""
    from parc_torch.utils import checkpoint as ckpt_lib
    rows: List[Dict] = []
    for step in ckpt_lib.all_steps(ckpt_dir):
        state = mdm.merge_persistent(state_like, ckpt_lib.restore(
            ckpt_dir, step=step, map_location=mdm.device))
        out = (os.path.join(output_dir, f"ckpt_{step:010d}")
               if output_dir else None)
        step_rows = run_validation(mdm, state, fixtures, output_dir=out,
                                   **kwargs)
        for r in step_rows:
            r["checkpoint"] = step
        rows.extend(step_rows)
    return rows


def summarize(rows: List[Dict]) -> Dict[str, float]:
    """Mean/std summary over all validation rows (reference CSV columns)."""
    out = {}
    keys = ("final_node_dist", "motion_length", "mean_jerk",
            "frames_with_jerk_over", "contact_loss", "pen_loss")
    for k in keys:
        vals = [r[k] for r in rows if r.get(k) is not None]
        if vals:
            out[f"{k}_mean"] = float(np.mean(vals))
            out[f"{k}_std"] = float(np.std(vals))
    return out
