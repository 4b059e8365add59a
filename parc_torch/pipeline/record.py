"""Physics recording stage (parc_4).

Rolls out the trained tracker deterministically on every dataset motion
(one env per motion, no random reset), records the physically-simulated
frames + contact flags, keeps successful tracks, and retries failures from
later start-time fractions.

Reference parity: parc_4_phys_record.py + learning/dm_ppo_agent.py:414-594
(record_motions with start-fraction retry schedule) +
envs/ig_parkour/ig_parkour_env.py:895-995 (write_agent_states).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_data as md
from parc_torch.anim import motion_lib as ml
from parc_torch.envs.base import DoneFlags
from parc_torch.learning.ppo import AgentState, PPOAgent
from parc_torch.utils import rotation as rot


@dataclasses.dataclass
class RecordConfig:
    output_dir: str = "output/recorded"
    start_fractions: tuple = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5)
    success_slack: float = 2.0 / 30.0  # motion_time >= length - 2*dt
    max_steps: int = 1000
    # also store per-step policy observations in the recorded clips
    # (reference recorded pkls carry 'obs'/'obs_shapes')
    save_obs: bool = False


def sim_frame(model: cm.CharModel, sim) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """The 34-D frames and the per-body contact flags (a contact force
    above 1e-3 N) of a sim state, on its device."""
    frame34 = torch.cat([sim.root_pos, rot.quat_to_exp_map(sim.root_rot),
                         cm.rot_to_dof(model, sim.joint_rot)], dim=-1)
    contacts = (torch.linalg.vector_norm(sim.contact_forces, dim=-1)
                > 1e-3).float()
    return frame34, contacts


@torch.no_grad()
def _rollout_record(agent: PPOAgent, lib: ml.MotionLib, state: AgentState,
                    motion_ids: torch.Tensor, start_times: torch.Tensor,
                    num_steps: int, generator: torch.Generator,
                    keep_obs: bool):
    """Deterministic rollout recording 34-D frames + contacts per step;
    returns [T, B, ...] host arrays of the frames, contacts, done flags,
    pre-reset motion times and (with ``keep_obs``, else None) the obs."""
    env = agent.env
    model = env.model
    es = env.reset(lib, generator, num_envs=motion_ids.shape[0],
                   motion_ids=motion_ids, start_times=start_times)
    out = []
    for _ in range(num_steps):
        # capture the PRE-step state: the post-step state of done envs is
        # already auto-reset, so recording it would splice a respawn pose
        # into the clip. Pre-step capture yields [s_0, ..., s_{done-1}]
        # including the initial state, matching the reference's per-step
        # appends (ig_parkour_env.py:957-995).
        frame34, contacts = sim_frame(model, es.sim)
        action = agent.act(state, es.obs)
        new_es = env.step(lib, es, action, generator=generator)
        # pre-reset motion time of this step (new_es.motion_times is
        # already re-sampled for done envs by the auto-reset)
        mt_pre = es.motion_times + env.cfg.control_dt
        out.append((frame34, contacts, new_es.done, mt_pre)
                   + ((es.obs,) if keep_obs else ()))
        es = new_es
    arrays = [torch.stack(xs).cpu().numpy() for xs in zip(*out)]
    return tuple(arrays) + ((None,) if not keep_obs else ())


def round_steps(lib: ml.MotionLib, max_steps: int) -> int:
    """Control steps of one record round: the longest clip's frame count
    plus 2, at most ``max_steps`` (every round rolls every motion)."""
    dt = 1.0 / float(lib.fps[0])
    return min(int(np.ceil(lib.lengths.cpu().numpy().max() / dt)) + 2,
               max_steps)


def record_motions(agent: PPOAgent, lib: ml.MotionLib, state: AgentState,
                   cfg: RecordConfig = RecordConfig(),
                   seed: int = 0) -> List[Optional[md.MotionData]]:
    """Record every motion in the library; returns one clip (or None) per
    motion. Failed motions retry from later start fractions."""
    m = lib.num_motions
    dev = lib.device
    fps = float(lib.fps[0])
    results: List[Optional[md.MotionData]] = [None] * m
    pending = np.arange(m)

    # every retry round rolls the FULL motion set (pending ones matter, the
    # rest are overwritten) for one global step count
    all_lengths = lib.lengths.cpu().numpy()
    num_steps = round_steps(lib, cfg.max_steps)
    ids = torch.arange(m, device=dev)
    terrain_hf = lib.terrain_hf.cpu().numpy()
    terrain_min_point = lib.terrain_min_point.cpu().numpy()
    terrain_dxdy = lib.terrain_dxdy.cpu().numpy()

    for fi, frac in enumerate(cfg.start_fractions):
        if len(pending) == 0:
            break
        start_times = torch.as_tensor(frac * all_lengths, dtype=torch.float32,
                                      device=dev)
        g = torch.Generator(device=dev).manual_seed(seed + fi)
        frames, contacts, dones, mtimes, obs = _rollout_record(
            agent, lib, state, ids, start_times, num_steps, g, cfg.save_obs)

        still_pending = []
        for mid in pending:
            k = int(mid)  # env k tracks motion k (full-set rollout)
            # first step where the env finished: recording stops there
            done_steps = np.nonzero(dones[:, k] != DoneFlags.NULL)[0]
            end = int(done_steps[0]) + 1 if len(done_steps) else num_steps
            final_time = mtimes[end - 1, k]
            # success is gated on motion time alone: the tracker must have
            # played the clip through to (nearly) its end; a truncated
            # rollout or an early TIME done is NOT a successful track
            # (reference: learning/dm_ppo_agent.py:476-512, success iff
            # motion time >= length - 2*dt)
            if final_time < all_lengths[k] - cfg.success_slack:
                still_pending.append(mid)
                continue
            terrain = md.HostTerrain(hf=terrain_hf[k],
                                     min_point=terrain_min_point[k],
                                     dxdy=terrain_dxdy)
            results[k] = md.MotionData(
                frames=frames[:end, k].astype(np.float32), fps=fps,
                contacts=contacts[:end, k].astype(np.float32),
                terrain=terrain,
                obs=obs[:end, k].astype(np.float32) if obs is not None
                else None)
        pending = np.asarray(still_pending, np.int64)

    return results


def save_recorded(results, out_dir: str, prefix: str = "recorded"):
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, clip in enumerate(results):
        if clip is None:
            continue
        path = os.path.join(out_dir, f"{prefix}_{i:04d}.npz")
        md.save_motion_data(path, clip)
        paths.append(path)
    return paths
