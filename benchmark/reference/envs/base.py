"""Env base types: done flags, config, batched env state.

The env is a set of functions over an explicit ``EnvState`` (a dataclass
of tensors); resets are masked updates of that state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from reference.physics.engine import SimState


class DoneFlags:
    """Reference parity: envs/base_env.py DoneFlags."""

    NULL = 0
    FAIL = 1
    SUCC = 2
    TIME = 3


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static env configuration (defaults follow the reference tracker env,
    reference: PARC/tracker_config/dm_env_default.yaml)."""

    num_envs: int = 2048  # reference default (PARC/tracker_default.yaml:4)
    episode_length: float = 10.0
    control_freq: int = 30
    sim_freq: int = 60

    # observation
    global_obs: bool = False
    root_height_obs: bool = False
    tar_obs_steps: Tuple[int, ...] = (1, 2, 3, 10, 20, 30)
    key_bodies: Tuple[str, ...] = ("right_hand", "left_hand",
                                   "right_foot", "left_foot")
    use_contact_info: bool = True
    # terrain perception (envs/perception.py):
    # HF_RAY (cone of rays, the tracker default), HF_GRID (uniform grid),
    # HF_GRID_C2F (coarse-to-fine grid)
    terrain_obs_mode: str = "HF_RAY"
    # HF_RAY fields
    ray_points_behind: int = 2
    ray_points_ahead: int = 60
    ray_num_side: int = 3
    ray_angle: float = 0.26179938779  # 15 deg
    ray_dx: float = 0.05
    # HF_GRID / HF_GRID_C2F fields
    grid_dx: float = 0.1
    grid_dy: float = 0.1
    grid_num_x_neg: int = 4
    grid_num_x_pos: int = 25
    grid_num_y_neg: int = 10
    grid_num_y_pos: int = 10
    c2f_num_x: int = 15
    c2f_num_y: int = 10
    c2f_root_x_offset: float = 0.5
    c2f_dx_incr_rate: float = 0.02
    c2f_dy_incr_rate: float = 0.02
    max_obs_h: float = 3.0
    min_obs_h: float = -3.0

    # reward
    pose_w: float = 0.5
    vel_w: float = 0.1
    root_pos_w: float = 0.15
    root_vel_w: float = 0.1
    key_pos_w: float = 0.15
    joint_err_w: Tuple[float, ...] = (1.0, 0.6, 0.6, 0.4, 0.0, 0.6, 0.4,
                                      0.0, 1.0, 0.6, 0.4, 1.0, 0.6, 0.4)
    contact_weight: float = 5.0
    track_root: bool = True
    track_root_h: bool = True

    # termination
    enable_early_termination: bool = True
    pose_termination: bool = True
    pose_termination_dist: Tuple[float, ...] = (
        0.7, 1.0, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 1.0, 1.2, 10.0, 1.0, 1.2,
        10.0)
    root_pos_termination_dist: float = 0.6
    root_rot_termination_angle: float = 1.309
    termination_height: float = 0.15
    contact_bodies: Tuple[str, ...] = ()

    # reset
    rand_reset: bool = True
    rand_root_pos_offset_scale: float = 0.075
    ref_height_buffer: float = 0.01

    # curriculum
    fail_rate_ema: float = 0.9
    min_motion_weight: float = 0.01

    @property
    def control_dt(self) -> float:
        return 1.0 / self.control_freq

    @property
    def sim_steps_per_control(self) -> int:
        return self.sim_freq // self.control_freq


@dataclasses.dataclass
class EnvState:
    """Batched environment state (leading dim = num_envs)."""

    sim: SimState
    obs: torch.Tensor            # (N, obs_dim) post-reset obs (policy input)
    terminal_obs: torch.Tensor   # (N, obs_dim) pre-reset obs (bootstrapping)
    reward: torch.Tensor         # (N,)
    done: torch.Tensor           # (N,) DoneFlags, int64
    time: torch.Tensor           # (N,) episode time (post-reset, like obs)
    # pre-reset episode time of the step (meaningful where done != NULL):
    # the auto-reset zeroes `time` before the caller can read the finished
    # episode's length, so it is reported here like terminal_obs
    terminal_times: torch.Tensor  # (N,)
    motion_ids: torch.Tensor     # (N,) int64
    motion_times: torch.Tensor   # (N,) ref motion time
    start_times: torch.Tensor    # (N,) episode ref start time
    # per-motion curriculum statistics (shared across envs)
    fail_rates: torch.Tensor     # (M,) EMA of tracking failure per motion
    # bookkeeping for logging / recording
    reward_components: torch.Tensor  # (N, 6) pose/vel/root_pos/root_vel/key/contact
    tracking_error: torch.Tensor     # (N, 7)

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)
