"""DeepMimic reference-motion tracking environment (PyTorch, batched).

The training env of the tracker stage: each env tracks a reference motion
clip on that clip's own terrain. Stepping, observation, reward,
termination, the per-motion fail-rate statistics and masked resets are
batched tensor code over the env dimension; nothing syncs with the host
inside a step. A step splits at the physics launch (``_physics``, then
``_after_physics``, a function of tensors); a step that takes its resets
from a reset pool on CUDA replays the second part as one CUDA graph
(envs/step_graph.py).

Each env collides with its own motion's terrain (terrain_idx = motion_id)
through the stacked per-motion heightfields of the MotionLib.

Randomness comes from an explicit ``torch.Generator`` on the env's device
(reset, reset pool, and inline resets in :meth:`DeepMimicEnv.step`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from parc_torch import resolve_device
from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_lib as ml
from parc_torch.envs import obs as obs_mod
from parc_torch.envs import perception
from parc_torch.envs import step_graph
from parc_torch.envs.base import DoneFlags, EnvConfig, EnvState
from parc_torch.physics import engine
from parc_torch.utils import rotation as rot
from parc_torch.utils import terrain as terrain_lib
from parc_torch.utils.profiling import annotate


@dataclasses.dataclass
class ResetPool:
    """Pre-sampled reset states + their observations, flattened [k*N].

    k full reset batches are sampled and observed once per rollout, and a
    done env pulls entry ``slot*N + env_index`` (slot = its reset count,
    mod k), so a step pays one observation pass instead of two. Entries
    are i.i.d. draws from the same reset distribution.
    """

    sim: engine.SimState          # [k*N, ...]
    motion_ids: torch.Tensor      # (k*N,)
    times: torch.Tensor           # (k*N,)
    obs: torch.Tensor             # (k*N, obs_dim)
    k: int = 4


def _pool_take(pool: ResetPool, slot: torch.Tensor, n: int):
    """Gather each env's reset entry ``slot[i]*n + i`` from the pool."""
    idx = slot.long() * n + torch.arange(n, device=slot.device)
    sim = engine.SimState(**{k: v[idx] for k, v in vars(pool.sim).items()})
    return sim, pool.motion_ids[idx], pool.times[idx], pool.obs[idx]


class DeepMimicEnv:
    """Static configuration + step/reset functions.

    The MotionLib is passed into every function (not stored) so the caller
    can swap libraries.
    """

    def __init__(self, model: cm.CharModel, sim_params: engine.SimParams,
                 cfg: EnvConfig, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.sim_params = sim_params
        self.cfg = cfg

        names = list(model.body_names)
        self.key_body_ids = torch.tensor(
            [names.index(n) for n in cfg.key_bodies], dtype=torch.long,
            device=self.device)
        self.contact_body_ids = tuple(
            names.index(n) for n in cfg.contact_bodies)
        # bodies allowed to touch the ground, built once: an index with a
        # Python list in the step would copy it to the device every step
        allowed = torch.zeros(model.num_bodies, dtype=torch.bool)
        allowed[list(self.contact_body_ids)] = True
        self.contact_allowed = allowed.to(self.device)
        # the post-physics chain of a pooled CUDA step (envs/step_graph.py)
        self._step_graph: Optional[step_graph.StepGraph] = None

        # per-dof error weights from per-joint weights, normalized by the
        # total joint weight
        jw = np.asarray(cfg.joint_err_w, np.float64)
        jw = jw / jw.sum()
        dof_w = np.zeros(model.dof_size)
        for j in range(1, model.num_bodies):
            o, end = model.joint_dof_slice(j)
            dof_w[o:end] = jw[j - 1]

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.device)
        self.joint_err_w = f32(jw)
        self.dof_err_w = f32(dof_w)
        self.pose_term_dist = f32(cfg.pose_termination_dist)
        self.contact_weights = f32(np.full((model.num_bodies,),
                                           cfg.contact_weight))
        # per-step constants live on the device (a host tensor copied in
        # every step would synchronize the stream)
        self.tar_steps = f32(cfg.tar_obs_steps)
        self.ray_pattern = f32(perception.local_pattern(cfg))

        num_key = len(cfg.key_bodies)
        steps = len(cfg.tar_obs_steps)
        nb = model.num_bodies
        char_dim = ((1 if cfg.root_height_obs else 0) + 6 + 3 + 3
                    + 6 * (nb - 1) + model.dof_size + 3 * num_key)
        tar_dim = steps * (3 + 6 + 6 * (nb - 1) + 3 * num_key)
        segments = [("char_obs", char_dim, True),
                    ("tar_obs", tar_dim, True)]
        if cfg.use_contact_info:
            segments.append(("contact_obs", nb, False))
            segments.append(("tar_contact_obs", steps * nb, False))
        segments.append(("hf_obs", obs_mod.num_ray_points(cfg), False))
        self.obs_layout = obs_mod.ObsLayout(
            names=tuple(s[0] for s in segments),
            sizes=tuple(s[1] for s in segments),
            normalized=tuple(s[2] for s in segments))

    # ------------------------------------------------------------------
    @property
    def obs_dim(self) -> int:
        return self.obs_layout.total

    @property
    def action_dim(self) -> int:
        return self.model.dof_size

    def action_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """PD-target action bounds: sphericals get symmetric
        1.2*max|limit|, hinges mid +- 0.7*range (host numpy)."""
        model = self.model
        lo = np.zeros(model.dof_size, np.float32)
        hi = np.zeros(model.dof_size, np.float32)
        llo = model.dof_limits_lower.cpu().numpy()
        lhi = model.dof_limits_upper.cpu().numpy()
        for j in range(1, model.num_bodies):
            o = model.dof_offsets[j]
            jt = model.joint_types[j]
            if jt == cm.SPHERICAL:
                s = 1.2 * max(np.max(np.abs(llo[o:o + 3])),
                              np.max(np.abs(lhi[o:o + 3])))
                lo[o:o + 3], hi[o:o + 3] = -s, s
            elif jt == cm.HINGE:
                mid = 0.5 * (lhi[o] + llo[o])
                scale = 0.7 * (lhi[o] - llo[o])
                lo[o], hi[o] = mid - scale, mid + scale
        return lo, hi

    def local_shard(self, n_shards: int) -> "DeepMimicEnv":
        """Per-rank env for data parallelism: the same env with
        ``cfg.num_envs / n_shards`` envs. Rows are independent here, so the
        clone behaves on its block of the batch as the whole env does on
        all of it (parallel/mesh.py)."""
        if self.cfg.num_envs % n_shards:
            raise ValueError(f"num_envs {self.cfg.num_envs} not divisible "
                             f"by {n_shards}")
        cfg = dataclasses.replace(self.cfg,
                                  num_envs=self.cfg.num_envs // n_shards)
        return DeepMimicEnv(self.model, self.sim_params, cfg,
                            device=self.device)

    # ------------------------------------------------------------------
    # Reset
    # ------------------------------------------------------------------

    def _zeros(self, *shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _sample_reset(self, lib: ml.MotionLib, generator: torch.Generator,
                      n: int, fail_rates: torch.Tensor):
        """Sample motions (fail-rate curriculum weighted) and start states."""
        cfg = self.cfg
        w = lib.weights * (cfg.min_motion_weight + fail_rates)
        motion_ids = ml.sample_motions(lib, generator, n, weights=w)
        if cfg.rand_reset:
            times = ml.sample_time(lib, generator, motion_ids,
                                   truncate_time=cfg.control_dt)
        else:
            times = self._zeros(n)
        frame = ml.calc_motion_frame(lib, motion_ids, times)

        offset = self._zeros(n, 3)
        if cfg.rand_root_pos_offset_scale > 0 and cfg.rand_reset:
            offset[:, 0:2] = cfg.rand_root_pos_offset_scale * torch.randn(
                (n, 2), generator=generator, device=self.device)
        offset[:, 2] += cfg.ref_height_buffer

        sim = engine.create_state(
            self.model,
            root_pos=frame.root_pos + offset,
            root_rot=frame.root_rot,
            joint_rot=frame.joint_rot,
            root_vel=frame.root_vel,
            root_ang_vel=frame.root_ang_vel,
            dof_vel=frame.dof_vel,
            device=self.device)
        return motion_ids, times, sim

    def build_reset_pool(self, lib: ml.MotionLib, generator: torch.Generator,
                         fail_rates: torch.Tensor, n: int,
                         k: int = 4) -> ResetPool:
        """Sample k full reset batches + their obs (see ResetPool)."""
        ids_l, times_l, sim_l, obs_l = [], [], [], []
        for _ in range(k):
            ids, times, sim = self._sample_reset(lib, generator, n,
                                                 fail_rates)
            obs_l.append(self._compute_obs(lib, self._obs_view(sim, ids,
                                                               times)))
            ids_l.append(ids)
            times_l.append(times)
            sim_l.append(sim)
        sim = engine.SimState(**{
            f: torch.cat([getattr(s, f) for s in sim_l])
            for f in vars(sim_l[0])})
        return ResetPool(sim=sim, motion_ids=torch.cat(ids_l),
                         times=torch.cat(times_l), obs=torch.cat(obs_l), k=k)

    def _obs_view(self, sim, motion_ids, motion_times) -> EnvState:
        """Minimal EnvState for _compute_obs (unused fields are zeros)."""
        n = motion_ids.shape[0]
        z = self._zeros(n)
        return EnvState(
            sim=sim, obs=z, terminal_obs=z, reward=z,
            done=self._zeros(n, dtype=torch.long), time=z, terminal_times=z,
            motion_ids=motion_ids, motion_times=motion_times,
            start_times=motion_times, fail_rates=z, reward_components=z,
            tracking_error=z)

    def reset(self, lib: ml.MotionLib, generator: torch.Generator,
              num_envs: Optional[int] = None,
              motion_ids: Optional[torch.Tensor] = None,
              start_times: Optional[torch.Tensor] = None) -> EnvState:
        """Full reset; pass motion_ids/start_times for demo/record mode."""
        n = num_envs or self.cfg.num_envs
        fail_rates = torch.full((lib.num_motions,), 0.5, device=self.device)
        if motion_ids is not None:
            motion_ids = motion_ids.to(self.device).long()
            times = (self._zeros(n) if start_times is None
                     else start_times.to(self.device).float())
            frame = ml.calc_motion_frame(lib, motion_ids, times)
            root_pos = frame.root_pos.clone()
            root_pos[..., 2] += self.cfg.ref_height_buffer
            sim = engine.create_state(
                self.model, root_pos=root_pos,
                root_rot=frame.root_rot, joint_rot=frame.joint_rot,
                root_vel=frame.root_vel, root_ang_vel=frame.root_ang_vel,
                dof_vel=frame.dof_vel, device=self.device)
        else:
            motion_ids, times, sim = self._sample_reset(lib, generator, n,
                                                        fail_rates)
        state = EnvState(
            sim=sim,
            obs=self._zeros(n, self.obs_dim),
            terminal_obs=self._zeros(n, self.obs_dim),
            reward=self._zeros(n),
            done=self._zeros(n, dtype=torch.long),
            time=self._zeros(n),
            terminal_times=self._zeros(n),
            motion_ids=motion_ids,
            motion_times=times,
            start_times=times,
            fail_rates=fail_rates,
            reward_components=self._zeros(n, 6),
            tracking_error=self._zeros(n, 7),
        )
        obs0 = self._compute_obs(lib, state)
        return state.replace(obs=obs0, terminal_obs=obs0)

    # ------------------------------------------------------------------
    # Observation
    # ------------------------------------------------------------------

    def _tar_frames(self, lib: ml.MotionLib, motion_ids, motion_times):
        times = motion_times[..., None] + self.tar_steps * self.cfg.control_dt
        ids = motion_ids[..., None].expand(times.shape)
        return ml.calc_motion_frame(lib, ids, times)

    def _compute_obs(self, lib: ml.MotionLib, state: EnvState,
                     tar: Optional[ml.MotionFrame] = None) -> torch.Tensor:
        cfg = self.cfg
        sim = state.sim
        key_pos = sim.body_pos[..., self.key_body_ids, :]
        char_obs = obs_mod.compute_char_obs(
            sim.root_pos, sim.root_rot, sim.root_vel, sim.root_ang_vel,
            sim.joint_rot, sim.dof_vel, key_pos,
            cfg.global_obs, cfg.root_height_obs)

        if tar is None:
            tar = self._tar_frames(lib, state.motion_ids, state.motion_times)
        tar_body_pos, _ = cm.forward_kinematics(
            self.model, tar.root_pos, tar.root_rot, tar.joint_rot)
        tar_key_pos = tar_body_pos[..., self.key_body_ids, :]
        tar_obs = obs_mod.compute_tar_obs(
            sim.root_pos, sim.root_rot, tar.root_pos, tar.root_rot,
            tar.joint_rot, tar_key_pos, cfg.global_obs)

        parts = [char_obs, tar_obs]
        if cfg.use_contact_info:
            contact = (torch.linalg.vector_norm(sim.contact_forces, dim=-1)
                       > 1e-3).to(char_obs.dtype)
            parts.extend([contact, tar.contacts.flatten(-2)])

        ray_pts = perception.sample_points(sim.root_pos, sim.root_rot,
                                           self.ray_pattern)
        hf_obs = obs_mod.compute_hf_obs(
            lib.terrain_hf, lib.terrain_min_point, lib.terrain_dxdy,
            state.motion_ids, ray_pts, sim.root_pos,
            cfg.min_obs_h, cfg.max_obs_h)
        parts.append(hf_obs)
        return torch.cat(parts, dim=-1)

    # ------------------------------------------------------------------
    # Reward
    # ------------------------------------------------------------------

    def _compute_reward(self, state: EnvState, ref: ml.MotionFrame,
                        ref_body_pos: torch.Tensor):
        cfg = self.cfg
        sim = state.sim
        pose_scale, vel_scale = 0.25, 0.01
        root_pose_scale, root_vel_scale, key_pos_scale = 5.0, 1.0, 10.0

        pose_diff = rot.quat_diff_angle(sim.joint_rot, ref.joint_rot)
        pose_err = torch.sum(self.joint_err_w * pose_diff**2, dim=-1)

        vel_diff = ref.dof_vel - sim.dof_vel
        vel_err = torch.sum(self.dof_err_w * vel_diff**2, dim=-1)

        root_pos_diff = ref.root_pos - sim.root_pos
        if not cfg.track_root:
            root_pos_diff = torch.cat([torch.zeros_like(root_pos_diff[..., 0:2]),
                                       root_pos_diff[..., 2:3]], dim=-1)
        if not cfg.track_root_h:
            root_pos_diff = torch.cat([root_pos_diff[..., 0:2],
                                       torch.zeros_like(root_pos_diff[..., 2:3])],
                                      dim=-1)
        root_pos_err = torch.sum(root_pos_diff**2, dim=-1)

        key_pos = (sim.body_pos[..., self.key_body_ids, :]
                   - sim.root_pos[..., None, :])
        ref_key = (ref_body_pos[..., self.key_body_ids, :]
                   - ref.root_pos[..., None, :])

        root_rot, root_vel, root_ang_vel = (sim.root_rot, sim.root_vel,
                                            sim.root_ang_vel)
        tr_rot, tr_vel, tr_ang = (ref.root_rot, ref.root_vel,
                                  ref.root_ang_vel)
        if not cfg.track_root:
            hi = rot.calc_heading_quat_inv(sim.root_rot)
            root_rot = rot.quat_mul(hi, root_rot)
            root_vel = rot.quat_rotate(hi, root_vel)
            root_ang_vel = rot.quat_rotate(hi, root_ang_vel)
            key_pos = rot.quat_rotate(hi[..., None, :], key_pos)
            hit = rot.calc_heading_quat_inv(ref.root_rot)
            tr_rot = rot.quat_mul(hit, tr_rot)
            tr_vel = rot.quat_rotate(hit, tr_vel)
            tr_ang = rot.quat_rotate(hit, tr_ang)
            ref_key = rot.quat_rotate(hit[..., None, :], ref_key)

        root_rot_err = rot.quat_diff_angle(root_rot, tr_rot)**2
        root_vel_err = torch.sum((tr_vel - root_vel)**2, dim=-1)
        root_ang_err = torch.sum((tr_ang - root_ang_vel)**2, dim=-1)
        key_pos_err = torch.sum((ref_key - key_pos)**2, dim=(-2, -1))

        pose_r = torch.exp(-pose_scale * pose_err)
        vel_r = torch.exp(-vel_scale * vel_err)
        root_pose_r = torch.exp(-root_pose_scale
                                * (root_pos_err + 0.1 * root_rot_err))
        root_vel_r = torch.exp(-root_vel_scale
                               * (root_vel_err + 0.1 * root_ang_err))
        key_pos_r = torch.exp(-key_pos_scale * key_pos_err)

        reward = (cfg.pose_w * pose_r + cfg.vel_w * vel_r
                  + cfg.root_pos_w * root_pose_r
                  + cfg.root_vel_w * root_vel_r
                  + cfg.key_pos_w * key_pos_r)

        contact_r = torch.zeros_like(reward)
        if cfg.use_contact_info:
            forces = torch.clamp(
                torch.linalg.vector_norm(sim.contact_forces, dim=-1), max=1.0)
            per_body = (ref.contacts * forces
                        - (1.0 - ref.contacts) * forces)
            contact_r = torch.mean(self.contact_weights * per_body, dim=-1)
            reward = reward + contact_r

        components = torch.stack(
            [pose_r, vel_r, root_pose_r, root_vel_r, key_pos_r, contact_r],
            dim=-1)
        return reward, components

    # ------------------------------------------------------------------
    # Termination
    # ------------------------------------------------------------------

    def _compute_done(self, lib: ml.MotionLib, state: EnvState,
                      ref: ml.MotionFrame, ref_body_pos: torch.Tensor):
        cfg = self.cfg
        sim = state.sim
        done = torch.full_like(state.done, DoneFlags.NULL)

        timeout = ((state.time >= cfg.episode_length)
                   | (state.motion_times >= lib.lengths[state.motion_ids]))
        done = torch.where(timeout, DoneFlags.TIME, done)

        if cfg.enable_early_termination:
            failed = torch.zeros(state.done.shape, dtype=torch.bool,
                                 device=self.device)
            if len(self.contact_body_ids) > 0:
                allowed = self.contact_allowed
                masked = torch.where(allowed[None, :, None],
                                     torch.zeros_like(sim.contact_forces),
                                     sim.contact_forces)
                fall_contact = torch.any(
                    torch.any(torch.abs(masked) > 0.1, dim=-1), dim=-1)
                # body height relative to the terrain under the root
                ground_h = obs_mod.compute_hf_obs(
                    lib.terrain_hf, lib.terrain_min_point, lib.terrain_dxdy,
                    state.motion_ids, sim.root_pos[..., None, 0:2],
                    torch.zeros_like(sim.root_pos), -100.0, 100.0)[..., 0]
                rel_h = sim.body_pos[..., 2] - ground_h[..., None]
                low = (rel_h < cfg.termination_height) & ~allowed[None, :]
                fall_height = torch.any(low, dim=-1)
                failed = failed | (fall_contact & fall_height)

            if cfg.pose_termination:
                body_rel = (sim.body_pos[..., 1:, :]
                            - sim.body_pos[..., 0:1, :])
                ref_rel = ref_body_pos[..., 1:, :] - ref_body_pos[..., 0:1, :]
                dist2 = torch.sum((ref_rel - body_rel)**2, dim=-1)
                pose_fail = torch.any(dist2 > self.pose_term_dist**2, dim=-1)
                if cfg.track_root:
                    root_dist2 = torch.sum(
                        (sim.root_pos - ref.root_pos)**2, dim=-1)
                    pose_fail |= (root_dist2
                                  > cfg.root_pos_termination_dist**2)
                    rot_err = rot.quat_diff_angle(sim.root_rot, ref.root_rot)
                    pose_fail |= (torch.abs(rot_err)
                                  > cfg.root_rot_termination_angle)
                failed = failed | pose_fail

            failed = failed & (state.time > 1e-5)
            # FAIL overrides a simultaneous TIME: a failing env must not
            # bootstrap its value target
            done = torch.where(failed, DoneFlags.FAIL, done)
        return done

    def _tracking_error(self, state: EnvState, ref: ml.MotionFrame,
                        ref_body_pos, ref_body_rot):
        """7-component tracking error."""
        sim = state.sim
        norm = torch.linalg.vector_norm
        body_rot = sim.body_rot[..., 1:, :]
        pose_err = torch.mean(
            torch.abs(rot.quat_diff_angle(body_rot, ref_body_rot[..., 1:, :])),
            dim=-1)
        root_pos_err = norm(ref.root_pos - sim.root_pos, dim=-1)
        body_rel = sim.body_pos - sim.root_pos[..., None, :]
        ref_rel = ref_body_pos - ref.root_pos[..., None, :]
        body_pos_err = torch.mean(norm(ref_rel - body_rel, dim=-1), dim=-1)
        root_rot_err = torch.abs(
            rot.quat_diff_angle(sim.root_rot, ref.root_rot))
        dof_vel_err = torch.mean(torch.abs(ref.dof_vel - sim.dof_vel), dim=-1)
        root_vel_err = torch.mean(torch.abs(ref.root_vel - sim.root_vel),
                                  dim=-1)
        root_ang_err = torch.mean(
            torch.abs(ref.root_ang_vel - sim.root_ang_vel), dim=-1)
        return torch.stack([root_pos_err, root_rot_err, body_pos_err,
                            pose_err, dof_vel_err, root_vel_err,
                            root_ang_err], dim=-1)

    def _physics(self, lib: ml.MotionLib, state: EnvState,
                 actions: torch.Tensor) -> engine.SimState:
        """One control step of the physics; each env collides with its
        motion's terrain in the lib's stack."""
        batched_terrain = terrain_lib.Terrain(
            hf=lib.terrain_hf,
            hf_mask=torch.zeros_like(lib.terrain_hf, dtype=torch.bool),
            hf_maxmin=lib.terrain_maxmin,
            min_point=lib.terrain_min_point,
            dxdy=lib.terrain_dxdy)
        return engine.control_step(
            self.model, self.sim_params, batched_terrain, state.sim, actions,
            sim_steps=self.cfg.sim_steps_per_control,
            terrain_idx=state.motion_ids)

    def _fail_rate_ema(self, lib: ml.MotionLib, state: EnvState,
                       done: torch.Tensor) -> torch.Tensor:
        """The per-motion fail-rate EMA after a step's done flags
        (per-motion sums by index_add_)."""
        is_done = (done != DoneFlags.NULL).float()
        is_fail = (done == DoneFlags.FAIL).float()
        m = lib.num_motions
        cnt = self._zeros(m).index_add_(0, state.motion_ids, is_done)
        fails = self._zeros(m).index_add_(0, state.motion_ids,
                                          is_fail * is_done)
        obs_rate = fails / torch.clamp(cnt, min=1.0)
        ema = self.cfg.fail_rate_ema
        return torch.where(cnt > 0,
                           ema * state.fail_rates + (1 - ema) * obs_rate,
                           state.fail_rates)

    # ------------------------------------------------------------------
    # Step
    # ------------------------------------------------------------------

    def step(self, lib: ml.MotionLib, state: EnvState,
             actions: torch.Tensor,
             reset_pool: Optional[ResetPool] = None,
             pool_slot: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> EnvState:
        """One control step with masked auto-reset of done envs.

        With ``reset_pool`` (training rollouts), done envs pull their reset
        state + obs from the pre-sampled pool (entry ``pool_slot``).
        Without it, the reset state is sampled with ``generator`` and
        observed inline.
        """
        if reset_pool is None and generator is None:
            raise ValueError("step needs a reset_pool or a generator")
        with annotate("parc.env.step"):
            state = state.replace(sim=self._physics(lib, state, actions))
            return self._post_physics(lib, lib, state, reset_pool, pool_slot,
                                      generator)

    # state fields the post-physics chain never reads: left out of the
    # graph's inputs
    _UNREAD = ("obs", "terminal_obs", "reward", "terminal_times",
               "reward_components", "tracking_error")

    def _post_physics(self, owner, lib: ml.MotionLib, state: EnvState,
                      reset_pool: Optional[ResetPool],
                      pool_slot: Optional[torch.Tensor],
                      generator: Optional[torch.Generator]) -> EnvState:
        """:meth:`_after_physics`, replayed as one CUDA graph on a pooled
        CUDA step (envs/step_graph.py; captured again for another
        ``owner``, the lib the caller passes, or other shapes), else run
        eagerly: a step that samples its resets with ``generator`` draws
        inside the chain, and the CPU has no graphs."""
        if reset_pool is None or not state.sim.root_pos.is_cuda:
            return self._after_physics(lib, state, reset_pool, pool_slot,
                                       generator)
        view = state.replace(**{f: None for f in self._UNREAD})
        key = (state.done.shape[0], reset_pool.k)
        graph = self._step_graph
        if graph is None or not graph.serves(owner, key):
            self._step_graph = None  # the old graph's memory, freed first
            graph = self._step_graph = step_graph.StepGraph(
                owner, key,
                lambda args, pool: self._after_physics(lib, args[0], pool,
                                                       args[1], None),
                (view, pool_slot), reset_pool, hold=lib)
        return graph((view, pool_slot), reset_pool, like=state)

    def _after_physics(self, lib: ml.MotionLib, state: EnvState,
                       reset_pool: Optional[ResetPool],
                       pool_slot: Optional[torch.Tensor],
                       generator: Optional[torch.Generator]) -> EnvState:
        """The step after the physics, a function of tensors: ``state``
        holds the physics' output in ``sim``; the clocks advance, then
        reward, done, tracking error, the fail-rate EMA, the observation
        and the masked reset (from ``reset_pool``, or sampled with
        ``generator``)."""
        cfg = self.cfg
        time = state.time + cfg.control_dt
        motion_times = state.motion_times + cfg.control_dt
        state = state.replace(time=time, motion_times=motion_times)

        with annotate("parc.env.reference"):
            ref = ml.calc_motion_frame(lib, state.motion_ids, motion_times)
            ref_body_pos, ref_body_rot = cm.forward_kinematics(
                self.model, ref.root_pos, ref.root_rot, ref.joint_rot)

        with annotate("parc.env.reward"):
            reward, comps = self._compute_reward(state, ref, ref_body_pos)
            done = self._compute_done(lib, state, ref, ref_body_pos)
            track_err = self._tracking_error(state, ref, ref_body_pos,
                                             ref_body_rot)
            is_done = done != DoneFlags.NULL
            fail_rates = self._fail_rate_ema(lib, state, done)

        with annotate("parc.env.obs"):
            obs = self._compute_obs(lib, state)

        # masked reset of done envs
        with annotate("parc.env.reset"):
            n = state.done.shape[0]
            if reset_pool is not None:
                r_sim, r_ids, r_times, r_obs = _pool_take(reset_pool,
                                                          pool_slot, n)
            else:
                r_ids, r_times, r_sim = self._sample_reset(
                    lib, generator, n, fail_rates)
                r_obs = self._compute_obs(
                    lib, self._obs_view(r_sim, r_ids, r_times))

            def sel(a, b):
                mask = is_done.reshape(is_done.shape + (1,) * (a.ndim - 1))
                return torch.where(mask, a, b)

            # masked select only over the per-env fields; done/reward/stats
            # report the pre-reset values, and the pre-reset obs is kept for
            # terminal bootstrapping
            return state.replace(
                sim=engine.where_state(is_done, r_sim, state.sim),
                obs=sel(r_obs, obs),
                motion_ids=sel(r_ids, state.motion_ids),
                motion_times=sel(r_times, state.motion_times),
                start_times=sel(r_times, state.start_times),
                time=sel(torch.zeros_like(time), time),
                done=done, reward=reward, terminal_obs=obs,
                terminal_times=time, fail_rates=fail_rates,
                reward_components=comps, tracking_error=track_err)
