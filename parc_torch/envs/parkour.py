"""Parkour env: the composed training environment (dm + mgdm envs).

N envs are split into a ``dm`` fraction, the first ``N - mgdm_num`` rows,
that tracks dataset clips on their per-motion terrains (as
:class:`~parc_torch.envs.deepmimic.DeepMimicEnv` does), and an ``mgdm``
fraction whose reference motion the MDM generates online on one shared
procgen terrain. Every mgdm row replans at once, every ``plan_frames``
control steps: one batched DDIM call generates each row's next window from
the last two frames of its current one, toward the row's xy target.

Design:
* the generated references live in a fixed-shape window buffer in the env
  state (``ParkourState.ref_frames34`` / ``ref_contacts``), read by
  :func:`_buffer_frame`;
* the replan timer is a Python int: it is the same for every row and
  never depends on data, so the step decides on the host whether to
  replan, without reading the device;
* the mgdm terrain is appended to the MotionLib as a zero-weight terrain
  slot (``motion_lib.append_terrain_slot``), so the physics' terrain stack,
  the hf observation and the fail-rate statistics serve the mgdm rows
  through their motion id;
* the MDM's state rides in a :class:`ParkourLib` bundle beside the
  MotionLib, passed wherever PPO passes ``lib``.

Random draws split into ``draw_*`` methods and pure functions of explicit
draws (:class:`TargetDraws`, :class:`StandingDraws`, :class:`ReplanDraws`),
so a caller can hand in draws made elsewhere.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_lib as ml
from parc_torch.diffusion import gen as gen_lib
from parc_torch.diffusion.mdm import MDM, MDMState
from parc_torch.envs.base import DoneFlags, EnvConfig, EnvState
from parc_torch.envs.deepmimic import DeepMimicEnv, ResetPool, _pool_take
from parc_torch.physics import engine
from parc_torch.utils import rotation as rot
from parc_torch.utils import terrain as terrain_lib
from parc_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class ParkourConfig:
    """The env split and the mgdm rows' replan and target settings."""

    mgdm_num: int = 0               # envs [N-mgdm_num, N) use the MDM
    plan_frames: int = 15           # generated window length (control steps)
    target_radius: float = 3.0
    min_target_dist: float = 1.0
    ddim_stride: int = 20
    guidance_scale: float = 1.0
    spawn_margin_cells: int = 4
    # out-of-bounds z termination of mgdm rows (generated references can
    # wander off the terrain)
    oob_z_low: float = -3.0
    oob_z_high: float = 6.0


@dataclasses.dataclass
class ParkourLib:
    """A MotionLib (terrain slot appended) and the MDM state that
    generates the mgdm rows' references."""

    lib: ml.MotionLib
    mdm_state: MDMState

    @property
    def num_motions(self) -> int:
        return self.lib.num_motions


@dataclasses.dataclass
class ParkourResetPool(ResetPool):
    """ResetPool + fresh standing windows and targets for the mgdm rows,
    flattened [k*Nm]."""

    ref_frames34: Optional[torch.Tensor] = None
    ref_contacts: Optional[torch.Tensor] = None
    target_xy: Optional[torch.Tensor] = None


@dataclasses.dataclass
class ParkourState(EnvState):
    ref_frames34: torch.Tensor   # (Nm, T, 34) generated reference windows
    ref_contacts: torch.Tensor   # (Nm, T, B)
    target_xy: torch.Tensor      # (Nm, 2)
    replan_timer: int            # steps until the next synchronized replan
    # (Nm,) {0,1}: the row's window is a synthetic standing anchor (spawn
    # or reset); the next replan drops the prev-state condition for it
    ref_synthetic: torch.Tensor


@dataclasses.dataclass
class TargetDraws:
    """Uniform [0, 1) draws of n xy targets: the angle's and the
    radius's."""

    ang_u: torch.Tensor  # (n,)
    rad_u: torch.Tensor  # (n,)


@dataclasses.dataclass
class StandingDraws:
    """Draws of n standing spawns: the xy position's uniforms and the
    first target's."""

    pos_u: torch.Tensor  # (n, 2)
    target: TargetDraws


@dataclasses.dataclass
class ReplanDraws:
    """Draws of one replan: the DDIM x_T of every mgdm row and the targets
    of the rows that reached theirs."""

    noise: torch.Tensor  # (Nm, seq_len, frame_dim)
    target: TargetDraws


def _buffer_frame(model: cm.CharModel, frames34: torch.Tensor,
                  contacts: torch.Tensor, times: torch.Tensor,
                  fps: float) -> ml.MotionFrame:
    """A MotionFrame from (N, T, 34) window buffers at ``times`` (seconds,
    clamped to the window); ``times`` is (N,) or (N, S) with a trailing
    steps axis. Poses are slerped between frames; velocities are forward
    differences at the earlier frame (the dof velocity by the small-angle
    exp-map of the dof difference)."""
    t_len = frames34.shape[1]
    fidx = torch.clamp(times * fps, 0.0, t_len - 1)
    i0 = torch.floor(fidx).long()
    i1 = torch.clamp(i0 + 1, max=t_len - 1)
    blend = (fidx - i0.to(fidx.dtype))[..., None]
    n_idx = torch.arange(frames34.shape[0], device=frames34.device)
    n_idx = n_idx.reshape((-1,) + (1,) * (times.ndim - 1))
    f0 = frames34[n_idx, i0]
    f1 = frames34[n_idx, i1]
    c = (1 - blend) * contacts[n_idx, i0] + blend * contacts[n_idx, i1]

    root_pos = (1 - blend) * f0[..., 0:3] + blend * f1[..., 0:3]
    q0 = rot.exp_map_to_quat(f0[..., 3:6])
    q1 = rot.exp_map_to_quat(f1[..., 3:6])
    root_rot = rot.slerp(q0, q1, blend[..., 0])
    j0 = cm.dof_to_rot(model, f0[..., 6:])
    j1 = cm.dof_to_rot(model, f1[..., 6:])
    joint_rot = rot.slerp(j0, j1, blend)

    fps = float(fps)
    root_vel = (f1[..., 0:3] - f0[..., 0:3]) * fps
    dq = rot.quat_diff(q0, q1)
    root_ang_vel = rot.quat_to_exp_map(dq) * fps
    dof_vel_exp = cm.joint_exp_maps(model, f1[..., 6:] - f0[..., 6:])
    dof_vel = cm.project_to_dof(model, dof_vel_exp) * fps
    return ml.MotionFrame(root_pos=root_pos, root_rot=root_rot,
                          root_vel=root_vel, root_ang_vel=root_ang_vel,
                          joint_rot=joint_rot, dof_vel=dof_vel, contacts=c)


def _cat_frames(a: ml.MotionFrame, b: ml.MotionFrame) -> ml.MotionFrame:
    return ml.MotionFrame(**{f: torch.cat([getattr(a, f), getattr(b, f)])
                             for f in vars(a)})


class ParkourEnv(DeepMimicEnv):
    """DeepMimicEnv with an MDM-driven env fraction."""

    def __init__(self, model: cm.CharModel, sim_params: engine.SimParams,
                 cfg: EnvConfig, pcfg: ParkourConfig, mdm: MDM,
                 mgdm_terrain: terrain_lib.Terrain, device="cuda"):
        super().__init__(model, sim_params, cfg, device=device)
        if not 0 <= pcfg.mgdm_num <= cfg.num_envs:
            raise ValueError(f"mgdm_num {pcfg.mgdm_num} not in [0, "
                             f"{cfg.num_envs}]")
        self.pcfg = pcfg
        self.mdm = mdm
        dev = self.device
        self.mgdm_terrain = terrain_lib.Terrain(
            **{f: getattr(mgdm_terrain, f).to(dev)
               for f in ("hf", "hf_mask", "hf_maxmin", "min_point", "dxdy")})
        n = cfg.num_envs
        self.n_dm = n - pcfg.mgdm_num
        self.mgdm_mask = torch.zeros(n, dtype=torch.bool, device=dev)
        self.mgdm_mask[self.n_dm:] = True
        names = list(model.body_names)
        self.foot_ids = [i for i, nm in enumerate(names) if "foot" in nm]

    # -- data parallelism ------------------------------------------------
    def local_shard(self, n_shards: int) -> "ParkourEnv":
        """Per-rank env for data parallelism: both the env batch and the
        mgdm fraction split over the ranks, so each rank runs its own
        replans on its own mgdm rows (the reference trains the parkour
        composition data-parallel the same way: every process owns a
        dm + mgdm slice, ig_parkour_env.py:53 + mp_optimizer.py:83-90).
        The replan timer is the same Python int on every rank, so every
        rank replans on the same step. The global state must be laid out
        shard-major first (:meth:`shard_row_permutation`), so that rank r's
        contiguous block is ``[n_dm/D dm rows | mgdm_num/D mgdm rows]``."""
        for what, v in (("num_envs", self.cfg.num_envs),
                        ("mgdm_num", self.pcfg.mgdm_num)):
            if v % n_shards:
                raise ValueError(f"{what} {v} not divisible by {n_shards}")
        cfg = dataclasses.replace(self.cfg,
                                  num_envs=self.cfg.num_envs // n_shards)
        pcfg = dataclasses.replace(self.pcfg,
                                   mgdm_num=self.pcfg.mgdm_num // n_shards)
        return ParkourEnv(self.model, self.sim_params, cfg, pcfg, self.mdm,
                          self.mgdm_terrain, device=self.device)

    def shard_row_permutation(self, n_shards: int) -> np.ndarray:
        """Env-row permutation from the global ``[dm... | mgdm...]`` layout
        to shard-major blocks ``[dm_0|mg_0, dm_1|mg_1, ...]``: after it,
        rank r's contiguous block of the env batch is the local layout that
        :meth:`local_shard` expects. The per-mgdm-row buffers (leading dim
        mgdm_num) already split into contiguous blocks and need none."""
        nd, nm = self.n_dm, self.pcfg.mgdm_num
        if nd % n_shards or nm % n_shards:
            raise ValueError(f"dm rows {nd} and mgdm rows {nm} must both "
                             f"divide by {n_shards}")
        dm = np.arange(nd).reshape(n_shards, -1)
        mg = nd + np.arange(nm).reshape(n_shards, -1)
        return np.concatenate([dm, mg], axis=1).reshape(-1)

    # -- lib plumbing ----------------------------------------------------
    def make_lib(self, lib: ml.MotionLib, mdm_state: MDMState) -> ParkourLib:
        """Bundle a dataset lib (terrain slot appended) with MDM weights."""
        return ParkourLib(lib=ml.append_terrain_slot(lib, self.mgdm_terrain),
                          mdm_state=mdm_state)

    @staticmethod
    def _unwrap(bundle):
        if isinstance(bundle, ParkourLib):
            # mgdm rows must not time out on the dummy slot's length
            lib = bundle.lib
            lengths = lib.lengths.clone()
            lengths[-1] = 1e9
            return (dataclasses.replace(lib, lengths=lengths),
                    bundle.mdm_state)
        return bundle, None

    # -- draws -------------------------------------------------------------
    def draw_targets(self, generator: torch.Generator, n: int
                     ) -> TargetDraws:
        def u():
            return torch.rand((n,), generator=generator, device=self.device)
        return TargetDraws(ang_u=u(), rad_u=u())

    def draw_standing(self, generator: torch.Generator, n: int
                      ) -> StandingDraws:
        pos_u = torch.rand((n, 2), generator=generator, device=self.device)
        return StandingDraws(pos_u=pos_u,
                             target=self.draw_targets(generator, n))

    def draw_replan(self, generator: torch.Generator) -> ReplanDraws:
        nm, mdm = self.pcfg.mgdm_num, self.mdm
        noise = torch.randn((nm, mdm.scfg.seq_len, mdm.frame_dim),
                            generator=generator, device=self.device)
        return ReplanDraws(noise=noise, target=self.draw_targets(generator,
                                                                 nm))

    # -- mgdm helpers ------------------------------------------------------
    def _sample_targets(self, draws: TargetDraws,
                        root_xy: torch.Tensor) -> torch.Tensor:
        pcfg = self.pcfg
        ang = draws.ang_u * (2 * math.pi)
        rad = pcfg.min_target_dist + draws.rad_u * (
            pcfg.target_radius - pcfg.min_target_dist)
        tgt = root_xy + torch.stack([torch.cos(ang) * rad,
                                     torch.sin(ang) * rad], dim=-1)
        t = self.mgdm_terrain
        m = 2 * t.dxdy
        return torch.clamp(tgt, min=t.min_point + m, max=t.max_point - m)

    def _standing_windows(self, draws: StandingDraws):
        """Standing reference windows at the drawn spawns on the mgdm
        terrain, and their first targets."""
        pcfg = self.pcfg
        t = self.mgdm_terrain
        m = pcfg.spawn_margin_cells * t.dxdy
        n = draws.pos_u.shape[0]
        xy = t.min_point + m + draws.pos_u * (t.max_point - t.min_point
                                              - 2 * m)
        ground = terrain_lib.get_hf_val(t, xy)
        frames = self._zeros(n, pcfg.plan_frames, 34)
        frames[..., 0:2] = xy[:, None, :]
        frames[..., 2] = (ground + 0.94)[:, None]
        contacts = self._zeros(n, pcfg.plan_frames, self.model.num_bodies)
        contacts[..., self.foot_ids] = 1.0
        return frames, contacts, self._sample_targets(draws.target, xy)

    def _replan(self, mdm_state: MDMState, state: ParkourState,
                draws: ReplanDraws) -> ParkourState:
        """The synchronized batched replan of the mgdm rows."""
        with annotate("parc.env.replan"):
            pcfg = self.pcfg
            # rows whose window is a synthetic standing anchor generate
            # unconditioned on it; after this every row holds a generated
            # one
            new_f, new_c = gen_lib.gen_mdm_motion(
                self.mdm, mdm_state, None, state.ref_frames34[:, -2:],
                state.ref_contacts[:, -2:], self.mgdm_terrain, state.target_xy,
                settings=gen_lib.GenSettings(
                    ddim_stride=pcfg.ddim_stride,
                    guidance_scale=pcfg.guidance_scale),
                prev_state_mask=1.0 - state.ref_synthetic, noise=draws.noise)
            root_xy = new_f[:, -1, 0:2]
            reached = torch.linalg.vector_norm(state.target_xy - root_xy,
                                               dim=-1) < 0.75
            target_xy = torch.where(
                reached[:, None], self._sample_targets(draws.target, root_xy),
                state.target_xy)
            # mgdm rows restart their window clock
            mt = state.motion_times.clone()
            mt[self.n_dm:] = 0.0
            return state.replace(
                ref_frames34=new_f[:, :pcfg.plan_frames],
                ref_contacts=new_c[:, :pcfg.plan_frames],
                target_xy=target_xy, motion_times=mt,
                replan_timer=pcfg.plan_frames,
                ref_synthetic=torch.zeros_like(state.ref_synthetic))

    def _combined_ref(self, lib: ml.MotionLib, state: ParkourState,
                      times: Optional[torch.Tensor] = None
                      ) -> ml.MotionFrame:
        """Reference frames: the dataset lib for dm rows, the window buffer
        for mgdm rows. ``times`` defaults to ``state.motion_times`` and may
        carry a steps axis."""
        t = state.motion_times if times is None else times
        nd = self.n_dm
        ids = state.motion_ids[:nd].reshape((nd,) + (1,) * (t.ndim - 1))
        dm_ref = ml.calc_motion_frame(lib, ids.expand(t[:nd].shape), t[:nd])
        if self.pcfg.mgdm_num == 0:
            return dm_ref
        mg_ref = _buffer_frame(self.model, state.ref_frames34,
                               state.ref_contacts, t[nd:],
                               1.0 / self.cfg.control_dt)
        return _cat_frames(dm_ref, mg_ref)

    def _spawn_on_buffer(self, lib, view: ParkourState) -> engine.SimState:
        """``view.sim`` with the mgdm rows respawned on their windows'
        first frame."""
        ref = self._combined_ref(lib, view)
        root_pos = ref.root_pos.clone()
        root_pos[..., 2] += self.cfg.ref_height_buffer
        fresh = engine.create_state(
            self.model, root_pos=root_pos, root_rot=ref.root_rot,
            joint_rot=ref.joint_rot, root_vel=ref.root_vel,
            root_ang_vel=ref.root_ang_vel, dof_vel=ref.dof_vel,
            device=self.device)
        return engine.where_state(self.mgdm_mask, fresh, view.sim)

    # -- public API --------------------------------------------------------
    def reset(self, bundle, generator: torch.Generator,
              num_envs: Optional[int] = None,
              motion_ids: Optional[torch.Tensor] = None,
              start_times: Optional[torch.Tensor] = None,
              draws: Optional[StandingDraws] = None) -> ParkourState:
        """Full reset; the mgdm rows spawn on standing windows (``draws``,
        or drawn from ``generator``) and replan at the first step."""
        lib, _ = self._unwrap(bundle)
        n = num_envs or self.cfg.num_envs
        base = super().reset(lib, generator, num_envs=n,
                             motion_ids=motion_ids, start_times=start_times)
        nm = self.pcfg.mgdm_num
        if draws is None:
            draws = self.draw_standing(generator, nm)
        frames, contacts, targets = self._standing_windows(draws)
        state = ParkourState(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(EnvState)},
            ref_frames34=frames, ref_contacts=contacts, target_xy=targets,
            replan_timer=1, ref_synthetic=self._zeros(nm) + 1.0)
        if nm == 0:
            return state
        # pin mgdm rows to the terrain slot and respawn them on the buffer
        ids = state.motion_ids.clone()
        ids[self.n_dm:] = lib.num_motions - 1
        mt = state.motion_times.clone()
        mt[self.n_dm:] = 0.0
        state = state.replace(motion_ids=ids, motion_times=mt,
                              start_times=mt)
        state = state.replace(sim=self._spawn_on_buffer(lib, state))
        obs0 = self._compute_obs_parkour(lib, state)
        return state.replace(obs=obs0, terminal_obs=obs0)

    def _parkour_view(self, sim, ids, times, frames, contacts,
                      targets) -> ParkourState:
        """A minimal ParkourState for _combined_ref / the observation."""
        base = self._obs_view(sim, ids, times)
        if frames is None:
            frames = self._zeros(0, self.pcfg.plan_frames, 34)
            contacts = self._zeros(0, self.pcfg.plan_frames,
                                   self.model.num_bodies)
            targets = self._zeros(0, 2)
        return ParkourState(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(EnvState)},
            ref_frames34=frames, ref_contacts=contacts, target_xy=targets,
            replan_timer=1, ref_synthetic=self._zeros(frames.shape[0]) + 1.0)

    def _sample_reset_parkour(self, lib, generator: torch.Generator, n: int,
                              fail_rates: torch.Tensor,
                              draws: Optional[StandingDraws] = None):
        """One full reset batch: dm rows resampled from the dataset, mgdm
        rows respawned on fresh standing windows; the states and their
        observations (the inline reset path and build_reset_pool)."""
        nm = self.pcfg.mgdm_num
        ids, times, sim = self._sample_reset(lib, generator, n, fail_rates)
        frames = contacts = targets = None
        if nm > 0:
            if draws is None:
                draws = self.draw_standing(generator, nm)
            frames, contacts, targets = self._standing_windows(draws)
            ids[self.n_dm:] = lib.num_motions - 1
            times[self.n_dm:] = 0.0
        view = self._parkour_view(sim, ids, times, frames, contacts,
                                  targets)
        if nm > 0:
            sim = self._spawn_on_buffer(lib, view)
            view = view.replace(sim=sim)
        obs = self._compute_obs_parkour(lib, view)
        return sim, ids, times, obs, frames, contacts, targets

    def build_reset_pool(self, bundle, generator: torch.Generator,
                         fail_rates: torch.Tensor, n: int, k: int = 4,
                         draws: Optional[List[StandingDraws]] = None
                         ) -> ParkourResetPool:
        """k full reset batches + their obs (see ResetPool); ``draws``
        gives each batch's standing draws."""
        lib, _ = self._unwrap(bundle)
        outs = [self._sample_reset_parkour(
            lib, generator, n, fail_rates,
            None if draws is None else draws[c]) for c in range(k)]

        def cat(i):
            if outs[0][i] is None:
                return None
            return torch.cat([o[i] for o in outs])

        sim = engine.SimState(**{
            f: torch.cat([getattr(o[0], f) for o in outs])
            for f in vars(outs[0][0])})
        return ParkourResetPool(
            sim=sim, motion_ids=cat(1), times=cat(2), obs=cat(3),
            ref_frames34=cat(4), ref_contacts=cat(5), target_xy=cat(6), k=k)

    def _compute_obs_parkour(self, lib, state: ParkourState) -> torch.Tensor:
        times = (state.motion_times[..., None]
                 + self.tar_steps * self.cfg.control_dt)
        tar = self._combined_ref(lib, state, times)
        return self._compute_obs(lib, state, tar=tar)

    def step(self, bundle, state: ParkourState, actions: torch.Tensor,
             reset_pool: Optional[ParkourResetPool] = None,
             pool_slot: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             replan_draws: Optional[ReplanDraws] = None) -> ParkourState:
        """One control step with the synchronized replan of the mgdm rows
        (when their timer runs out) and the masked auto-reset of done envs
        (from ``reset_pool``, or sampled with ``generator``). The replan
        draws come from ``replan_draws`` or ``generator``."""
        if reset_pool is None and generator is None:
            raise ValueError("step needs a reset_pool or a generator")
        with annotate("parc.env.step"):
            lib, mdm_state = self._unwrap(bundle)
            state = self._replan_if_due(mdm_state, state, generator,
                                        replan_draws)
            state = state.replace(sim=self._physics(lib, state, actions))
            return self._post_physics(bundle, lib, state, reset_pool,
                                      pool_slot, generator)

    def _replan_if_due(self, mdm_state: MDMState, state: ParkourState,
                       generator: Optional[torch.Generator],
                       replan_draws: Optional[ReplanDraws]) -> ParkourState:
        """The replan timer's tick, and the synchronized replan of the mgdm
        rows when it runs out."""
        if self.pcfg.mgdm_num == 0:
            return state
        state = state.replace(replan_timer=state.replan_timer - 1)
        if state.replan_timer <= 0:
            if replan_draws is None:
                if generator is None:
                    raise ValueError("a replan needs a generator or "
                                     "replan_draws")
                replan_draws = self.draw_replan(generator)
            state = self._replan(mdm_state, state, replan_draws)
        return state

    def _after_physics(self, lib, state: ParkourState,
                       reset_pool: Optional[ParkourResetPool],
                       pool_slot: Optional[torch.Tensor],
                       generator: Optional[torch.Generator]) -> ParkourState:
        """DeepMimicEnv._after_physics against the combined reference, with
        the mgdm rows' out-of-bounds termination and the masked reset of
        their windows and targets."""
        cfg = self.cfg
        nm, nd = self.pcfg.mgdm_num, self.n_dm
        sim = state.sim
        state = state.replace(time=state.time + cfg.control_dt,
                              motion_times=state.motion_times + cfg.control_dt)

        # --- reward / done / obs against the combined reference ----------
        with annotate("parc.env.reference"):
            ref = self._combined_ref(lib, state)
            ref_body_pos, ref_body_rot = cm.forward_kinematics(
                self.model, ref.root_pos, ref.root_rot, ref.joint_rot)
        with annotate("parc.env.reward"):
            reward, comps = self._compute_reward(state, ref, ref_body_pos)
            done = self._compute_done(lib, state, ref, ref_body_pos)
            if nm > 0:
                # out-of-bounds z kills mgdm rows far below or above the
                # ground under them
                z = sim.root_pos[nd:, 2]
                ground = terrain_lib.get_hf_val(self.mgdm_terrain,
                                                sim.root_pos[nd:, 0:2])
                oob = ((z - ground < self.pcfg.oob_z_low)
                       | (z - ground > self.pcfg.oob_z_high))
                mg_done = torch.where(oob & (done[nd:] == DoneFlags.NULL),
                                      DoneFlags.FAIL, done[nd:])
                done = torch.cat([done[:nd], mg_done])
            track_err = self._tracking_error(state, ref, ref_body_pos,
                                             ref_body_rot)
            is_done = done != DoneFlags.NULL
            fail_rates = self._fail_rate_ema(lib, state, done)
        with annotate("parc.env.obs"):
            obs = self._compute_obs_parkour(lib, state)

        # --- masked reset ------------------------------------------------
        with annotate("parc.env.reset"):
            n = done.shape[0]
            if reset_pool is not None:
                r_sim, r_ids, r_times, r_obs = _pool_take(reset_pool,
                                                          pool_slot, n)
                if nm > 0:
                    idxm = (pool_slot[nd:].long() * nm
                            + torch.arange(nm, device=self.device))
                    r_frames = reset_pool.ref_frames34[idxm]
                    r_contacts = reset_pool.ref_contacts[idxm]
                    r_targets = reset_pool.target_xy[idxm]
            else:
                (r_sim, r_ids, r_times, r_obs, r_frames, r_contacts,
                 r_targets) = self._sample_reset_parkour(
                     lib, generator, n, fail_rates)

            def sel(a, b):
                mask = is_done.reshape(is_done.shape + (1,) * (a.ndim - 1))
                return torch.where(mask, a, b)

            new_frames, new_contacts = state.ref_frames34, state.ref_contacts
            new_targets, new_synth = state.target_xy, state.ref_synthetic
            if nm > 0:
                mg = is_done[nd:]
                new_frames = torch.where(mg[:, None, None], r_frames,
                                         new_frames)
                new_contacts = torch.where(mg[:, None, None], r_contacts,
                                           new_contacts)
                new_targets = torch.where(mg[:, None], r_targets, new_targets)
                # reset rows land on synthetic standing windows again
                new_synth = torch.where(mg, 1.0, new_synth)

            time = state.time
            return state.replace(
                sim=engine.where_state(is_done, r_sim, sim),
                obs=sel(r_obs, obs),
                motion_ids=sel(r_ids, state.motion_ids),
                motion_times=sel(r_times, state.motion_times),
                start_times=sel(r_times, state.start_times),
                time=sel(torch.zeros_like(time), time),
                ref_frames34=new_frames, ref_contacts=new_contacts,
                target_xy=new_targets, ref_synthetic=new_synth,
                done=done, reward=reward, terminal_obs=obs,
                terminal_times=time, fail_rates=fail_rates,
                reward_components=comps, tracking_error=track_err)
