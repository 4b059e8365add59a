"""Interactive motion/terrain studio (MOTION_FORGE equivalent).

The reference ships MOTION_FORGE, a ~5.7k-LoC Polyscope/imgui desktop app
(MOTION_FORGE/motion_forge.py + include/*_gui.py): terrain editing, A*
path planning, MDM generation, motion editing, contact editing,
optimization, and Isaac-Gym-in-the-loop tracking.  A GPU server has no GL
stack, so this is a browser app: a zero-dependency stdlib HTTP server
(this file) drives the same framework operations on the studio's device,
and the front end is the html_viewer software renderer extended with an
edit panel.

    python -m parc_torch.pipeline.cli studio --input clip.npz [--port 8000]

Every operation is a method on :class:`Studio` returning JSON-able state,
so the whole surface is unit-testable without sockets. The server runs
each request on a thread of its own; every tensor an operation makes
names the studio's device, so no operation depends on a thread's current
CUDA device.

Reference parity map:
* terrain GUI (MOTION_FORGE/include/terrain_gui.py)      -> procgen/edit_cells
* path planning GUI (path_planning_gui.py)               -> astar
* diffusion GUI (diffusion_gui.py, mdm_tester.py)        -> mdm_gen
* optimization GUI (optimization_gui.py)                 -> optimize
* motion editing GUI (motion_editing_gui.py)             -> flip/resample/slice
* contact editing GUI (contact_editing_gui.py)           -> recompute_contacts
* IG-in-the-loop (isaac_gym_gui.py, global_header.py:464-657) -> track
  (full rollout) + sim_start/sim_step/sim_stop (live stepping session),
  both through the control-step kernel at one env
* io GUI (io_gui.py)                                     -> load/save
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Optional

import numpy as np
import torch

from parc_torch import resolve_device
from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_data as md
from parc_torch.utils.config import dataclass_from_dict

SIM_CHUNK = 8  # control steps a sim_step chunk advances


class StudioError(ValueError):
    """User-facing operation error (reported in the UI, not a crash)."""


def _default_terrain(x_dim: int = 24, y_dim: int = 24,
                     dx: float = 0.4) -> md.HostTerrain:
    hf = np.zeros((x_dim, y_dim), np.float32)
    return md.HostTerrain(
        hf=hf,
        min_point=np.asarray([-x_dim * dx / 2, -y_dim * dx / 2], np.float32),
        dxdy=np.asarray([dx, dx], np.float32))


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class Studio:
    """Server-side session state + operations, on ``device`` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, model: Optional[cm.CharModel] = None,
                 motion: Optional[md.MotionData] = None,
                 mdm_dir: Optional[str] = None,
                 tracker_dir: Optional[str] = None,
                 seed: int = 0, mdm_config: Optional[dict] = None,
                 workspace: Optional[str] = None,
                 tracker_config: Optional[dict] = None, device="cuda"):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # fixed here, on the caller's thread: the server's request
            # threads each start on CUDA device 0
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        if model is None:
            from parc_torch.data.humanoid import humanoid_spec
            model = humanoid_spec().build(device=dev)
        self.model = model.to(dev)
        # load/save are confined to this directory tree (the API is
        # reachable over HTTP; never expose arbitrary filesystem paths)
        self.workspace = os.path.realpath(workspace or os.getcwd())
        self.motion = motion
        self.overlay: Optional[md.MotionData] = None   # e.g. tracked result
        self.overlay_label = "overlay"
        self.path_world: Optional[np.ndarray] = None   # (P, 3)
        self.path_grid: Optional[np.ndarray] = None    # (P, 2) int
        self.mdm_dir = mdm_dir
        self.tracker_dir = tracker_dir
        self.mdm_config = mdm_config or {}  # MDMConfig overrides
        # PPOConfig overrides: the nets of the tracker in tracker_dir
        self.tracker_config = tracker_config or {}
        self.rng = np.random.default_rng(seed)
        self.status = "ready"
        self._sim = None

    # -- helpers ---------------------------------------------------------
    def _terrain(self) -> md.HostTerrain:
        if self.motion is None or self.motion.terrain is None:
            t = _default_terrain()
            if self.motion is None:
                from parc_torch.data.synthetic import standing_clip
                self.motion = standing_clip()
            self.motion.terrain = t
        return self.motion.terrain

    def _require_motion(self) -> md.MotionData:
        if self.motion is None:
            raise StudioError("no motion loaded")
        return self.motion

    def _on(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # -- state payload (what the front end renders) ----------------------
    def state(self) -> dict:
        from parc_torch.viewer.html_viewer import _clip_payload, _CLIP_COLORS
        clips = []
        if self.motion is not None:
            clips.append(_clip_payload(self.model, self.motion, "motion",
                                       _CLIP_COLORS[0]))
        if self.overlay is not None:
            clips.append(_clip_payload(self.model, self.overlay,
                                       self.overlay_label, _CLIP_COLORS[1]))
        if clips:
            all_pos = np.concatenate(
                [np.asarray(c["body_pos"]).reshape(-1, 3) for c in clips])
            center = np.round(all_pos.mean(axis=0), 3).tolist()
            fps = float(self.motion.fps)
        else:
            center, fps = [0.0, 0.0, 0.0], 30.0
        data = {
            "title": "parc_torch studio", "fps": fps,
            "parents": list(self.model.parent_indices),
            "clips": clips, "center": center,
            "path": (np.round(self.path_world, 3).tolist()
                     if self.path_world is not None else None),
            "status": self.status,
        }
        t = self.motion.terrain if self.motion is not None else None
        if t is not None:
            hf = np.asarray(t.hf, np.float64)
            data["terrain"] = {
                "hf": np.round(hf, 3).tolist(),
                "min_point": np.asarray(t.min_point,
                                        np.float64)[:2].tolist(),
                "dxdy": np.asarray(t.dxdy, np.float64)[:2].tolist(),
                "hmin": float(hf.min()), "hmax": float(hf.max()),
            }
        else:
            data["terrain"] = None
        return data

    # -- io ---------------------------------------------------------------
    def _workspace_path(self, path: str) -> str:
        """Resolve a user-supplied path, refusing escapes from workspace."""
        resolved = os.path.realpath(
            os.path.join(self.workspace, path) if not os.path.isabs(path)
            else path)
        if not (resolved == self.workspace
                or resolved.startswith(self.workspace + os.sep)):
            raise StudioError(
                f"path outside the studio workspace ({self.workspace})")
        return resolved

    def load(self, path: str) -> dict:
        self.motion = md.load_motion_data(self._workspace_path(path))
        self.overlay = None
        self.path_world = self.path_grid = None
        self.status = f"loaded {os.path.basename(path)}"
        return self.state()

    def save(self, path: str) -> dict:
        m = self._require_motion()
        path = self._workspace_path(path)
        md.save_motion_data(path, m)
        self.status = f"saved {path}"
        return self.state()

    # -- terrain -----------------------------------------------------------
    def procgen(self, kind: str = "boxes", x_dim: int = 24, y_dim: int = 24,
                dx: float = 0.4, **params) -> dict:
        from parc_torch.utils import terrain as terrain_lib
        hf = np.zeros((int(x_dim), int(y_dim)), np.float32)
        rng = self.rng
        if kind == "flat":
            pass
        elif kind == "boxes":
            hf = terrain_lib.add_boxes(
                rng, hf, num_boxes=int(params.get("num_boxes", 24)),
                box_min_height=float(params.get("min_height", 0.0)),
                box_max_height=float(params.get("max_height", 1.2)))
        elif kind == "stairs":
            hf = terrain_lib.add_stairs(
                rng, hf, min_start_height=0.0, max_start_height=0.5)
        elif kind == "paths":
            hf = terrain_lib.gen_curvy_paths(rng, hf)
        elif kind == "perlin":
            hf = terrain_lib.perlin(
                rng, hf.shape,
                amplitude=float(params.get("amplitude", 0.8)))
        elif kind == "parkour":
            hf = _host(terrain_lib.linear_parkour_course(
                rng, x_dim=int(x_dim), y_dim=int(y_dim),
                device=self.device).hf)
        elif kind == "cave":
            hf = _host(terrain_lib.generate_cave(
                rng, x_dim=int(x_dim), y_dim=int(y_dim),
                device=self.device).hf)
        else:
            raise StudioError(f"unknown procgen kind {kind!r}")
        hf = np.asarray(hf, np.float32)
        t = md.HostTerrain(
            hf=hf,
            min_point=np.asarray([-hf.shape[0] * dx / 2,
                                  -hf.shape[1] * dx / 2], np.float32),
            dxdy=np.asarray([dx, dx], np.float32))
        self._terrain()          # ensures a motion exists
        self.motion.terrain = t
        self.path_world = self.path_grid = None
        self.status = f"procgen {kind} {hf.shape[0]}x{hf.shape[1]}"
        return self.state()

    def edit_cells(self, cells, dh: Optional[float] = None,
                   set_h: Optional[float] = None) -> dict:
        """Raise/lower (dh) or set (set_h) a list of [i, j] cells."""
        t = self._terrain()
        hf = np.asarray(t.hf, np.float32).copy()
        for ij in cells:
            i, j = int(ij[0]), int(ij[1])
            if not (0 <= i < hf.shape[0] and 0 <= j < hf.shape[1]):
                continue
            if set_h is not None:
                hf[i, j] = float(set_h)
            else:
                hf[i, j] += float(dh if dh is not None else 0.2)
        t.hf = hf
        self.status = f"edited {len(cells)} cells"
        return self.state()

    def terrain_filter(self, kind: str = "remove_sharp_lines") -> dict:
        """Whole-terrain filters from the MOTION_FORGE terrain GUI:
        remove_sharp_lines (terrain_gui.py:308), flat_maxpool_3x3 (:319),
        flat_maxpool_2x2, downsample (:157)."""
        from parc_torch.utils import terrain as terrain_lib
        t = self._terrain()
        if kind == "remove_sharp_lines":
            t.hf = terrain_lib.remove_sharp_lines(np.asarray(t.hf))
        elif kind == "flat_maxpool_3x3":
            t.hf = _host(terrain_lib.flat_maxpool_3x3(
                t.to_device(self.device)).hf)
        elif kind == "flat_maxpool_2x2":
            t.hf = _host(terrain_lib.flat_maxpool_2x2(
                t.to_device(self.device)).hf)
        elif kind == "downsample":
            new = terrain_lib.downsample_terrain(t.to_device(self.device))
            t.hf = _host(new.hf)
            t.hf_mask = _host(new.hf_mask)
            t.hf_maxmin = _host(new.hf_maxmin)
            t.dxdy = _host(new.dxdy)
        else:
            raise StudioError(f"unknown terrain filter {kind!r}")
        self.status = f"applied terrain filter {kind}"
        return self.state()

    def snap_discrete(self, heights=(-2.0, -1.0, 0.0, 1.0, 2.0)) -> dict:
        """Snap motion-touched terrain cells to discrete height levels
        (MOTION_FORGE terrain GUI op, terrain_gui.py:182 ->
        terrain_util.hf_from_motion_discrete_heights)."""
        from parc_torch.utils import terrain as terrain_lib
        from parc_torch.viewer.render import _body_positions
        m = self._require_motion()
        t = self._terrain()
        bp = _body_positions(self.model, m.frames)
        dev = t.to_device(self.device)
        if t.hf_mask is None or not np.any(t.hf_mask):
            # no stored mask: mark the cells under the motion's bodies
            ij = _host(terrain_lib.get_grid_index(
                dev, self._on(bp[..., 0:2].reshape(-1, 2))))
            mask = np.zeros(dev.dims, bool)
            mask[ij[:, 0], ij[:, 1]] = True
            dev = dataclasses.replace(
                dev, hf_mask=torch.as_tensor(mask, device=self.device))
        snapped = terrain_lib.hf_from_motion_discrete_heights(
            dev, bp, heights)
        t.hf = _host(snapped.hf)
        t.hf_mask = _host(snapped.hf_mask)
        self.status = f"snapped terrain to {len(tuple(heights))} levels"
        return self.state()

    # -- planning -----------------------------------------------------------
    def astar(self, start, end, **settings) -> dict:
        from parc_torch.procgen import astar as astar_lib
        t = self._terrain()
        s = astar_lib.AStarSettings(**{
            k: v for k, v in settings.items()
            if k in {f.name for f in dataclasses.fields(
                astar_lib.AStarSettings)}})
        path = astar_lib.run_a_star(
            np.asarray(t.hf), np.asarray(t.dxdy)[:2],
            (int(start[0]), int(start[1])), (int(end[0]), int(end[1])),
            settings=s)
        if path is None or len(path) == 0:
            self.path_world = self.path_grid = None
            self.status = "A*: no path found"
            return self.state()
        self.path_grid = np.asarray(path, np.int32)
        self.path_world = astar_lib.path_to_world(
            self.path_grid, np.asarray(t.min_point)[:2],
            np.asarray(t.dxdy)[:2], np.asarray(t.hf))
        self.status = f"A*: {len(path)} nodes"
        return self.state()

    # -- diffusion generation -------------------------------------------------
    def mdm_gen(self, mdm_dir: Optional[str] = None,
                batch_size: int = 8, max_seconds: float = 6.0,
                seed: int = 0) -> dict:
        from parc_torch.anim import motion_lib as ml
        from parc_torch.diffusion.mdm import MDM, MDMConfig
        from parc_torch.procgen import mdm_path
        from parc_torch.utils import checkpoint as ckpt_lib

        mdm_dir = mdm_dir or self.mdm_dir
        if not mdm_dir:
            raise StudioError("no MDM checkpoint dir configured "
                              "(--mdm_dir or request field mdm_dir)")
        if self.path_world is None:
            raise StudioError("run A* first (mdm_gen follows the path)")
        t = self._terrain()
        dev = self.device

        mdm = MDM(self.model, dataclass_from_dict(MDMConfig, self.mdm_config),
                  device=dev)
        lib = ml.build_motion_lib(self.model, [self._require_motion()],
                                  device=dev)
        # the fresh state is a template: the restore overwrites its
        # weights and feature stats
        state = mdm.init(lib, torch.Generator(device=dev).manual_seed(0),
                         stats_samples=64)
        state = mdm.merge_persistent(state, ckpt_lib.restore(
            os.path.join(mdm_dir, "checkpoints"), map_location=dev))
        cfg = mdm_path.PathGenSettings(
            batch_size=int(batch_size), max_seconds=float(max_seconds))
        # cold start: mdm_path builds the anchor + unconditioned first window
        result = mdm_path.generate_frames_along_path(
            mdm, state, t.to_device(dev), np.asarray(self.path_world), None,
            None, torch.Generator(device=dev).manual_seed(int(seed)), cfg)
        best = int(np.argmin(result.total_loss))
        n = int(result.lengths[best])
        self.motion = md.MotionData(
            frames=np.asarray(result.frames34[best, :n], np.float32),
            contacts=np.asarray(result.contacts[best, :n], np.float32),
            fps=30.0, loop_mode=md.CLAMP, terrain=t)
        self.overlay = None
        self.status = (f"mdm_gen: kept best of {batch_size} rollouts "
                       f"(loss {float(result.total_loss[best]):.3f})")
        return self.state()

    # -- optimization -----------------------------------------------------
    def optimize(self, iters: int = 300) -> dict:
        from parc_torch.opt import motion_opt
        m = self._require_motion()
        if m.terrain is None:
            raise StudioError("motion has no terrain")
        contacts = (m.contacts if m.contacts is not None
                    else np.zeros((m.frames.shape[0],
                                   self.model.num_bodies), np.float32))
        cfg = motion_opt.MotionOptConfig(iters=int(iters))
        frames, losses = motion_opt.motion_contact_optimization(
            self.model, m.terrain.to_device(self.device), self._on(m.frames),
            self._on(contacts), cfg)
        self.overlay = dataclasses.replace(
            m, frames=_host(frames).astype(np.float32))
        self.overlay_label = "optimized"
        self.status = (f"optimized {iters} iters: "
                       f"pen={float(losses['penetration']):.4f} "
                       f"contact={float(losses['contact']):.4f}")
        return self.state()

    def accept_overlay(self) -> dict:
        """Promote the overlay (optimized/tracked result) to the motion."""
        if self.overlay is None:
            raise StudioError("no overlay to accept")
        self.motion = self.overlay
        self.overlay = None
        self.status = "overlay accepted"
        return self.state()

    # -- motion editing -----------------------------------------------------
    def flip(self) -> dict:
        from parc_torch.anim import motion_edit
        m = self._require_motion()
        frames, contacts = motion_edit.flip_motion_about_xz(
            self.model, self._on(m.frames),
            contacts=(self._on(m.contacts)
                      if m.contacts is not None else None))
        m.frames = _host(frames).astype(np.float32)
        if contacts is not None:
            m.contacts = _host(contacts).astype(np.float32)
        if m.terrain is not None:
            m.terrain = motion_edit.flip_terrain_about_xz(m.terrain)
        self.path_world = self.path_grid = None
        self.status = "mirrored about XZ"
        return self.state()

    def resample(self, fps: float) -> dict:
        from parc_torch.anim import motion_edit
        m = self._require_motion()
        frames = motion_edit.resample_fps(self.model, m.frames,
                                          float(m.fps), float(fps))
        m.frames = _host(frames).astype(np.float32)
        if m.contacts is not None:
            idx = np.clip(
                np.round(np.arange(m.frames.shape[0])
                         * m.fps / float(fps)).astype(int),
                0, m.contacts.shape[0] - 1)
            m.contacts = m.contacts[idx]
        m.fps = float(fps)
        self.status = f"resampled to {fps} fps ({m.frames.shape[0]} frames)"
        return self.state()

    def slice(self, start: int, end: int) -> dict:
        from parc_torch.anim import motion_edit
        m = self._require_motion()
        self.motion = motion_edit.slice_motion(m, int(start), int(end))
        self.status = f"sliced [{start}:{end}]"
        return self.state()

    def stitch(self, path: str, range_a=None, range_b=None) -> dict:
        """Motion-matching stitch: best transition from the current clip
        into the workspace clip at ``path``, rigidly aligned and
        concatenated (reference: MOTION_FORGE/polyscope_stitcher.py +
        motion_edit_lib.search_for_matching_motion_frames)."""
        from parc_torch.anim import motion_edit
        m = self._require_motion()
        other = md.load_motion_data(self._workspace_path(path))
        if float(other.fps) != float(m.fps):
            other.frames = _host(motion_edit.resample_fps(
                self.model, other.frames, float(other.fps),
                float(m.fps))).astype(np.float32)
            other.fps = float(m.fps)
        ia, ib, hd, dp, err = motion_edit.search_for_matching_motion_frames(
            self.model, m.frames, other.frames, float(m.fps),
            tuple(range_a) if range_a else None,
            tuple(range_b) if range_b else None)
        aligned = motion_edit.align_matched_motion(other.frames, hd, dp)
        m.frames = np.asarray(
            motion_edit.stitch_motions(m.frames[:ia + 1],
                                       aligned[ib + 1:]), np.float32)
        if m.contacts is not None and other.contacts is not None:
            m.contacts = np.concatenate([m.contacts[:ia + 1],
                                         other.contacts[ib + 1:]], 0)
        else:
            m.contacts = None
        self.overlay = None
        self.status = (f"stitched {os.path.basename(path)} at "
                       f"A[{ia}] -> B[{ib}] (match err {err:.3f})")
        return self.state()

    def recompute_contacts(self, threshold: float = 0.04) -> dict:
        from parc_torch.anim import motion_edit
        m = self._require_motion()
        if m.terrain is None:
            raise StudioError("motion has no terrain")
        contacts = motion_edit.compute_contacts(
            self.model, m.terrain.to_device(self.device), m.frames,
            eps=float(threshold))
        m.contacts = _host(contacts).astype(np.float32)
        self.status = "contacts recomputed from geometry"
        return self.state()

    def set_contact(self, frame: int, body: int, value: float) -> dict:
        """Manual per-frame contact flag editing (contact_editing_gui)."""
        m = self._require_motion()
        if m.contacts is None:
            m.contacts = np.zeros((m.frames.shape[0],
                                   self.model.num_bodies), np.float32)
        m.contacts = np.array(m.contacts, np.float32, copy=True)
        m.contacts[int(frame), int(body)] = float(value)
        self.status = f"contact[{frame},{body}] = {value}"
        return self.state()

    # -- physics tracking in the loop ---------------------------------------
    def _tracker(self, tracker_dir: Optional[str]):
        """The tracker on the current clip at one env: (motion library,
        agent, agent state), restored from ``tracker_dir`` when given."""
        from parc_torch.anim import motion_lib as ml
        from parc_torch.envs.base import EnvConfig
        from parc_torch.envs.deepmimic import DeepMimicEnv
        from parc_torch.learning.ppo import PPOAgent, PPOConfig
        from parc_torch.physics import engine
        dev = self.device
        lib = ml.build_motion_lib(self.model, [self._require_motion()],
                                  device=dev)
        env = DeepMimicEnv(self.model, engine.SimParams(),
                           EnvConfig(num_envs=1, rand_reset=False),
                           device=dev)
        if tracker_dir:
            from parc_torch.pipeline import cli
            # restored as record and eval restore it, keeping the first of
            # the checkpoint's per-motion fail rates for the studio's one
            # clip. (The JAX studio restores through orbax's
            # StandardRestore against its 1-motion state, which refuses a
            # checkpoint of more than one motion: the shapes differ.)
            agent, state = cli._restored_agent(
                {**self.tracker_config, "tracker_dir": tracker_dir}, lib,
                env, seed=0)
            return lib, agent, state
        agent = PPOAgent(env, dataclass_from_dict(PPOConfig,
                                                  self.tracker_config),
                         device=dev)
        return lib, agent, agent.init(
            lib, torch.Generator(device=dev).manual_seed(0))

    def track(self, tracker_dir: Optional[str] = None,
              num_steps: Optional[int] = None) -> dict:
        """Roll the physics tracker on the current clip and overlay the
        simulated motion (reference: IsaacGymManager.start_isaac_gym/step
        runs the tracker agent inside the GUI). One env; each control step
        is one launch of the control-step kernel on the card."""
        from parc_torch.pipeline import record
        m = self._require_motion()
        tracker_dir = tracker_dir or self.tracker_dir
        lib, agent, state = self._tracker(tracker_dir)
        steps = int(num_steps
                    or min(np.ceil(m.frames.shape[0] / m.fps * 30) + 2, 600))
        rcfg = record.RecordConfig(start_fractions=(0.0,), max_steps=steps)
        r = record.record_motions(agent, lib, state, rcfg)[0]
        if r is None:
            self.status = ("tracking failed (policy fell before the clip "
                           "ended) — train a tracker or pass tracker_dir")
            return self.state()
        self.overlay = dataclasses.replace(r, terrain=m.terrain)
        self.overlay_label = "tracked"
        self.status = (f"tracked {self.overlay.frames.shape[0]} frames "
                       f"({'trained policy' if tracker_dir else 'untrained'})")
        return self.state()

    # -- live sim stepping -------------------------------------------------
    # MOTION_FORGE runs Isaac Gym *inside* the GUI and steps it live
    # (reference: MOTION_FORGE/global_header.py:464-657
    # start_isaac_gym/step with live visuals).  Here a persistent sim
    # session lives server-side; each sim_step advances a few control
    # steps and grows the overlay, so the browser shows physics running
    # live instead of waiting for a full track() rollout.
    def sim_start(self, tracker_dir: Optional[str] = None) -> dict:
        self._require_motion()
        tracker_dir = tracker_dir or self.tracker_dir
        lib, agent, state = self._tracker(tracker_dir)
        generator = torch.Generator(device=self.device).manual_seed(0)
        es = agent.env.reset(lib, generator, num_envs=1)
        self._sim = dict(lib=lib, agent=agent, state=state, es=es,
                         generator=generator, frames=[], contacts=[],
                         fps=1.0 / agent.env.cfg.control_dt)
        self.status = ("live sim started "
                       f"({'trained policy' if tracker_dir else 'untrained'})")
        return self.state()

    @torch.no_grad()
    def _sim_chunk(self, sim: dict) -> None:
        """SIM_CHUNK control steps with the actor mean; each step's
        pre-step frame and contact flags are gathered on the device and
        copied to the host once for the chunk."""
        from parc_torch.pipeline import record
        agent, es = sim["agent"], sim["es"]
        rows = []
        for _ in range(SIM_CHUNK):
            rows.append(torch.cat(record.sim_frame(agent.env.model, es.sim),
                                  dim=-1)[0])
            es = agent.env.step(sim["lib"], es, agent.act(sim["state"],
                                                          es.obs),
                                generator=sim["generator"])
        sim["es"] = es
        host = _host(torch.stack(rows))
        sim["frames"].append(host[:, :34])
        sim["contacts"].append(host[:, 34:])

    def sim_step(self, steps: int = 8) -> dict:
        """Advance the live sim by ~``steps`` control steps (rounded up to
        whole SIM_CHUNK-step chunks, as the JAX studio's compiled chunk
        advances)."""
        sim = self._sim
        if sim is None:
            raise StudioError("no live sim session — call sim_start first")
        for _ in range(max(1, -(-int(steps) // SIM_CHUNK))):
            self._sim_chunk(sim)
        frames = np.concatenate(sim["frames"], axis=0)
        contacts = np.concatenate(sim["contacts"], axis=0)
        m = self._require_motion()
        self.overlay = md.MotionData(
            frames=frames.astype(np.float32), fps=float(sim["fps"]),
            contacts=contacts.astype(np.float32), terrain=m.terrain)
        self.overlay_label = "live sim"
        self.status = f"live sim: {frames.shape[0]} frames"
        return self.state()

    def sim_stop(self) -> dict:
        if self._sim is None:
            raise StudioError("no live sim session")
        self._sim = None
        self.status = "live sim stopped (overlay kept)"
        return self.state()

    # -- dispatch -----------------------------------------------------------
    OPS = ("state", "load", "save", "procgen", "edit_cells", "terrain_filter",
           "snap_discrete",
           "astar", "mdm_gen", "optimize", "accept_overlay", "flip",
           "resample", "slice", "stitch", "recompute_contacts", "set_contact",
           "track", "sim_start", "sim_step", "sim_stop")

    def handle(self, op: str, payload: dict) -> dict:
        if op not in self.OPS:
            raise StudioError(f"unknown op {op!r}")
        try:
            return getattr(self, op)(**payload)
        except StudioError:
            raise
        except TypeError as e:
            raise StudioError(f"bad arguments for {op}: {e}")


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------

def make_server(studio: Studio, port: int = 8000, host: str = "127.0.0.1",
                allow_remote: bool = False):
    """ThreadingHTTPServer serving the studio page + JSON API."""
    import http.server

    from parc_torch.viewer.studio_page import PAGE

    lock = threading.Lock()

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, PAGE.encode(), "text/html; charset=utf-8")
            elif self.path == "/api/state":
                with lock:
                    out = studio.state()
                self._send(200, json.dumps(out).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if not self.path.startswith("/api/"):
                self._send(404, b"not found", "text/plain")
                return
            op = self.path[len("/api/"):]
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
                with lock:
                    out = studio.handle(op, payload)
                self._send(200, json.dumps(out).encode(),
                           "application/json")
            except StudioError as e:
                self._send(400, json.dumps({"error": str(e)}).encode(),
                           "application/json")
            except Exception as e:  # surfaced in the UI, not a crash
                # log the detail server-side; only the exception class
                # crosses the wire (no raw message/path disclosure)
                import traceback
                traceback.print_exc()
                self._send(500, json.dumps(
                    {"error": f"internal error ({type(e).__name__}); "
                              "see server log"}).encode(),
                    "application/json")

    _check_bind(host, allow_remote)
    return http.server.ThreadingHTTPServer((host, port), Handler)


def _check_bind(host: str, allow_remote: bool = False) -> None:
    if host not in ("127.0.0.1", "localhost", "::1") and not allow_remote:
        raise ValueError(
            f"refusing non-local bind {host!r}: the studio API is "
            "unauthenticated. Pass allow_remote=True (CLI: "
            "--allow_remote) only on a trusted network.")


def run_studio(studio: Studio, port: int = 8000,
               host: str = "127.0.0.1", allow_remote: bool = False) -> None:
    server = make_server(studio, port=port, host=host,
                         allow_remote=allow_remote)
    print(f"parc_torch studio at http://{host}:{server.server_address[1]}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
