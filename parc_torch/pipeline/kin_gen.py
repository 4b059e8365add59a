"""Kinematic generation stage (parc_2).

Per generated motion: procgen a terrain (boxes / paths / stairs or a slice
of a file terrain) -> simplify -> A* plan -> batched autoregressive MDM
rollouts along the path -> filter by contact/penetration losses -> contact
optimization of the top-k -> save (plus mirrored copies) with terrain masks.

The host draws (terrain, endpoints, the planner's seed) come from numpy
generators seeded as the JAX package seeds them, so a seed gives the same
terrains and paths in both packages; the rollouts' draws come from torch
generators seeded the same way, or explicitly (``path_draws``).

Reference parity: parc_2_kin_gen.py:90-523.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_data as md
from parc_torch.anim import motion_edit
from parc_torch.diffusion.mdm import MDM, MDMState
from parc_torch.opt import motion_opt
from parc_torch.procgen import astar, mdm_path
from parc_torch.utils import rotation as rot
from parc_torch.utils import terrain as terrain_lib

# (stream seed, call index, root-draw shape, window-noise shape) -> the
# explicit draws of that generation call
DrawsFn = Callable[[int, int, tuple, tuple], mdm_path.PathDraws]


@dataclasses.dataclass
class KinGenConfig:
    terrain_style: str = "boxes"        # boxes | paths | stairs | file
    # FILE mode: terrain .pkl/.npz paths (standalone SubTerrain pkls or
    # motion files carrying terrains); each generated motion slices a
    # random window out of one of them (reference:
    # parc_2_kin_gen.py:236-287 ProcGenMode.FILE): how real-world
    # terrain variety enters the loop
    terrain_files: tuple = ()
    terrain_dim: int = 16
    terrain_dx: float = 0.4
    num_rollouts: int = 32
    # generate this many terrains' rollouts in ONE batch
    # (procgen/mdm_path.generate_frames_multi): R terrains x num_rollouts
    # rows share every denoise step. 1 = the sequential per-terrain chain
    # (reference semantics either way).
    terrains_per_batch: int = 1
    top_k: int = 2
    max_contact_loss: float = 3.0
    max_pen_loss: float = 8.0
    max_total_loss: float = 30.0
    max_retries: int = 3
    optimize: bool = True
    mirror: bool = True
    opt_cfg: motion_opt.MotionOptConfig = dataclasses.field(
        default_factory=lambda: motion_opt.MotionOptConfig(iters=500))
    path_cfg: mdm_path.PathGenSettings = dataclasses.field(
        default_factory=mdm_path.PathGenSettings)


def _file_hfs(cfg: KinGenConfig):
    """Load (and cache on the config object) the FILE-mode heightfields."""
    hfs = getattr(cfg, "_file_hfs_cache", None)
    if hfs is None:
        if not cfg.terrain_files:
            raise ValueError("terrain_style=file needs terrain_files")
        hfs = [np.asarray(md.load_reference_terrain_pkl(p).hf, np.float32)
               for p in cfg.terrain_files]
        object.__setattr__(cfg, "_file_hfs_cache", hfs)
    return hfs


def gen_terrain(cfg: KinGenConfig, rng: np.random.Generator) -> np.ndarray:
    dim = cfg.terrain_dim * 2
    hf = np.zeros((dim, dim), np.float32)
    if cfg.terrain_style == "boxes":
        hf = terrain_lib.add_boxes(rng, hf, num_boxes=16,
                                   box_min_height=-1.0, box_max_height=1.5,
                                   box_min_len=2, box_max_len=8)
    elif cfg.terrain_style == "stairs":
        hf = terrain_lib.add_stairs(rng, hf)
    elif cfg.terrain_style == "paths":
        hf = terrain_lib.gen_curvy_paths(rng, hf)
    elif cfg.terrain_style == "file":
        # random dim x dim window of a stored terrain (reference slices
        # its input terrains the same way; smaller inputs are edge-padded)
        hfs = _file_hfs(cfg)
        src = hfs[int(rng.integers(len(hfs)))]
        pad = [max(0, dim - s) for s in src.shape]
        if any(pad):
            src = np.pad(src, [(0, pad[0]), (0, pad[1])], mode="edge")
        i = int(rng.integers(0, src.shape[0] - dim + 1))
        j = int(rng.integers(0, src.shape[1] - dim + 1))
        hf = src[i:i + dim, j:j + dim].copy()
        hf -= hf.min()  # slice heights are relative to the window floor
    else:
        raise ValueError(cfg.terrain_style)
    return hf


def _draw_terrain_and_path(cfg: KinGenConfig, rng_np: np.random.Generator,
                           device):
    """One terrain + A* path attempt -> (terrain, hf, nodes) or None."""
    hf = gen_terrain(cfg, rng_np)
    dxdy = np.asarray([cfg.terrain_dx, cfg.terrain_dx], np.float32)
    terrain = md.HostTerrain(hf=hf, min_point=np.zeros(2, np.float32),
                             dxdy=dxdy).to_device(device)
    # simplify for planning
    plan_hf = terrain_lib.flat_maxpool_2x2(terrain).hf.cpu().numpy()

    start, goal = astar.pick_start_end_on_edges(plan_hf, rng_np)
    # stable footing around the endpoints (reference:
    # parc_2_kin_gen.py:304-310)
    plan_hf = terrain_lib.flatten_4x4_near_edge(
        plan_hf, start, float(plan_hf[start[0], start[1]]))
    plan_hf = terrain_lib.flatten_4x4_near_edge(
        plan_hf, goal, float(plan_hf[goal[0], goal[1]]))
    path = astar.run_a_star(plan_hf, dxdy, start, goal, rng=rng_np)
    if path is None:
        return None
    nodes = astar.path_to_world(path, np.zeros(2), dxdy, hf)
    return terrain, hf, nodes


def _motion_body_points(model: cm.CharModel,
                        frames34: torch.Tensor) -> torch.Tensor:
    root_rot = rot.exp_map_to_quat(frames34[..., 3:6])
    joint_rot = cm.dof_to_rot(model, frames34[..., 6:])
    body_pos, _ = cm.forward_kinematics(model, frames34[..., 0:3], root_rot,
                                        joint_rot)
    return body_pos


def _select_keepers(cfg: KinGenConfig, result) -> List[int]:
    """Rollout indices passing the loss thresholds, best-first, top_k."""
    ok = ((result.contact_loss < cfg.max_contact_loss)
          & (result.pen_loss < cfg.max_pen_loss)
          & (result.total_loss < cfg.max_total_loss))
    order = np.argsort(result.total_loss)
    return [i for i in order if ok[i]][:cfg.top_k]


def _clips_from_result(mdm: MDM, cfg: KinGenConfig, hf: np.ndarray,
                       terrain: terrain_lib.Terrain, result,
                       opt_frames: Optional[dict] = None
                       ) -> List[md.MotionData]:
    """Threshold/rank rollouts, contact-optimize and mirror the keepers.

    ``opt_frames`` maps rollout index -> pre-optimized frames (the batched
    cross-terrain optimizer, motion_contact_optimization_batched); when
    given, the per-clip optimization is skipped."""
    model, dev = mdm.model, mdm.device
    dxdy = np.asarray([cfg.terrain_dx, cfg.terrain_dx], np.float32)
    keep = _select_keepers(cfg, result)
    if not keep:
        return []

    host_terrain = md.HostTerrain(hf=hf, min_point=np.zeros(2, np.float32),
                                  dxdy=dxdy)
    dev_t = host_terrain.to_device(dev)
    clips = []
    for i in keep:
        t = int(result.lengths[i])
        contacts = result.contacts[i, :t]
        if opt_frames is not None and i in opt_frames:
            frames = opt_frames[i]
        else:
            frames = result.frames34[i, :t]
            if cfg.optimize:
                frames, _ = motion_opt.motion_contact_optimization(
                    model, terrain, frames, contacts, cfg.opt_cfg)
                frames = frames.cpu().numpy()
        f_np, c_np = motion_edit.remove_hesitation_frames(
            np.asarray(frames), contacts)
        # terrain masks for future augmentation
        body_pts = _motion_body_points(model, torch.as_tensor(f_np,
                                                              device=dev))
        aug = terrain_lib.compute_hf_maxmin(dev_t, body_pts)
        clip_terrain = md.HostTerrain(
            hf=hf, min_point=np.zeros(2, np.float32), dxdy=dxdy,
            hf_mask=aug.hf_mask.cpu().numpy(),
            hf_maxmin=aug.hf_maxmin.cpu().numpy())
        clip_losses = {"contact": float(result.contact_loss[i]),
                       "pen": float(result.pen_loss[i]),
                       "total": float(result.total_loss[i])}
        clips.append(md.MotionData(
            frames=f_np.astype(np.float32), fps=cfg.path_cfg.fps,
            contacts=c_np.astype(np.float32), terrain=clip_terrain,
            losses=clip_losses))
        if cfg.mirror:
            fm, cm_ = motion_edit.flip_motion_about_xz(
                model, torch.as_tensor(f_np, device=dev),
                torch.as_tensor(c_np))
            clips.append(md.MotionData(
                frames=fm.cpu().numpy().astype(np.float32),
                fps=cfg.path_cfg.fps,
                contacts=cm_.numpy().astype(np.float32),
                terrain=motion_edit.flip_terrain_about_xz(clip_terrain),
                losses=clip_losses))
    return clips


def _noise_shape(mdm: MDM, rows: int) -> tuple:
    return (rows, mdm.scfg.seq_len, mdm.frame_dim)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def gen_motion_and_terrain(mdm: MDM, state: MDMState, cfg: KinGenConfig,
                           seed: int,
                           path_draws: Optional[DrawsFn] = None
                           ) -> List[md.MotionData]:
    """Generate one terrain and up to top_k motions crossing it (the
    rollouts' stream is seeded ``seed``; the k-th attempt whose path
    connects is its call k)."""
    rng_np = np.random.default_rng(seed)
    gen = _generator(mdm.device, seed)
    path_cfg = dataclasses.replace(cfg.path_cfg, batch_size=cfg.num_rollouts)
    calls = 0
    for _ in range(cfg.max_retries):
        drawn = _draw_terrain_and_path(cfg, rng_np, mdm.device)
        if drawn is None:
            continue
        terrain, hf, nodes = drawn
        # cold start: mdm_path builds the standing anchor itself and
        # generates the first window with the prev-state condition dropped
        # (reference gen_mdm_motion_at_path_start)
        draws = None if path_draws is None else path_draws(
            seed, calls, (), _noise_shape(mdm, cfg.num_rollouts))
        calls += 1
        result = mdm_path.generate_frames_along_path(
            mdm, state, terrain, nodes, None, None, gen, path_cfg,
            draws=draws)
        clips = _clips_from_result(mdm, cfg, hf, terrain, result)
        if clips:
            return clips
    return []


def run_kin_gen(mdm: MDM, state: MDMState, num_motions: int, out_dir: str,
                cfg: KinGenConfig = KinGenConfig(), seed: int = 0,
                name_prefix: str = "",
                path_draws: Optional[DrawsFn] = None) -> List[str]:
    """Generate a batch of motions into out_dir (class = terrain style).

    ``name_prefix`` namespaces output files so several independent jobs
    (the reference shards kin-gen into num_batches_of_motions machine-level
    jobs, parc_0_setup_iter.py:21-24) can write into one directory.

    With ``cfg.terrains_per_batch > 1`` the generation chains of several
    motions share one batch (generate_frames_multi); per-motion
    thresholds/ranking/opt are unchanged.

    Random streams: motion slot i draws its terrains and paths from
    ``np.random.default_rng(seed + i)`` in both modes. The rollouts draw
    from a torch generator: in the sequential mode one per slot, seeded
    ``seed + i`` (call k = its k-th rollout); in the batched mode one for
    the run, seeded ``seed`` (call k = round k). ``path_draws(stream seed,
    call, root-draw shape, window-noise shape)`` gives a call's draws
    explicitly instead."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    idx = 0

    def save(clips):
        nonlocal idx
        for clip in clips:
            path = os.path.join(
                out_dir, f"{name_prefix}{cfg.terrain_style}_{idx:05d}.npz")
            md.save_motion_data(path, clip)
            paths.append(path)
            idx += 1

    def report(n_attempts=None):
        # keep-rate evidence line (per style): clips kept / slots asked
        extra = (f", {n_attempts} terrain draws"
                 if n_attempts is not None else "")
        print(f"kin_gen[{cfg.terrain_style}]: kept {len(paths)} clips "
              f"(incl. mirrors) from {num_motions} slots{extra}")

    if cfg.terrains_per_batch <= 1:
        for i in range(num_motions):
            save(gen_motion_and_terrain(mdm, state, cfg, seed + i,
                                        path_draws=path_draws))
        report()
        return paths

    # batched mode: each pending motion slot keeps its own host rng stream
    # and retry budget; every round draws terrains+paths for the pending
    # slots and runs ONE generate_frames_multi over all of them
    path_cfg = dataclasses.replace(cfg.path_cfg, batch_size=cfg.num_rollouts)
    slot_rng = {i: np.random.default_rng(seed + i)
                for i in range(num_motions)}
    attempts = {i: 0 for i in range(num_motions)}
    pending = list(range(num_motions))
    gen = _generator(mdm.device, seed)
    rounds = 0
    while pending:
        batch, terrains, nodes_l, hfs = [], [], [], []
        for i in list(pending):
            drawn = None
            while drawn is None and attempts[i] < cfg.max_retries:
                attempts[i] += 1
                drawn = _draw_terrain_and_path(cfg, slot_rng[i], mdm.device)
            if drawn is None:           # A* never connected: give up
                pending.remove(i)
                continue
            terrain, hf, nodes = drawn
            batch.append(i)
            terrains.append(terrain)
            nodes_l.append(nodes)
            hfs.append(hf)
            if len(batch) >= cfg.terrains_per_batch:
                break
        if not batch:
            break
        draws = None if path_draws is None else path_draws(
            seed, rounds, (len(batch),),
            _noise_shape(mdm, len(batch) * cfg.num_rollouts))
        results = mdm_path.generate_frames_multi(
            mdm, state, terrains, nodes_l, gen, path_cfg, draws=draws)
        rounds += 1
        # contact-optimize EVERY keeper of the round in one Adam loop,
        # padded to the generation-length ceiling
        opt_by_slot = {}
        if cfg.optimize:
            ts, fs, cs, who = [], [], [], []
            for slot, terrain, result in zip(batch, terrains, results):
                for j in _select_keepers(cfg, result):
                    t = int(result.lengths[j])
                    ts.append(terrain)
                    fs.append(result.frames34[j, :t])
                    cs.append(result.contacts[j, :t])
                    who.append((slot, j))
            if who:
                pad_to = int(path_cfg.max_seconds * path_cfg.fps)
                pad_to = max(pad_to, max(f.shape[0] for f in fs))
                opted = motion_opt.motion_contact_optimization_batched(
                    mdm.model, ts, fs, cs, cfg.opt_cfg, pad_to=pad_to)
                for (slot, j), (f_opt, _) in zip(who, opted):
                    opt_by_slot.setdefault(slot, {})[j] = \
                        f_opt.cpu().numpy()
        for i, terrain, hf, result in zip(batch, terrains, hfs, results):
            clips = _clips_from_result(mdm, cfg, hf, terrain, result,
                                       opt_frames=opt_by_slot.get(i))
            if clips:
                save(clips)
                pending.remove(i)
            elif attempts[i] >= cfg.max_retries:
                pending.remove(i)
    report(sum(attempts.values()))
    return paths
