"""Autoregressive MDM rollouts along an A* path.

Generates long parkour motions by chaining 15-frame MDM windows: each
iteration rewinds a few frames, conditions on the last two, targets a path
node ahead of the rollout's progress, and appends the newly generated
window. A batch of B rollouts shares every denoise step; only the
done-check and node bookkeeping touch the host, with one read of the feet
per window.

Random draws: the cold-start root heights and one initial DDIM noise x_T
per window (DDIM takes no other noise). They come from the caller's
``torch.Generator``, or explicitly as a :class:`PathDraws`.

Reference parity: tools/procgen/mdm_path.py:19-376 (generation loop
:226-321, scoring :322-376).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from parc_torch.anim import char_model as cm
from parc_torch.diffusion import gen as gen_lib
from parc_torch.diffusion.mdm import MDM, MDMState
from parc_torch.utils import rotation as rot
from parc_torch.utils import terrain as terrain_lib


@dataclasses.dataclass
class PathGenSettings:
    batch_size: int = 32
    rewind_frames: int = 5
    lookahead_nodes: int = 7
    done_dist: float = 0.5
    max_seconds: float = 10.0
    fps: float = 30.0
    settings: gen_lib.GenSettings = dataclasses.field(
        default_factory=gen_lib.GenSettings)


@dataclasses.dataclass
class PathDraws:
    """Explicit draws of one rollout chain.

    root_u: the cold start's uniform draw(s) in [0, 1): () for one path,
      (R,) for R paths; the anchor's root sits 0.7 + 0.2 u above the first
      node. Unused on a warm start.
    noise: the initial x_T (B, 15, frame_dim) of each window, first window
      first; it may hold more windows than the chain runs.
    """

    root_u: Optional[torch.Tensor]
    noise: Sequence[torch.Tensor]


@dataclasses.dataclass
class PathGenResult:
    frames34: np.ndarray      # (B, T, 34)
    contacts: np.ndarray      # (B, T, num_bodies)
    lengths: np.ndarray       # (B,) valid frame counts
    contact_loss: np.ndarray  # (B,)
    pen_loss: np.ndarray      # (B,)
    total_loss: np.ndarray    # (B,)


def _feet_xy(model: cm.CharModel, frames34: torch.Tensor,
             foot_ids: torch.Tensor) -> torch.Tensor:
    root_rot = rot.exp_map_to_quat(frames34[..., 3:6])
    joint_rot = cm.dof_to_rot(model, frames34[..., 6:])
    body_pos, _ = cm.forward_kinematics(model, frames34[..., 0:3], root_rot,
                                        joint_rot)
    return torch.mean(body_pos[..., foot_ids, :], dim=-2)


def _foot_ids(model: cm.CharModel) -> torch.Tensor:
    names = list(model.body_names)
    return torch.tensor([names.index("right_foot"),
                         names.index("left_foot")], device=model.device)


def max_windows(mdm: MDM, cfg: PathGenSettings) -> int:
    """The most windows a chain can run: the first window leaves seq - 1
    frames, each later one rewinds ``rewind_frames`` and appends seq."""
    seq, np_prev = mdm.scfg.seq_len, mdm.scfg.num_prev_states
    frames, n = seq - 1, 1
    while frames < int(cfg.max_seconds * cfg.fps):
        if frames > np_prev + cfg.rewind_frames:
            frames -= cfg.rewind_frames
        frames += seq
        n += 1
    return n


def _anchor(path: np.ndarray, num_prev: int, root_z: float) -> np.ndarray:
    """A synthetic standing anchor at the path start, heading at the next
    node, root ``root_z`` above the node (reference
    gen_mdm_motion_at_path_start, mdm_path.py:136-159)."""
    nxt = path[min(1, len(path) - 1)]
    d0 = nxt[0:2] - path[0, 0:2]
    heading = (float(np.arctan2(d0[1], d0[0]))
               if np.linalg.norm(d0) > 1e-6 else 0.0)
    start = np.zeros((num_prev, 34), np.float32)
    start[:, 0:2] = path[0, 0:2]
    start[:, 2] = path[0, 2] + root_z
    start[:, 5] = heading
    return start


class _Chain:
    """The per-window noise of a chain: explicit or from the generator."""

    def __init__(self, generator, draws: Optional[PathDraws]):
        self.generator, self.draws, self.n = generator, draws, 0

    def root_u(self, shape, device) -> np.ndarray:
        if self.draws is not None:
            return self.draws.root_u.cpu().numpy().reshape(shape)
        return torch.rand(shape, generator=self.generator,
                          device=device).cpu().numpy()

    def noise(self) -> Optional[torch.Tensor]:
        self.n += 1
        return None if self.draws is None else self.draws.noise[self.n - 1]


class _Progress:
    """Host bookkeeping of B rollouts along per-row node tables."""

    def __init__(self, row_nodes: np.ndarray, n_valid: np.ndarray,
                 done_dist: float):
        b = row_nodes.shape[0]
        self.row_nodes, self.n_valid = row_nodes, n_valid
        self.done_dist = done_dist
        self.closest = np.zeros((b,), np.int64)
        self.done = np.zeros((b,), bool)
        self.done_len = np.full((b,), -1, np.int64)

    def update(self, feet: np.ndarray, num_frames: int) -> None:
        """Advance each row's closest node from its feet (B, 3) after
        ``num_frames`` frames; rows within done_dist of their final node
        finish there."""
        d_nodes = np.linalg.norm(
            self.row_nodes[:, :, 0:2] - feet[:, None, 0:2], axis=-1)
        # never advance onto the padding tail
        n_max = self.row_nodes.shape[1]
        d_nodes[np.arange(n_max)[None] >= self.n_valid[:, None]] = np.inf
        self.closest = np.maximum(self.closest, d_nodes.argmin(axis=1))
        rows = np.arange(len(feet))
        end_d = np.linalg.norm(
            self.row_nodes[rows, self.n_valid - 1, 0:2] - feet[:, 0:2],
            axis=-1)
        newly_done = (~self.done) & (end_d < self.done_dist)
        self.done_len[newly_done] = num_frames
        self.done |= newly_done

    def targets(self, lookahead: int) -> np.ndarray:
        idx = np.minimum(self.closest + lookahead, self.n_valid - 1)
        return self.row_nodes[np.arange(len(idx)), idx, 0:2]


def _rollout(mdm: MDM, state: MDMState, terrain: terrain_lib.Terrain,
             terrain_idx: Optional[torch.Tensor], row_nodes: np.ndarray,
             n_valid: np.ndarray, frames: torch.Tensor,
             contacts: torch.Tensor, cold_start: bool, chain: _Chain,
             cfg: PathGenSettings):
    """The autoregressive chain shared by the single- and multi-terrain
    entry points: returns (frames, contacts, lengths) of B rollouts."""
    model, dev = mdm.model, mdm.device
    np_prev, seq = mdm.scfg.num_prev_states, mdm.scfg.seq_len
    max_frames = int(cfg.max_seconds * cfg.fps)
    foot_ids = _foot_ids(model)
    prog = _Progress(row_nodes, n_valid, cfg.done_dist)
    b = frames.shape[0]

    def gen(settings, prev_f, prev_c, target_xy):
        return gen_lib.gen_mdm_motion(
            mdm, state, chain.generator, prev_f, prev_c, terrain,
            torch.as_tensor(target_xy, dtype=torch.float32, device=dev),
            settings=settings, terrain_idx=terrain_idx, noise=chain.noise())

    def update_progress(frames):
        # one host read per window: the feet of the last frame
        feet = _feet_xy(model, frames[:, -1], foot_ids).cpu().numpy()
        prog.update(feet, frames.shape[1])

    # Cold start: the first window drops the prev-state condition and CFG
    # (reference gen_mdm_motion_at_path_start, mdm_path.py:149-161) and the
    # synthetic standing anchor is dropped from the output (the reference
    # keeps slice(0, seq-1-rewind) of the generated window only). Warm
    # start: the real prev frames condition as usual and stay at the head
    # of the clip, so replanning continues the character's actual pose.
    start_settings = (dataclasses.replace(cfg.settings, use_prev_state=False,
                                          guidance_scale=1.0)
                      if cold_start else cfg.settings)
    tgt0 = row_nodes[np.arange(b), np.minimum(1, n_valid - 1), 0:2]
    first_f, first_c = gen(start_settings, frames[:, -np_prev:],
                           contacts[:, -np_prev:], tgt0)
    if cold_start:
        frames, contacts = first_f[:, :seq - 1], first_c[:, :seq - 1]
    else:
        frames = torch.cat([frames, first_f[:, :seq - 1]], dim=1)
        contacts = torch.cat([contacts, first_c[:, :seq - 1]], dim=1)
    update_progress(frames)

    while frames.shape[1] < max_frames and not prog.done.all():
        # rewind (drop the last few frames: they tend to degrade)
        if frames.shape[1] > np_prev + cfg.rewind_frames:
            frames = frames[:, :-cfg.rewind_frames]
            contacts = contacts[:, :-cfg.rewind_frames]
        new_f, new_c = gen(cfg.settings, frames[:, -np_prev:],
                           contacts[:, -np_prev:],
                           prog.targets(cfg.lookahead_nodes))
        frames = torch.cat([frames, new_f], dim=1)
        contacts = torch.cat([contacts, new_c], dim=1)
        update_progress(frames)

    prog.done_len[prog.done_len < 0] = frames.shape[1]
    return frames, contacts, prog.done_len


def _result(mdm: MDM, terrain: terrain_lib.Terrain, frames: torch.Tensor,
            contacts: torch.Tensor, lengths: np.ndarray) -> PathGenResult:
    c_loss, p_loss = score_rollouts(mdm, terrain, frames, contacts)
    c_loss, p_loss = c_loss.cpu().numpy(), p_loss.cpu().numpy()
    return PathGenResult(
        frames34=frames.cpu().numpy(), contacts=contacts.cpu().numpy(),
        lengths=lengths, contact_loss=c_loss, pen_loss=p_loss,
        total_loss=c_loss + p_loss)


def generate_frames_along_path(mdm: MDM, state: MDMState,
                               terrain: terrain_lib.Terrain,
                               path_nodes: np.ndarray,
                               start_frames34: Optional[np.ndarray],
                               start_contacts: Optional[np.ndarray],
                               generator: Optional[torch.Generator],
                               cfg: PathGenSettings = PathGenSettings(),
                               draws: Optional[PathDraws] = None
                               ) -> PathGenResult:
    """Roll B parallel motions from the path start to its final node.

    Args:
      path_nodes: (N, 3) world xyz nodes from A*.
      start_frames34: (num_prev, 34) REAL recent character frames to
        condition the chain on (online replanning), or None to start cold
        at the path's first node: the reference's two regimes
        (mdm_path.py:149-163). From a cold start a synthetic standing
        anchor is built at nodes[0] and the first window is generated with
        the prev-state condition DROPPED (use_prev_state False, CFG off),
        because a synthetic standing pose that conditions a well-fit model
        pins the whole chain to a standing attractor.
      start_contacts: (num_prev, num_bodies) or None.
      generator: draws the root height and the windows' noise (on the
        MDM's device) unless ``draws`` gives them.
    """
    model, dev = mdm.model, mdm.device
    b = cfg.batch_size
    np_prev = mdm.scfg.num_prev_states
    path_nodes = np.asarray(path_nodes, np.float32)
    chain = _Chain(generator, draws)
    cold_start = start_frames34 is None
    if cold_start:
        root_z = 0.7 + 0.2 * float(chain.root_u((), dev))
        start_frames34 = _anchor(path_nodes, np_prev, root_z)
        start_contacts = np.zeros((np_prev, model.num_bodies), np.float32)
    frames = torch.as_tensor(np.asarray(start_frames34, np.float32),
                             device=dev)[None].repeat(b, 1, 1)
    contacts = torch.as_tensor(np.asarray(start_contacts, np.float32),
                               device=dev)[None].repeat(b, 1, 1)
    row_nodes = np.broadcast_to(path_nodes[None], (b,) + path_nodes.shape)
    frames, contacts, lengths = _rollout(
        mdm, state, terrain, None, row_nodes,
        np.full((b,), len(path_nodes)), frames, contacts, cold_start, chain,
        cfg)
    return _result(mdm, terrain, frames, contacts, lengths)


def generate_frames_multi(mdm: MDM, state: MDMState,
                          terrains: List[terrain_lib.Terrain],
                          paths: List[np.ndarray],
                          generator: Optional[torch.Generator],
                          cfg: PathGenSettings = PathGenSettings(),
                          draws: Optional[PathDraws] = None
                          ) -> List[PathGenResult]:
    """Cold-start rollouts along R paths over R terrains in one batch of
    R * cfg.batch_size rows: row i conditions on terrain
    ``i // cfg.batch_size`` (gen.sample_local_hf on the stacked terrain)
    and targets that terrain's path nodes; every denoise step serves all R
    terrains. Returns one PathGenResult per terrain, each shaped like
    :func:`generate_frames_along_path`'s."""
    if not (len(terrains) == len(paths) and terrains):
        raise ValueError("one path per terrain, at least one terrain")
    model, dev = mdm.model, mdm.device
    r, b = len(terrains), cfg.batch_size
    np_prev = mdm.scfg.num_prev_states
    chain = _Chain(generator, draws)

    stacked = terrain_lib.stack_terrains(terrains)
    terrain_idx = torch.arange(r, device=dev).repeat_interleave(b)
    row_terrain = np.repeat(np.arange(r), b)

    # per-row node tables padded to a common length with the final node
    # (progress toward a repeated final node is monotone/no-op)
    paths = [np.asarray(p, np.float32) for p in paths]
    n_max = max(len(p) for p in paths)
    nodes_np = np.stack([
        np.concatenate([p, np.repeat(p[-1:], n_max - len(p), axis=0)])
        for p in paths])
    row_nodes = nodes_np[row_terrain]                      # (B, N, 3)
    n_valid = np.asarray([len(p) for p in paths])[row_terrain]

    root_z = 0.7 + 0.2 * chain.root_u((r,), dev)
    start = np.stack([_anchor(p, np_prev, root_z[i])
                      for i, p in enumerate(paths)])
    frames = torch.as_tensor(np.repeat(start, b, axis=0), device=dev)
    contacts = torch.zeros((r * b, np_prev, model.num_bodies), device=dev)
    frames, contacts, lengths = _rollout(
        mdm, state, stacked, terrain_idx, row_nodes, n_valid, frames,
        contacts, True, chain, cfg)
    return [_result(mdm, t, frames[i * b:(i + 1) * b],
                    contacts[i * b:(i + 1) * b], lengths[i * b:(i + 1) * b])
            for i, t in enumerate(terrains)]


def score_rollouts(mdm: MDM, terrain: terrain_lib.Terrain,
                   frames34: torch.Tensor, contacts: torch.Tensor):
    """Contact + penetration losses (B,) for ranking rollouts (reference:
    tools/procgen/mdm_path.py:31-127)."""
    model = mdm.model
    root_rot = rot.exp_map_to_quat(frames34[..., 3:6])
    joint_rot = cm.dof_to_rot(model, frames34[..., 6:])
    body_pos, body_rot = cm.forward_kinematics(model, frames34[..., 0:3],
                                               root_rot, joint_rot)
    # contact points on all bodies
    bidx = model.contact_point_body
    q = body_rot[..., bidx, :]
    pts = body_pos[..., bidx, :] + rot.quat_rotate(
        q, model.contact_point_offset.expand(q.shape[:-1] + (3,)))
    ground = terrain_lib.get_hf_val(terrain, pts[..., 0:2])
    h_above = pts[..., 2] - model.contact_point_radius - ground

    # penetration: points below the surface
    pen = torch.clamp(-h_above, min=0.0)
    pen_loss = torch.sum(torch.mean(pen**2, dim=-1), dim=-1)

    # contact: flagged-contact bodies should be near the surface
    onehot = F.one_hot(bidx, model.num_bodies)
    inf = torch.full((), float("inf"), device=h_above.device)
    body_min_h = torch.amin(
        torch.where(onehot.T > 0, h_above[..., None, :], inf), dim=-1)
    tagged = contacts > 0.5
    cdist = torch.where(tagged, torch.clamp(body_min_h, min=0.0), 0.0)
    contact_loss = torch.sum(torch.mean(cdist**2, dim=-1), dim=-1)
    return contact_loss, pen_loss
