"""Physics-fidelity harness: open-loop PD replay of a fixed, diverse clip
set under sensitivity sweeps over contact / joint-limit parameters.

A sim whose contact + limit model supports the motions the reference's
PhysX TGS solver supports (reference: envs/ig_env.py:131-164) tracks
them open-loop; contact parameters far from that operating point degrade
it. Quantified by:

1. **Open-loop PD replay** (this module): drive the sim with PD targets
   taken directly from reference-format clips — no policy in the loop —
   and measure tracked reward / survival / tracking error until the
   first failure. Every control step is one launch of the control-step
   kernel (``physics/substep.py``) on the card.
2. **Sensitivity sweeps**: one-at-a-time perturbations of contact
   stiffness/damping/friction/force-cap and the joint-limit mode
   (penalty springs vs the hard SPD-implicit boundary spring,
   engine.compute_joint_torques hard branch). Small sensitivity near the
   default = the default sits on a plateau, not a knife edge.

Clip set (parc_torch/data/synthetic.py): standing + walking (flat),
platform_clip (height discontinuity), gap_jump_clip (flight + landing).

Run:  python -m parc_torch.tools.fidelity [--markdown] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from parc_torch import resolve_device
from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_lib as ml
from parc_torch.envs.base import DoneFlags, EnvConfig
from parc_torch.envs.deepmimic import DeepMimicEnv
from parc_torch.physics import engine


# real PARC kinematic clips over real terrains, shipped inside the
# reference PARC checkout (the motions the reference itself demos on),
# paths under that checkout; read only where PARC_REFERENCE_ROOT names one
REFERENCE_CLIP_PKLS = {
    "ref_civilization": "data/terrains/civilization.pkl",
    "ref_teaser": "data/terrains/TEASER_TERRAIN.pkl",
}


def fidelity_clips(include_reference: bool = True):
    from parc_torch.data.synthetic import (gap_jump_clip, platform_clip,
                                           standing_clip, walking_clip)
    clips = {
        "stand": standing_clip(),
        "walk": walking_clip(seed=1),
        "platform": platform_clip(),
        "gap_jump": gap_jump_clip(),
    }
    root = os.environ.get("PARC_REFERENCE_ROOT")
    if include_reference and root:
        from parc_torch.anim import motion_data as md
        for name, rel in REFERENCE_CLIP_PKLS.items():
            path = os.path.join(root, rel)
            if os.path.exists(path):
                clips[name] = md.load_motion_data(path)
    return clips


@dataclasses.dataclass
class ReplayResult:
    clip: str
    mean_reward: float       # mean tracked reward over pre-failure steps
    survival: float          # fraction of the clip completed before FAIL
    failed: bool
    tracking_error: np.ndarray  # (7,) mean over pre-failure steps


def pd_replay(model: cm.CharModel, sim_params: engine.SimParams,
              clips: Dict[str, "object"],
              env_cfg: Optional[EnvConfig] = None,
              seed: int = 0, device="cuda",
              copies: int = 1) -> List[ReplayResult]:
    """Open-loop PD replay: action_t = reference dof pose at t + dt, one
    control step (one kernel launch on the card) per clip frame step.

    ``copies`` replays each clip in that many envs (env ``e`` replays clip
    ``e % len(clips)``); one result per env, in env order.
    """
    dev = resolve_device(device)
    model = model.to(dev)
    names = list(clips.keys())
    n = len(names) * copies
    lib = ml.build_motion_lib(model, [clips[k] for k in names], device=dev)
    cfg = env_cfg or EnvConfig(num_envs=n, episode_length=1e9)
    env = DeepMimicEnv(model, sim_params, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.arange(n, device=dev) % len(names)
    state = env.reset(lib, gen, num_envs=n, motion_ids=ids)
    clip_steps = np.asarray(np.floor(lib.lengths.cpu().numpy()
                                     / cfg.control_dt), np.int32) - 1
    n_steps = int(clip_steps.max())

    # an env that fails or ends restarts from a reset pool (the JAX
    # package resets it inline): no step after an env's first failure or
    # its clip's end is read
    pool = env.build_reset_pool(lib, gen, state.fail_rates, n, k=1)
    slot = torch.zeros(n, dtype=torch.long, device=dev)
    rewards, dones, errs = [], [], []
    with torch.no_grad():
        for _ in range(n_steps):
            tar = ml.calc_motion_frame(lib, state.motion_ids,
                                       state.motion_times + cfg.control_dt)
            act = cm.rot_to_dof(model, tar.joint_rot)
            state = env.step(lib, state, act, reset_pool=pool,
                             pool_slot=slot)
            rewards.append(state.reward)
            dones.append(state.done)
            errs.append(state.tracking_error)
    rewards = torch.stack(rewards).cpu().numpy()       # (T, n)
    dones = torch.stack(dones).cpu().numpy()
    errs = torch.stack(errs).cpu().numpy()             # (T, n, 7)

    out = []
    for e in range(n):
        i = e % len(names)
        t_clip = int(clip_steps[i])
        fail_ts = np.nonzero(dones[:t_clip, e] == DoneFlags.FAIL)[0]
        t_end = int(fail_ts[0]) + 1 if fail_ts.size else t_clip
        out.append(ReplayResult(
            clip=names[i],
            mean_reward=float(rewards[:t_end, e].mean()),
            survival=t_end / max(t_clip, 1),
            failed=bool(fail_ts.size),
            tracking_error=errs[:t_end, e].mean(axis=0)))
    return out


def default_sweeps() -> Dict[str, engine.SimParams]:
    """One-at-a-time perturbations around the default operating point.

    The JAX package sets ``use_pallas=True`` here; the port has no such
    switch: ``engine.control_step`` launches the kernel on CUDA tensors and
    runs its plain version on the CPU."""
    return {
        # the default ships hard_joint_limits=True (PhysX-parity mode)
        "default": engine.SimParams(),
        "penalty_limits": engine.SimParams(hard_joint_limits=False),
        "stiffness_x0.5": engine.SimParams(contact_stiffness=4000.0),
        "stiffness_x2": engine.SimParams(contact_stiffness=16000.0),
        "damping_x0.5": engine.SimParams(contact_damping=150.0),
        "damping_x2": engine.SimParams(contact_damping=600.0),
        "friction_0.5": engine.SimParams(friction=0.5),
        "friction_1.5": engine.SimParams(friction=1.5),
        # x0.5 (1500 N) never binds on this clip set (identical to the
        # default row) — sweep a cap that actually clips landing impacts
        "force_cap_x0.1": engine.SimParams(max_contact_force=300.0),
    }


def run_sweeps(markdown: bool = False,
               sweeps: Optional[Dict[str, engine.SimParams]] = None,
               device="cuda", include_reference: bool = True
               ) -> Dict[str, List[ReplayResult]]:
    """``pd_replay`` of the clip set under every sweep, on ``device`` (the
    card unless the caller asks for the CPU)."""
    from parc_torch.data.humanoid import humanoid_spec
    dev = resolve_device(device)
    model = humanoid_spec().build(device=dev)
    clips = fidelity_clips(include_reference)
    sweeps = sweeps or default_sweeps()
    results = {}
    for name, params in sweeps.items():
        results[name] = pd_replay(model, params, clips, device=dev)
    if markdown:
        print(format_markdown(results))
    return results


def format_markdown(results: Dict[str, List[ReplayResult]]) -> str:
    clip_names = [r.clip for r in next(iter(results.values()))]
    lines = ["| config | " + " | ".join(
        f"{c} reward / survival" for c in clip_names) + " |"]
    lines.append("|---" * (1 + len(clip_names)) + "|")
    for cfg_name, rs in results.items():
        cells = [f"{r.mean_reward:.3f} / {r.survival:.2f}" for r in rs]
        lines.append(f"| {cfg_name} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog="parc_torch.tools.fidelity")
    p.add_argument("--markdown", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the replays (default cuda)")
    args = p.parse_args(argv)
    results = run_sweeps(markdown=True, device=args.device)
    if not args.markdown:
        for cfg_name, rs in results.items():
            for r in rs:
                print(f"{cfg_name:16s} {r.clip:10s} reward={r.mean_reward:.3f}"
                      f" survival={r.survival:.2f} failed={r.failed}"
                      f" err={np.round(r.tracking_error, 3)}")


if __name__ == "__main__":
    main()
