#!/usr/bin/env python3
"""Smoke run of parc_torch on one NVIDIA GPU: build the kernel, check it,
drive the tracker rollout, training, the MDM, kin-gen, the parkour env,
the tools, the studio and one PARC iteration's hand-off at full width,
and report.

    python3 chip_smoke.py

Phases, each printing one line of facts:
1. the card (nvidia-smi name and power limit); TF32 switched off for
   matmuls and cuDNN, so every f32 product runs in full f32;
2. the control-step kernel's nvcc build (parc_torch/csrc -> build/parc_torch/)
   and its ptxas report (registers, stack frame, spills), grid and shared
   memory at 4096 envs;
3. the kernel against its plain PyTorch version on the card at 4096 envs,
   on motion-lib states lowered into their terrain (contact active) with
   noisy dof velocities and envs pushed past their joint limits:
   (a) every control mode x {hard, soft} joint limits, contact + one
   substep; (b) the whole control step, 2 sim steps x 2 substeps; max abs
   error per field, failing above 2e-4 on the state and 2e-3 N + rtol
   1e-5 on the contact forces (or, where f32 itself is less accurate,
   above twice the plain version's own error against float64: see
   check_kernel); (c) two launches on the same input give the same bits;
   (d) the kernel's and the plain version's times per control step;
   (e) the bound; (f) the phase clock: the share of each stage of a
   substep;
4. the rollout of the bench configuration: 4096 envs, 3 clips, the 3x2048
   actor (PPOConfig defaults, random weights from a seed), reset pool
   k = 4, 64 control steps with the deterministic actor mean. The kernel
   must have been launched once per control step, 64 times; every output
   finite and on the card; env-steps/s (median of 5 such runs, min and
   max); the parts of a control step timed alone, and the device's busy
   time in a profiler trace of one; one control step from the rollout's
   last state through the kernel and through the plain version must agree
   as in phase 3;
5. training through the CLI at full width: the 3 bench clips written as
   .npz under build/, ``create_dataset`` over them (terrain masks
   precomputed on the card), ``train_tracker`` at 4096 envs with
   PPOConfig() (3x2048 bf16 trunks, 32 steps an iteration, 5 epochs of 8
   minibatches of 16,384) for 3 iterations, its deterministic test rollout
   once (iteration 1, 300 steps at most, 16 episodes). Per iteration: the
   wall time, samples/s, the rollout and update halves; the test rollout's
   steps and time; the last iteration's losses. The kernel must have been
   launched 32 times in each train_iter and once per test step; losses and
   parameters finite; the parameters moved; 3 x 32 x 4096 samples counted
   by the agent and by the normalizer; a checkpoint at step 3;
6. ``record`` from that checkpoint into one env per clip (any num_envs
   restores; cut to 2 of its 6 start fractions, one retry) and ``eval
   --diagnostics`` at 64 envs, through the CLI: the
   recorded clips (0 of 3 is expected of 3 iterations of training) are
   finite and 34-D, and every step launched the kernel once; then, from
   the record stage's env (3 envs: part of one block, the kernel's tail
   code) and the eval stage's (64 envs), each restored and stepped 10
   times, one control step through the kernel and the plain version must
   agree as in phase 3;
7. the motion diffusion model at full width (MDMConfig(), bf16 encoder)
   on phase 5's dataset: (a) ``train_mdm`` through the CLI, 4 epochs of 50
   AdamW steps of 64 windows and a final checkpoint at epoch 4: each
   epoch's seconds, windows/s and mean loss from the trainer's log, the
   peak device memory; every loss and parameter finite; (b) the trained
   denoiser on one 64-window batch: bf16 against f32 on the card (0 <
   relative error < 2e-2, the encoder layers' outputs bf16, the output
   f32), f32 on the card against the CPU (relative 1e-4), and the ms of
   one call at 64 and 128 (the CFG pair) windows; (c) the epoch-4
   checkpoint restored into a fresh MDM, then ``gen_mdm_motion`` on 64
   windows (prev frames from the dataset's clips at seeded random times,
   the clips' stacked terrains) three times: DDIM stride 5, with
   classifier-free guidance 2.5, and with target + heightfield gradient
   guidance; and ``ddpm_sample`` (1001 steps) once. Each run's seconds and
   denoiser calls (201 for DDIM, 1001 for DDPM); frames (64, 15, 34)
   finite, contacts (64, 15, 15) in {0, 1}. The MDM reaches no hand-written
   kernel (the JAX package runs its denoiser outside Pallas too);
8. kinematic generation (parc_2) from phase 7's checkpoint on phase 5's
   dataset, at KinGenConfig() width (boxes terrains of 32 x 32 cells at
   0.4 m, 32 rollouts a terrain, top-2, mirroring) with the MDM at
   MDMConfig() (bf16 encoder), the keep thresholds at infinity so that
   keep -> optimize -> mirror -> save runs on a 200-step MDM; run length
   cut from 10 s and the contact optimization from 500 Adam iterations to
   250: (a) ``kin_gen`` through the CLI, 2 motion slots
   with 2 terrains a batch (64 rows a denoise step), 5 s paths; (b) the
   sequential mode once, 1 slot, 2 s, its contact optimization cut to 100
   Adam iterations; each with its seconds, windows, rows,
   frames generated per second, denoiser calls (gated at windows x 201),
   native A* ms per plan, the contact optimization's ms per Adam iteration
   and its summed loss before and after (gated: finite, not raised), how
   many rollouts the default thresholds would have kept, and no physics
   launch; (c) ``optimize`` on two of (a)'s clips (250 of its default 3,000
   iterations), ``augment`` (2 motions, 100 of 1,000 iterations),
   ``setup_iter``, and ``create_dataset`` over every output, each listed
   clip reloaded equal to what its stage saved; (d) f32 (bf16 off) on the
   card against the CPU: one window of generate_frames_along_path (8 rows,
   explicit draws) over a kin-gen path's box terrain, both sides given the
   CPU's local heightfield, within 1e-4 relative (the cells where the
   card's own nearest-cell lookup differs are counted apart); one
   motion-opt loss with its gradient (1e-5 of the total, 1e-4 of the
   largest); (e) the device's idle share of one window of 64 rows
   and of an Adam iteration (a 20-iteration run less a 0-iteration one),
   from torch.profiler. Kin-gen reaches no
   hand-written kernel (the JAX package runs it outside Pallas too).
9. the parkour env (parc_3's training env: dm rows on the dataset clips,
   mgdm rows tracking references the MDM generates in the step) from
   phase 7's checkpoint on phase 5's dataset: (a) ``train_tracker
   --env_name parkour`` through the CLI at 4096 envs, 512 of them mgdm
   rows, ParkourConfig() (a replan every 15 control steps, DDIM stride 20:
   51 denoiser calls at MDMConfig() width), PPOConfig(), 3 iterations, the
   test rollout cut to 100 steps: per iteration the wall time, samples/s,
   replans and launches (32 each); each replan's wall and CUDA-event ms
   and denoiser calls (gated); a control step with and without a replan,
   a replan's device busy time and idle share; the peak device memory; a
   checkpoint whose fail rates carry the terrain slot; (b) the kernel
   against the plain version, as in phase 3, on 3 successive control
   steps of the parkour env from the state after a replan, the mgdm rows
   on the platform slot of the grown terrain stack, each step's limits
   printed under judge's rule and the old one (where the plain version's
   worst env sets every env's limits), and the largest over the steps;
   (c) one train_iter each of the vision policies (dm_cnn_mlp, dm_vit,
   bf16 trunks) on that env at 4096 envs, an act call's ms, and a forward
   pass bf16 against f32 within (0, 2e-2) relative; (d) ``record`` (one
   env per clip, one start fraction) and ``eval`` (64 envs) from 9a's
   checkpoint with the parkour config, both gated to build the deepmimic
   env with SimParams(). The vision nets and the replans reach no
   hand-written kernel (the JAX package runs them outside Pallas too);
10. data parallelism over torch.distributed (one process a rank, started
   by ``python -m torch.distributed.run``; the ranks rerun this script with
   ``--dp-worker``): (a) 2 ranks on the one card over gloo (NCCL refuses
   two ranks on one GPU), 2048 envs each at PPOConfig() widths in f32 on
   tests/test_torch_ppo.py's deterministic setup (one standing clip, 4
   steps an iteration, no random reset, no action noise, one minibatch an
   epoch), 2 iterations, each against one process's iteration at 4096
   envs from the same state: the normalizer, sample count, fail rates,
   parameters, momentum and metrics at that file's tolerances, the ranks
   bit-identical, check_param_sync 0, one launch a step on every rank,
   and one control step of each rank's 2048 envs through the kernel
   against the plain version (as in phase 3); the one process's free run
   of both iterations is printed beside them, and its second iteration
   run again from its own state, as it was and with the parameters moved
   by the ranks' first-iteration gap in random signs;
   (b) ``train_tracker --env_name parkour``
   through the CLI under torchrun, 2 ranks on the card over gloo, 4096
   envs and 512 mgdm rows in all, from phase 7's MDM, 2 iterations: each
   rank's replans counted and on the same steps, fail rates and
   parameters bit-identical, only rank 0 writing a log and a checkpoint,
   which restores into a one-process eval; one control step of each
   rank's final state (2048 envs, 256 mgdm rows) through the kernel
   against the plain version (as in phase 3); per rank and in all the
   seconds an iteration and samples/s beside phase 9a's, the peak memory
   per rank; (c) with two cards or more, (a) over NCCL, one rank a card;
   with one, a world-size-1 NCCL group's all_reduce and broadcast on the
   card.
11. the tools on the card, from phases 5, 7 and 8's outputs: (a) the
   CLI's ``metrics`` stage on phase 8a's kin-gen clips (per-clip metrics,
   the CSV, ``dataset_statistics``), every value finite and each within
   1e-4 relative of the same call on the CPU; (b) ``tools/fidelity.py``:
   ``run_sweeps`` (9 sweeps x the 4 synthetic clips, open-loop PD replay
   through the control-step kernel) with its table and seconds a sweep,
   gated at one launch a control step and on tests/test_fidelity.py's
   thresholds for the default sweep (stand reward > 1.2, survival > 0.30;
   walk > 0.74, > 0.24; tracking errors finite, the root's < 0.5); then
   ``pd_replay`` at 4096 envs (each clip 1,024 times), every copy of a
   clip giving the same result bits, and its 30th control step through
   the kernel against the plain version (as in phase 3); (c)
   ``run_validation`` from phase 7's checkpoint on two kin-gen boxes
   fixtures with their A* paths (paths cut to 3 s of 10), top 4: rows =
   fixtures x 4, metrics finite; (d) ``retarget_keypoints`` at
   RetargetConfig() (1,500 Adam iterations) on the walking clip's own
   keypoints, the round trip's mean keypoint error under 0.06 m and the
   frames inside the dof limits, and ``retarget_keypoints_to_robot`` on a
   small URDF the script carries, its losses falling and finite; (e) the
   editing and geometry helpers on the card against the CPU on a kin-gen
   clip: resample_fps, blend_motions and correct_foot_ground_pen within
   1e-4; compute_contacts equal but where a contact point's nearest cell
   differs (a cell edge) or its height sits on the eps band's edge (counted
   apart); the match search's frames equal; flat_maxpool_3x3,
   downsample_terrain, merge_hfs and hf_from_motion equal; the native
   mesher's mesh valid (indices in range, no degenerate triangle).
12. the viewer and the studio, from phases 5, 7 and 8's outputs: (a) the
   CLI's ``view --compare`` of an 8a clip against its 8c optimized copy on
   the card, its page's DATA against the same stage on the CPU (body
   positions within 1e-4 + 2e-6, the rest equal), and whether a PNG strip
   was drawn (only where matplotlib is installed); (b) the studio
   (``Studio(device="cuda")``) over HTTP on 127.0.0.1, port 0, with phase
   7's MDM and phase 5's tracker: procgen boxes 32 x 32, A* corner to
   corner, mdm_gen at its defaults (8 rollouts, 6 s), recompute_contacts,
   optimize at 300 iterations, accept_overlay, track, sim_start, sim_step
   64, sim_stop, flip, resample to 60 fps, slice, save and a stitch onto
   the saved copy, then GET /api/state: every answer 200 with finite
   frames, each op's wall ms and payload bytes, the control-step kernel
   launched once a control step (track's steps and 64 for sim_step, no
   other op); (c) one control step of the live sim's 1-env state after its
   64 steps through the kernel and the plain version, judged as in phase
   3 (the kernel's first check at a single env).
13. one PARC iteration's hand-off, from phases 5, 7 and 8's outputs through
   the CLI and the configs that 8c's ``setup_iter`` wrote: (a)
   ``iter_0/motions+gen.yaml`` by ``create_dataset`` over one motions
   directory holding phase 5's 3 bench clips and every clip of phase 8
   (8a, 8b, 8c; a class a stage, keep thresholds at infinity), each listed
   clip reloaded equal to what its stage saved and the motion library's
   terrain stack one slot a clip; (b) ``train_tracker --config
   iter_0/train_tracker.yaml`` at 4096 envs, PPOConfig(), 2 iterations, the
   test rollout once and cut to 100 steps, gated as in phase 5 (32
   launches a train_iter, one a test step, losses and parameters finite,
   the parameters moved, the sample count, a checkpoint at step 2); (c)
   from (b)'s env after SETTLE more steps, with rows of the box-terrain
   slots in contact, one control step through the kernel and the plain
   version, judged as in phase 3, with the contact points that lie within
   1e-4 cell of a grid line beside a wall (where the bilinear normal
   jumps) counted; (d) ``record --config iter_0/record.yaml`` (cut to one
   start fraction) and ``eval --diagnostics`` from (b)'s checkpoint: frames
   finite and 34-D, each recorded clip on its source clip's terrain, one
   record round of launches, eval launches = test steps, the diagnostics'
   rows under the JAX package's names; (e) ``setup_iter --iter 1``,
   ``create_dataset --config iter_0/create_dataset.yaml`` where (d)
   recorded a clip (else iteration 0's motions+gen.yaml stands in), and
   ``train_mdm --config iter_1/train_mdm.yaml --init_from`` phase 7's run
   for one epoch of 50 steps at MDMConfig(): the state it starts from
   equal to phase 7's checkpoint bit for bit, the loss finite; the same
   call again resumes from its own checkpoint and ignores --init_from.
Phase 3g, after phase 3: the quadruped (13 bodies, 12 hinge dofs, 36
contact points) at 4096 envs near its standing pose in a bumpy stacked
terrain, drawn on the CPU from 6 seeds: the kernel against the plain
version in pd_implicit and pd_1d with the ~11 kg robot's contact
parameters (judged as in phase 3, at 2x on the state), its time and
bound; then 30 control steps of the stand through
engine.control_step on the kernel (root height within 0.2-0.45 m) and 45
of the passive collapse (below 0.2 m).
The line before the last holds the kernel report as JSON; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0)
before that line; without CUDA the script exits non-zero and runs nothing.
"""

import contextlib
import copy
import csv
import dataclasses
import glob
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_data as md
from parc_torch.anim import motion_lib as ml
from parc_torch.data.humanoid import humanoid_spec
from parc_torch.data.quadruped import quadruped_spec, standing_pose_dof
from parc_torch.data.synthetic import standing_clip, walking_clip
from parc_torch.diffusion import gen as gen_lib
from parc_torch.diffusion import sampler as sampler_lib
from parc_torch.diffusion import schedules
from parc_torch.diffusion.guidance import GuidanceParams
from parc_torch.diffusion.mdm import MDM, MDMConfig
from parc_torch.envs.base import EnvConfig
from parc_torch.envs.deepmimic import DeepMimicEnv
from parc_torch.learning.ppo import PPOAgent, PPOConfig
from parc_torch.physics import engine
from parc_torch.physics import substep as sub
from parc_torch.pipeline import cli
from parc_torch.pipeline import dataset as dataset_lib
from parc_torch.pipeline import record, train_tracker
from parc_torch.pipeline.kin_gen import KinGenConfig
from parc_torch.utils import checkpoint as ckpt_lib
from parc_torch.utils import profiling
from parc_torch.utils import rotation as rot
from parc_torch.utils import terrain as terrain_lib
from parc_torch.utils.terrain import Terrain

NUM_ENVS = 4096
TRAIN_ITERS = 3  # phase 5; the test rollout runs once, at iteration 1
EVAL_ENVS = 64   # phase 6
RECORD_FRACTIONS = (0.0, 0.1)  # phase 6's record: 2 of its 6 start fractions
SETTLE = 10      # phase 6: control steps before the kernel-vs-plain step
WORK = Path(__file__).resolve().parent / "build" / "chip_smoke"
ROLLOUT_STEPS = 64
ROLLOUT_RUNS = 5  # 64-step runs timed; the first is the counted main path
ATOL = 2e-4  # tests/test_pallas.py:190-193
# judge: float64's own move under input perturbations of RERUN_REL
# relative, the largest of RERUN_DRAWS draws, excuses an env where it is at
# least half the kernel's miss (both in the env's limits), in at most
# EXCUSE_SHARE of a check's envs
RERUN_DRAWS, RERUN_REL, EXCUSE_SHARE = 8, 1e-6, 1e-3
CONTACT_ATOL, CONTACT_RTOL = 2e-3, 1e-5  # tests/test_torch_engine.py
H = 1.0 / 120.0
LOWER = 0.04  # m the phase-3 states are lowered into their terrain
STATE_CHECK = ("root_pos", "joint_rot", "dof_vel", "body_pos")
JUDGE_DIR = WORK / "judge"  # judge: the inputs of steps that failed envs
ITER_ROOT = WORK / "parc"  # 8c and 13: setup_iter's root

# peak device-memory rates (bytes/s) by card, from NVIDIA's data sheets;
# checked in order, the first substring of the nvidia-smi name wins
MEM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12))
F32_RATE = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)
BF16_RATE = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
MDM_EPOCHS, MDM_ITERS = 4, 50  # phase 7a: 200 AdamW steps
MDM_WINDOWS = 64  # phase 7: training batch and generated windows
MDM_BF16_TOL, MDM_CPU_TOL = 2e-2, 1e-4  # phase 7b, relative max errors
# phase 8: kin-gen at KinGenConfig() width; run length cut from 10 s
KIN_MOTIONS, KIN_TERRAINS_PER_BATCH, KIN_SECONDS = 2, 2, 5.0  # 8a
KIN_SEQ_SECONDS, KIN_SEQ_OPT_ITERS = 2.0, 100  # 8b, one motion slot
OPT_ITERS, AUG_MOTIONS, AUG_ITERS = 250, 2, 100  # 8c (defaults 3000, 1000)
KIN_OPT_ITERS = 250  # 8a, kin_gen's contact optimization (default 500)
KIN_CHECK_ROWS, KIN_CHECK_SEED = 8, 3  # 8d, 8e
# 8d, card vs CPU in f32, relative max errors: a window's frames over a
# box terrain, both given the CPU's local heightfield; the motion-opt loss
# terms and gradient
KIN_FRAMES_TOL = 1e-4
OPT_TERMS_TOL, OPT_GRAD_TOL = 1e-5, 1e-4
# phase 9: the parkour env at 4096 envs, PARKOUR_MGDM of them mgdm rows;
# its test rollout (and 9d's eval) cut from 300 steps
PARKOUR_MGDM, PARKOUR_TEST_STEPS = 512, 100
# 9b: the kernel-vs-plain check on this many successive control steps from
# the state after a replan (that state depends on phase 7a's training, which
# is not deterministic on the card; the spread over the steps is what a run
# of this script can see of how the check varies)
PARKOUR_CHECKS = 3


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


def substep_operations(model: cm.CharModel) -> int:
    """f32 operations of one substep of one env, contact included, counted
    from csrc/substep_math.cuh per stage (a multiply-add is 2; a sqrt,
    divide or transcendental is 1): a lower bound for the op-rate bound."""
    types = model.joint_types[1:]
    sph, hinge = types.count(cm.SPHERICAL), types.count(cm.HINGE)
    fixed = types.count(cm.FIXED)
    joints, bodies = model.num_bodies - 1, model.num_bodies
    points = model.contact_point_body.shape[0]
    # per point: world position and velocity 48, bilinear height and
    # normal 50, penalty and friction force 44, moment 9; then 6 adds
    # into its body's sum
    contact = 151 * points + 6 * points
    torque = 70 * joints + 10 * model.dof_size
    inertia = 25 * bodies + 51 * joints + 270 * bodies
    inward = 960 * sph + 480 * hinge + 340 * fixed
    outward = 90 * joints
    root = 300
    integrate = 70 * joints + 100
    fk = 140 * joints
    return (contact + torque + inertia + inward + root + outward + integrate
            + fk)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_busy_ms(fn, reps: int, kernel: str = ""):
    """Mean device time per fn() call from a torch.profiler trace: of every
    kernel (the device's busy time), or of the kernels whose name holds
    ``kernel``; None if the trace shows no such device time. A span's copy
    on the device's timeline (the program's ``parc.*`` spans, PyTorch's
    ``Optimizer.*``) is not device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.device_time_total for e in prof.events()
                  if e.device_type == DeviceType.CUDA and kernel in e.name
                  and not e.is_user_annotation)
    return busy_us / 1e3 / reps if busy_us > 0 else None


def build_lib(model, device):
    return ml.build_motion_lib(
        model, [standing_clip(), walking_clip(seed=1), walking_clip(seed=2)],
        device=device)


def kernel_inputs(model, lib, n, seed, device):
    """Packed state, PD targets / actions and terrain index of n envs:
    motion-lib frames lowered LOWER m into their motion's terrain (the
    feet in contact), seeded noise on the dof velocities, a quarter of the
    envs past their upper joint limits and a quarter past their lower
    ones, by 0.02-0.08 rad (the hard limits hold the humanoid within
    0.063 rad under load, tests/test_physics.py::test_hard_joint_limits),
    and PD targets near the pose, as a tracking policy gives them."""
    g = torch.Generator(device=device).manual_seed(seed)
    ids = ml.sample_motions(lib, g, n)
    times = ml.sample_time(lib, g, ids)
    fr = ml.calc_motion_frame(lib, ids, times)
    dof = cm.rot_to_dof(model, fr.joint_rot)
    push = 0.02 + 0.06 * torch.rand(dof.shape, generator=g, device=device)
    row = torch.arange(n, device=device)[:, None] % 4
    dof = torch.where(row == 1, model.dof_limits_upper + push,
                      torch.where(row == 3, model.dof_limits_lower - push,
                                  dof))
    dof_vel = fr.dof_vel + 0.5 * torch.randn(dof.shape, generator=g,
                                             device=device)
    root_pos = fr.root_pos - torch.tensor([0.0, 0.0, LOWER], device=device)
    st = engine.create_state(model, root_pos, fr.root_rot,
                             cm.dof_to_rot(model, dof), fr.root_vel,
                             fr.root_ang_vel, dof_vel, device=device)
    act = (cm.rot_to_dof(model, fr.joint_rot)
           + 0.1 * torch.randn(dof.shape, generator=g, device=device))
    state_p = sub.pack(sub.state_layout(model), vars(st), n)
    return state_p, act, ids.to(torch.int32)


def const_packed(model, mode, act):
    """The packed PD targets of a control mode (joint quats only where the
    mode reads them, as engine.control_step packs them)."""
    n = act.shape[0]
    qtar = (cm.dof_to_rot(model, act) if mode in ("pd_implicit", "pd_exp")
            else torch.zeros((n, model.num_bodies - 1, 4), device=act.device))
    return sub.pack(sub.const_layout(model), {"act": act, "qtar": qtar}, n)


def lib_terrain(lib):
    """The motion library's stacked per-motion terrains as a Terrain."""
    return Terrain(hf=lib.terrain_hf,
                   hf_mask=torch.zeros_like(lib.terrain_hf, dtype=torch.bool),
                   hf_maxmin=lib.terrain_maxmin,
                   min_point=lib.terrain_min_point, dxdy=lib.terrain_dxdy)


def as_f64(model):
    """The model with its float tables in float64."""
    return model.replace(**{k: v.double() for k, v in vars(model).items()
                            if isinstance(v, torch.Tensor)
                            and v.is_floating_point()})


def terrain_f64(terrain):
    return dataclasses.replace(
        terrain, hf=terrain.hf.double(), hf_maxmin=terrain.hf_maxmin.double(),
        min_point=terrain.min_point.double(), dxdy=terrain.dxdy.double())


def terrain_cpu(terrain):
    return dataclasses.replace(terrain, **{
        f.name: getattr(terrain, f.name).cpu()
        for f in dataclasses.fields(terrain)
        if isinstance(getattr(terrain, f.name), torch.Tensor)})


def env_errors(got, plain, cpu, want64, rerun, save=None):
    """A kernel-vs-plain check, env by env, for judge. Each of ``got`` (the
    kernel), ``plain`` (the plain f32 version on the card), ``cpu`` (the
    same on the CPU) and ``want64`` (the plain version in float64) is a
    pair (state (n, a), contact forces (n, b)), a row an env. The plain
    version's error against float64 is the larger of its two evaluations:
    the same f32 code on the two devices lands up to 6.3x apart from
    float64 in the worst of 4096 envs (PERF.md, PR 7). ``rerun(envs)``
    gives float64's own move in those envs under input perturbations
    (rerun_moves); ``save(path, envs, facts)`` writes those envs' packed
    inputs for a replay on the CPU (replay_inputs). Also the whole-batch
    figures that the phases print."""
    def dist(a, b):
        return (a.double() - b.double().to(a.device)).abs().amax(1).cpu()

    def excess(a, b):  # what the contact error spends of the tolerance
        b = b.double().to(a.device)
        return ((a.double() - b).abs()
                - CONTACT_RTOL * b.abs()).amax(1).cpu()
    e = dict(kp_s=dist(got[0], plain[0]), kp_c=excess(got[1], plain[1]),
             k64_s=dist(got[0], want64[0]), k64_c=excess(got[1], want64[1]),
             card_s=dist(plain[0], want64[0]),
             card_c=excess(plain[1], want64[1]),
             cpu_s=dist(cpu[0], want64[0]), cpu_c=excess(cpu[1], want64[1]))
    e["p64_s"] = torch.maximum(e["card_s"], e["cpu_s"])
    e["p64_c"] = torch.maximum(e["card_c"], e["cpu_c"])

    def worst(k):
        return e[k].max().item()
    return dict(
        env=e, rerun=rerun, save=save, state_err=worst("kp_s"),
        contact_err=worst("kp_c"),
        plain64_err={"state": worst("p64_s"), "contact": worst("p64_c"),
                     "card": {"state": worst("card_s"),
                              "contact": worst("card_c")},
                     "cpu": {"state": worst("cpu_s"),
                             "contact": worst("cpu_c")}},
        kernel64_err={"state": worst("k64_s"), "contact": worst("k64_c")},
        env64={"kernel": e["k64_s"], "plain": e["card_s"]},
        q999={"kernel": torch.quantile(e["k64_s"], 0.999).item(),
              "plain": torch.quantile(e["card_s"], 0.999).item()})


def rerun_moves(step64, inputs):
    """How far float64's own step moves in each env when its input moves
    by RERUN_REL relative (about 8 f32 ulps), the largest over RERUN_DRAWS
    draws: ``step64(inputs)`` -> (state (k, a), contact (k, b)) on float64
    ``inputs`` (a list of tensors, a row an env; the first, the state, is
    perturbed). Where a contact point sits at the threshold of contact,
    this is as large as a wrong answer (PERF.md, PR 7)."""
    base_s, base_c = step64(inputs)
    g = torch.Generator(device=inputs[0].device).manual_seed(0)
    move_s = torch.zeros(len(base_s), dtype=torch.float64)
    move_c = torch.zeros_like(move_s)
    for _ in range(RERUN_DRAWS):
        x = inputs[0] * (1.0 + RERUN_REL * torch.randn(
            inputs[0].shape, generator=g, device=inputs[0].device,
            dtype=torch.float64))
        s_, c_ = step64([x] + list(inputs[1:]))
        move_s = torch.maximum(move_s, (s_ - base_s).abs().amax(1).cpu())
        move_c = torch.maximum(move_c, (c_ - base_c).abs().amax(1).cpu())
    return move_s, move_c


def replay_inputs(args, out):
    """A ``save(path, envs, facts)`` for env_errors: writes the envs'
    columns of one packed control step (``args`` as control_step_packed
    takes them, ``out`` the kernel's (state, contact forces)), the model,
    the terrain, the step's parameters and ``facts``, so that the step can
    be replayed on the CPU: through the plain version, in float64, and
    through the g++ host build of the kernel's math
    (tests/test_torch_substep_host.py)."""
    model, params, terrain, state_p, const_p, tidx, sim_steps = args

    def save(path, envs, facts):
        i = envs.to(state_p.device)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(dict(model=model.to("cpu"), params=params,
                        terrain=terrain_cpu(terrain), sim_steps=sim_steps,
                        envs=envs.cpu(), state_p=state_p[:, i].cpu(),
                        const_p=const_p[:, i].cpu(),
                        tidx=None if tidx is None else tidx[i].cpu(),
                        kernel=tuple(x[:, i].cpu() for x in out), **facts),
                   path)
    return save


def packed_check(args, got, got_c, model64, terrain64):
    """env_errors of one packed control step (``args`` as
    control_step_packed takes them; ``got`` its kernel output), and the
    plain version's output on the card."""
    model, params, terrain, state_p, const_p, tidx, sim_steps = args
    want, want_c = sub.control_step_packed_reference(*args)
    want64, want64_c = sub.control_step_packed_reference(
        model64, params, terrain64, state_p.double(), const_p.double(),
        tidx, sim_steps)
    cpu, cpu_c = sub.control_step_packed_reference(
        model.to("cpu"), params, terrain_cpu(terrain), state_p.cpu(),
        const_p.cpu(), None if tidx is None else tidx.cpu(), sim_steps)

    def step64(inputs):  # a row an env: the packed layout's columns
        s_, c_ = sub.control_step_packed_reference(
            model64, params, terrain64, inputs[0].T.contiguous(),
            inputs[1].T.contiguous(), None if tidx is None else inputs[2],
            sim_steps)
        return s_.T, c_.T

    def rerun(envs):
        i = envs.to(state_p.device)
        return rerun_moves(step64, [state_p.double().T[i],
                                    const_p.double().T[i]]
                           + ([] if tidx is None else [tidx[i]]))
    c = env_errors((got.T, got_c.T), (want.T, want_c.T), (cpu.T, cpu_c.T),
                   (want64.T, want64_c.T), rerun,
                   replay_inputs(args, (got, got_c)))
    return c, want, want_c


def limits_text(lim):
    """judge's four limits: kernel vs plain and kernel vs float64, each
    state / contact."""
    return (f"kernel vs plain {lim[0]:.3e} / {lim[1]:.3e}, kernel vs "
            f"float64 {lim[2]:.3e} / {lim[3]:.3e}")


def judge(c, what, state_ratio=1.5):
    """Fail unless the kernel agrees with the plain version (``c`` from
    env_errors): the state within 2e-4 and the contact forces within
    2e-3 N + rtol 1e-5, or, where f32 itself is less accurate than that,
    within twice the plain f32 version's own error against float64 (the
    larger of its evaluations on the card and on the CPU); and the
    kernel's own error against float64 (or within the tolerance) at most
    1.5x the plain version's on the state and 2x on the contact forces.
    The contact forces pass thresholds (a point in or out of contact, the
    force clamp, friction saturation), so which of two f32 versions lands
    nearer float64 there swings more from state to state: on the fallen
    characters of the rollout's end the kernel was 1.55x, in phase 3b
    0.86x. ``state_ratio`` replaces the 1.5x on the state where the same
    holds of the state (phase 3g).

    An env that fails is excused only where float64 itself is unstable
    there: with its input moved by RERUN_REL relative, float64's own step
    moves by at least half the kernel's miss, both counted in the env's
    limits, the largest share of a limit over the four (the env's limits
    are all raised by one factor, the one that takes the limit float64's
    move spends most of to twice that move). A contact point crossing its
    threshold moves the state and the contact forces both, but which of
    the two shows it at the step's end depends on the substep where it
    falls: in the last sim step the contact forces (its mean over those
    substeps), earlier the state alone. So float64 moving on either one
    stands for both: in a 9b env float64's state moved 8.5x the kernel's
    state miss while its contact forces moved 0.29x the kernel's contact
    miss (PERF.md §6). The other envs' limits are then taken
    without the excused envs, and an env that fails only those is printed
    with float64's moves there and given the same test, round after round,
    until no env fails; at most EXCUSE_SHARE of the envs (at least one) are
    excused in all. These rounds alone are the old rule.

    The limits are one set for every env, so an env where the plain
    version itself lands on float64's other branch would loosen them for
    all (10.21 on the state and 1,614.7 N on the contact in one 9b step on
    the card, PERF.md §6). So the plain version's worst envs get the same
    test: where float64 moves at least half the plain version's miss
    there, moves and misses counted in the limits the other envs set, the
    env is taken out of the limits and judged by its own, raised as an
    excused env's are; the limits are taken again without it and the next
    worst plain env is tested, until the worst left is stable. A plain env
    is tested only where a verdict turns on it: where taking the plain
    version's worst envs (at most what the cap leaves room for, and one
    more) out of the limits fails some other env. Envs taken out and
    excused count under the one EXCUSE_SHARE; where the plain side would
    go past it, the worst plain envs left go on setting the limits, and the
    printed line says so. An env that fails only the lower limits gets the
    test of an excused env; where that finds no room, the last plain env
    taken out sets the limits again, so the kernel is never failed for the
    plain version's instability. Every env's limits are at most the old
    rule's. Each env is rerun at most once a call.

    Each call prints its limits under both rules and the envs taken out,
    and leaves them in ``c["limits"]``. Where an env fails, is excused or
    is taken out, the step's inputs at the envs concerned go to JUDGE_DIR
    (``c["save"]``) for a replay on the CPU. Returns (state tolerance,
    contact tolerance, {env: float64's moves} of the envs excused or taken
    out), the tolerances those of the last round."""
    e = c["env"]
    n = len(e["kp_s"])
    cap = max(1, int(EXCUSE_SHARE * n))

    def limits(keep):  # with every env excused, the plain tolerances
        p_s, p_c = (e[k][keep].max().item() if keep.any() else 0.0
                    for k in ("p64_s", "p64_c"))
        return (max(ATOL, 2.0 * p_s), max(CONTACT_ATOL, 2.0 * p_c),
                max(ATOL, state_ratio * p_s), max(CONTACT_ATOL, 2.0 * p_c))

    def failing(lim):
        tol_s, tol_c, lim_s, lim_c = lim
        return ((e["kp_s"] > tol_s) | (e["kp_c"] > tol_c)
                | (e["k64_s"] > lim_s) | (e["k64_c"] > lim_c))

    def share(xs, lim):  # the largest share of a limit; xs (state, contact)
        return max(x / y for x, y in zip(xs + xs, lim))

    def raised(lim, moves):  # an env's limits, raised by float64's moves
        grow = max(1.0, 2.0 * share(moves, lim))
        return tuple(x * grow for x in lim)

    moved = {}  # env -> float64's moves (state, contact)

    def rerun(envs):
        new = [k for k in envs if k not in moved]
        if new:
            m_s, m_c = c["rerun"](torch.tensor(new))
            moved.update(zip(new, zip(m_s.tolist(), m_c.tolist())))
        return [moved[k] for k in envs]

    def worst_plain(keep, stable, k):
        """The plain version's k worst envs on the state and on the
        contact, each run down to the first stable env or an error that
        raises no limit above its floor."""
        idx = keep.nonzero().flatten()
        runs = []
        for q, least in (("p64_s", ATOL / max(2.0, state_ratio)),
                         ("p64_c", CONTACT_ATOL / 2.0)):
            vals = e[q][idx]
            run = []
            for i in vals.topk(min(k, len(idx))).indices.tolist():
                if vals[i] <= least or idx[i].item() in stable:
                    break
                run.append(idx[i].item())
            runs.append(run)
        return runs

    def report(envs, moves):
        return "; ".join(
            f"env {k}: kernel vs float64 {e['k64_s'][k]:.3e} / "
            f"{e['k64_c'][k]:.3e}, plain vs float64 {e['p64_s'][k]:.3e} / "
            f"{e['p64_c'][k]:.3e}, kernel vs plain {e['kp_s'][k]:.3e} / "
            f"{e['kp_c'][k]:.3e}, float64 moves {m_s:.3e} / {m_c:.3e}"
            for k, (m_s, m_c) in zip(envs, moves))

    def saved(envs, **facts):  # the step's inputs at envs, for a replay
        if c.get("save") is None:
            return ""
        path = JUDGE_DIR / (re.sub(r"[^\w.-]+", "_", what.strip()) + ".pt")
        c["save"](path, envs[:64], dict(what=what, errors=e, **facts))
        return f"; inputs saved to {path}"

    def seen():
        return torch.cat(tested + [torch.tensor(list(out), dtype=torch.long)])

    def fail(why, lim):
        return AssertionError(
            f"{what}: kernel disagrees with plain version {why} (limits: "
            f"{limits_text(lim)}, state / contact); whole batch: "
            f"kernel vs plain {c['state_err']:.3e} / {c['contact_err']:.3e},"
            f" vs float64 kernel {c['kernel64_err']}, plain "
            f"{c['plain64_err']}")
    perturbed = f" under {RERUN_REL} relative input perturbations"
    keep = torch.ones(n, dtype=torch.bool)
    lim = limits(keep)
    excused, tested, out = {}, [], {}
    for round_ in itertools.count(1):
        envs = (failing(lim) & keep).nonzero().flatten()
        if not len(envs):
            break
        tested.append(envs)
        if len(excused) + len(envs) > cap:
            raise fail(f"in {len(seen())} of {n} envs by round {round_}"
                       + saved(seen(), limits=lim), lim)
        moves = rerun(envs.tolist())
        if round_ > 1:
            print(f"{what}: round {round_}: envs that fail the limits "
                  f"taken without the excused envs {sorted(excused)}: "
                  + report(envs.tolist(), moves))
        for env, m in zip(envs.tolist(), moves):
            if failing(raised(lim, m))[env]:
                raise fail(f"in round {round_}, {report([env], [m])}"
                           + perturbed + saved(seen(), limits=lim), lim)
            excused[env] = m
        keep[envs] = False
        lim = limits(keep)
    old = lim
    # the plain side: threshold envs of the plain version out of the limits
    stable, left, undo, held, spared = set(), [], None, None, []
    while True:
        envs = (failing(lim) & keep).nonzero().flatten()
        if len(envs):  # envs that fail only the lower limits
            tested.append(envs)
            moves = rerun(envs.tolist())
            for env, m in zip(envs.tolist(), moves):
                if failing(tuple(map(min, raised(lim, m), old)))[env]:
                    raise fail(
                        f"once plain envs {sorted(out)} were taken out of "
                        f"the limits (the old rule's: {limits_text(old)}), "
                        f"{report([env], [m])}" + perturbed
                        + saved(seen(), limits=lim, old=old), lim)
            if len(excused) + len(out) + len(envs) > cap:
                keep, lim, excused, out, last = undo
                left = [last]
                break
            excused.update(zip(envs.tolist(), moves))
            keep[envs] = False
            lim = limits(keep)
            continue
        room = cap - len(excused) - len(out)
        runs = worst_plain(keep, stable, room + 1)
        chain = torch.zeros(n, dtype=torch.bool)
        chain[torch.tensor(sum(runs, []), dtype=torch.long)] = True
        tight = limits(keep & ~chain)
        if not (failing(tight) & keep & ~chain).any():
            held, spared = tight, sorted(set(sum(runs, [])))
            break
        if not room:
            left = list(dict.fromkeys(sum(runs, [])))
            break
        rerun(list(dict.fromkeys(runs[0][:room] + runs[1][:room])))
        for h in dict.fromkeys(run[0] for run in runs if run):
            without = keep.clone()
            without[h] = False
            lim_h, m = limits(without), moved[h]
            miss = (e["p64_s"][h].item(), e["p64_c"][h].item())
            if 2.0 * share(m, lim_h) < share(miss, lim_h):
                stable.add(h)
                continue
            if failing(tuple(map(min, raised(lim_h, m), old)))[h]:
                raise fail(f"in plain env {h}, taken out of the limits, "
                           f"{report([h], [m])}" + perturbed
                           + saved(seen(), limits=lim_h, old=old), lim_h)
            undo = (keep, lim, dict(excused), dict(out), h)
            keep, lim = without, limits(without)
            out[h] = m
            break
    if excused:
        print(f"{what}: {len(excused)} env(s) excused in {len(tested)} "
              f"round(s), where float64 itself moves as far under input "
              f"perturbations of {RERUN_REL} relative (state / contact): "
              + ", ".join(f"env {k}: moves {m_s:.3e} / {m_c:.3e}, the "
                          f"kernel's miss {e['k64_s'][k]:.3e} / "
                          f"{e['k64_c'][k]:.3e}"
                          for k, (m_s, m_c) in excused.items()))
    held = held or lim
    c["limits"] = dict(new=lim, old=old, held=held, out=out, left=left)
    print(f"{what}: limits {limits_text(lim)} (state / contact); the old "
          f"rule's {limits_text(old)}; "
          + ("plain envs taken out of the limits, where float64 moves at "
             "least half the plain version's miss: " + report(list(out),
                                                              out.values())
             if out else "no plain env taken out")
          + (f"; every other env but plain envs {spared} within "
             f"{limits_text(held)} (not rerun: no verdict turns on them)"
             if held != lim else "")
          + (f"; the cap of {cap} env(s) taken out or excused reached: "
             f"plain env(s) {left} go on setting the limits" if left else "")
          + (saved(seen(), limits=lim, old=old, excused=excused, out=out)
             if excused or out else ""))
    return lim[0], lim[1], {**excused, **out}


def check_kernel(model, lib, device):
    """Phase 3: kernel vs plain version at 4096 envs with contact active.

    (a) every mode x limit form, contact + one substep; (b) the whole
    control step in pd_implicit. Where f32 itself is less accurate than
    the tolerance (the explicit modes on these states amplify joint
    velocities about 40x in one substep on the light links; deep contact
    turns f32 rounding of a height into N-scale force differences through
    the 8000 N/m stiffness), the kernel passes within twice the plain f32
    version's own error against a float64 evaluation of the same step."""
    n = NUM_ENVS
    state_p, act, tidx = kernel_inputs(model, lib, n, 1, device)
    terrain, terrain64 = lib_terrain(lib), terrain_f64(lib_terrain(lib))
    layout = sub.state_layout(model)
    model64 = as_f64(model)
    worst = 0.0
    one = dict(dt=H, substeps=1)
    cases = ([(mode, hard, 1, one) for mode in engine.CONTROL_MODES
              for hard in (True, False)]
             + [("pd_implicit", True, 2, {})])
    for mode, hard, sim_steps, step in cases:
        params = engine.SimParams(control_mode=mode, hard_joint_limits=hard,
                                  **step)
        const_p = const_packed(model, mode, act)
        got, got_c = sub.control_step_packed(model, params, terrain, state_p,
                                             const_p, tidx, sim_steps)
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.isfinite(got_c).all()):
            raise AssertionError(f"kernel output not finite ({mode}, "
                                 f"hard={hard}, sim_steps={sim_steps})")
        c, want, want_c = packed_check(
            (model, params, terrain, state_p, const_p, tidx, sim_steps),
            got, got_c, model64, terrain64)
        errs = {name: (sub.unpack(got, layout, name)
                       - sub.unpack(want, layout, name)).abs().max().item()
                for name, _ in layout.fields}
        state_err, contact_err = c["state_err"], c["contact_err"]
        plain64, kernel64 = c["plain64_err"], c["kernel64_err"]
        what = (f"{'b' if sim_steps > 1 else 'a'} {mode:11s} "
                f"{'hard' if hard else 'soft'} {sim_steps}x{params.substeps}")
        tol_s, tol_c, _ = judge(c, f"phase 3{what}")
        worst = max(worst, state_err)
        print(f"phase 3{what}: max|kernel-plain| state {state_err:.3e} "
              f"(tolerance {tol_s:.1e}), contact {contact_err:.3e} past rtol "
              f"(tolerance {tol_c:.1e}); vs float64: kernel {kernel64['state']:.2e} / "
              f"{kernel64['contact']:.2e}, plain {plain64['state']:.2e} / "
              f"{plain64['contact']:.2e} (card {plain64['card']['state']:.2e}"
              f", CPU {plain64['cpu']['state']:.2e} on the state); "
              f"max|contact| "
              f"{want_c.abs().max().item():.1f} N ("
              + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()) + ")")

    params = engine.SimParams()
    const_p = const_packed(model, "pd_implicit", act)
    args = (model, params, terrain, state_p, const_p, tidx, 2)
    first, again = sub.control_step_packed(*args), sub.control_step_packed(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("two launches on the same input differ")
    print("phase 3c: two launches on the same input give the same bits")
    # the kernel's own time from the profiler's trace (a call of the
    # wrapper costs the host about as long as the kernel runs, so CUDA
    # events around back-to-back calls would time the host); events if the
    # trace shows no device time
    call_ms = cuda_ms(lambda: sub.control_step_packed(*args), 200)
    ms = device_busy_ms(lambda: sub.control_step_packed(*args), 200,
                        "control_step_kernel")
    timed_by = "profiler"
    if ms is None:
        ms, timed_by = call_ms, "CUDA events"
    plain_ms = cuda_ms(lambda: sub.control_step_packed_reference(*args), 5)
    # each input read once, each output written once
    hf, min_point, dxdy = sub.stacked_terrain(terrain)
    nbytes = 4 * (state_p.numel() + const_p.numel() + first[0].numel()
                  + first[1].numel() + tidx.numel() + hf.numel()
                  + min_point.numel() + dxdy.numel())
    nbytes += sum(t.numel() * 4 for t in sub.model_tables(model))
    ops = substep_operations(model) * 2 * params.substeps * n
    cycles = sub.phase_cycles(*args)
    return dict(max_abs_err=worst, ms=ms, timed_by=timed_by, call_ms=call_ms,
                plain_ms=plain_ms, bytes=nbytes, ops=ops, cycles=cycles)


def rollout(model, lib, device):
    """Phase 4: the bench configuration's rollout through the port."""
    cfg = EnvConfig(num_envs=NUM_ENVS)
    env = DeepMimicEnv(model, engine.SimParams(), cfg, device=device)
    agent = PPOAgent(env, PPOConfig(), device=device)
    g = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    state = agent.init(lib, g)
    pool_k = agent.cfg.reset_pool_k
    pool = env.build_reset_pool(lib, g, state.env_state.fail_rates, NUM_ENVS,
                                k=pool_k)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def step(es, counts):
        action = agent.act(state, es.obs)  # the deterministic actor mean
        es = env.step(lib, es, action, reset_pool=pool,
                      pool_slot=counts % pool_k)
        return es, counts + (es.done != 0).long()

    counts0 = torch.zeros(NUM_ENVS, dtype=torch.long, device=device)
    es, counts = state.env_state, counts0
    for _ in range(2):  # warm-up (cuBLAS handles, allocator), discarded
        step(es, counts)
    torch.cuda.synchronize()

    sub.control_step_packed.launches = 0
    t0 = time.perf_counter()
    reward_sum = torch.zeros((), device=device)
    for _ in range(ROLLOUT_STEPS):
        es, counts = step(es, counts)
        reward_sum = reward_sum + es.reward.mean()
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = sub.control_step_packed.launches
    dones = int(counts.sum().item())
    for _ in range(ROLLOUT_RUNS - 1):  # more timed runs, for the spread
        t0 = time.perf_counter()
        for _ in range(ROLLOUT_STEPS):
            es, counts = step(es, counts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[len(walls) // 2]

    if launches != ROLLOUT_STEPS:  # one launch per control step
        raise AssertionError(f"control-step kernel launched {launches} "
                             f"times, expected {ROLLOUT_STEPS}")
    tensors = {"obs": es.obs, "reward": es.reward, "terminal_obs":
               es.terminal_obs, **{f"sim.{k}": v for k, v in vars(es.sim).items()}}
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise AssertionError(f"{name} is on {t.device}, not {device}")
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name} is not finite")
    mean_reward = reward_sum.item() / ROLLOUT_STEPS

    # the breakdown of one control step, each part timed on its own
    with torch.no_grad():
        action = agent.act(state, es.obs)
        terrain = lib_terrain(lib)
        parts = {
            "policy_ms": cuda_ms(lambda: agent.act(state, es.obs), 10),
            "physics_ms": cuda_ms(lambda: engine.control_step(
                model, env.sim_params, terrain, es.sim, action,
                terrain_idx=es.motion_ids), 10),
            "env_step_ms": cuda_ms(lambda: env.step(
                lib, es, action, reset_pool=pool,
                pool_slot=counts % pool_k), 10),
            "obs_ms": cuda_ms(lambda: env._compute_obs(lib, es), 10),
        }
        busy = device_busy_ms(lambda: step(es, counts), 5)

    rates = sorted(NUM_ENVS * ROLLOUT_STEPS / w for w in walls)
    step_ms = 1e3 * wall / ROLLOUT_STEPS
    return dict(launches=launches, wall_s=wall, setup_s=setup_s,
                env_steps_per_s=NUM_ENVS * ROLLOUT_STEPS / wall,
                rate_min=rates[0], rate_max=rates[-1], step_ms=step_ms,
                busy_ms=busy, mean_reward=mean_reward, dones=dones,
                **step_vs_plain(model, env, lib, es, action), **parts)


@torch.no_grad()
def step_vs_plain(model, env, lib, es, action):
    """One control step of env from es: kernel, plain f32 on the card and
    on the CPU, and plain float64 (the yardstick of what f32 can hold
    here); the errors, for judge()."""
    terrain = lib_terrain(lib)
    model64, terrain64 = as_f64(model), terrain_f64(terrain)
    kw = dict(terrain_idx=es.motion_ids,
              sim_steps=env.cfg.sim_steps_per_control)
    packed = []

    def kernel(*args):  # the kernel, its packed inputs and outputs kept
        packed.extend((args, sub.control_step_packed(*args)))
        return packed[-1]
    got = engine.control_step(model, env.sim_params, terrain, es.sim,
                              action, step_fn=kernel, **kw)
    plain = engine.control_step(model, env.sim_params, terrain, es.sim,
                                action, step_fn=sub.control_step_packed_reference,
                                **kw)
    sim64 = engine.SimState(**{k: v.double() for k, v in vars(es.sim).items()})
    plain64 = engine.control_step(model64, env.sim_params, terrain64, sim64,
                                  action.double(),
                                  step_fn=sub.control_step_packed_reference,
                                  **kw)

    def on_cpu(sim):
        return engine.SimState(**{k: v.cpu() for k, v in vars(sim).items()})
    plain_cpu = engine.control_step(
        model.to("cpu"), env.sim_params, terrain_cpu(terrain), on_cpu(es.sim),
        action.cpu(), step_fn=sub.control_step_packed_reference,
        terrain_idx=es.motion_ids.cpu(), sim_steps=kw["sim_steps"])

    def rows(a):  # (state, contact forces), a row an env
        n = a.root_pos.shape[0]
        return (torch.cat([getattr(a, f).reshape(n, -1)
                           for f in STATE_CHECK], 1),
                a.contact_forces.reshape(n, -1))
    names = [f.name for f in dataclasses.fields(es.sim)]
    sizes = [getattr(es.sim, k)[0].numel() for k in names]

    def step64(inputs):  # the sim state's fields flattened into a row
        sim = engine.SimState(**{
            k: v.reshape((-1,) + getattr(es.sim, k).shape[1:])
            for k, v in zip(names, inputs[0].split(sizes, 1))})
        return rows(engine.control_step(
            model64, env.sim_params, terrain64, sim, inputs[1],
            step_fn=sub.control_step_packed_reference, terrain_idx=inputs[2],
            sim_steps=kw["sim_steps"]))

    def rerun(envs):
        i = envs.to(action.device)
        flat = torch.cat([getattr(es.sim, k)[i].reshape(len(i), -1)
                          for k in names], 1).double()
        return rerun_moves(step64, [flat, action[i].double(),
                                    es.motion_ids[i]])
    c = env_errors(rows(got), rows(plain), rows(plain_cpu), rows(plain64),
                   rerun, replay_inputs(*packed))
    step_err = {f: (getattr(got, f) - getattr(plain, f)).abs().max().item()
                for f in STATE_CHECK}
    step_err["contact_forces"] = c["contact_err"]
    for k in ("state", "contact"):
        step_err[f"plain_vs_f64_{k}"] = c["plain64_err"]["card"][k]
        step_err[f"plain_cpu_vs_f64_{k}"] = c["plain64_err"]["cpu"][k]
        step_err[f"kernel_vs_f64_{k}"] = c["kernel64_err"][k]
    return dict(c, step_err=step_err,
                max_contact=got.contact_forces.abs().max().item())


def f64_ratio(r):
    """The kernel's state error against float64 over the plain f32
    version's: in the worst env over judge's yardstick (the larger of the
    card's and the CPU's), at the envs' 99.9th percentile over the
    card's."""
    return (r["kernel64_err"]["state"] / r["plain64_err"]["state"],
            r["q999"]["kernel"] / r["q999"]["plain"])


@torch.no_grad()
def stage_state_check(dataset, tracker, device, num_envs, record_env):
    """Phase 6's kernel check: the env that the record stage (one env per
    clip, rand_reset off, reset to each clip's start) or the eval stage
    (num_envs, the test rollout's reset) builds, restored from the
    tracker's checkpoint, stepped SETTLE steps with the deterministic
    actor; then one control step from there through the kernel and the
    plain version."""
    model = humanoid_spec().build(device=device)
    lib = ml.load_motion_lib(model, dataset_files(dataset), device=device)
    cfg = {"tracker_dir": tracker}
    g = torch.Generator(device=device).manual_seed(0)
    if record_env:
        env = cli._tracking_env(model, cfg, device, num_envs=lib.num_motions,
                                rand_reset=False)
        agent, state = cli._restored_agent(cfg, lib, env, seed=0)
        es = env.reset(lib, g, num_envs=lib.num_motions,
                       motion_ids=torch.arange(lib.num_motions, device=device),
                       start_times=torch.zeros(lib.num_motions, device=device))
    else:
        env = cli._tracking_env(model, cfg, device, num_envs=num_envs)
        agent, state = cli._restored_agent(cfg, lib, env, seed=0)
        es = env.reset(lib, g, num_envs=num_envs)
    for _ in range(SETTLE):
        es = env.step(lib, es, agent.act(state, es.obs), generator=g)
    r = step_vs_plain(model, env, lib, es, agent.act(state, es.obs))
    r["envs"] = es.obs.shape[0]
    return r


def bench_clips():
    """The bench motion set: a standing clip and two walks."""
    return [standing_clip(), walking_clip(seed=1), walking_clip(seed=2)]


def train(device):
    """Phase 5: create_dataset and train_tracker through the CLI, at full
    width."""
    motions = WORK / "motions" / "bench"
    for name, clip in zip(("stand", "walk1", "walk2"), bench_clips()):
        md.save_motion_data(str(motions / f"{name}.npz"), clip)
    dataset = str(WORK / "dataset.yaml")
    tracker = WORK / "tracker"
    t0 = time.perf_counter()
    cli.main(["create_dataset", "--motions_dir", str(motions.parent),
              "--out", dataset, "--device", device.type])
    dataset_s = time.perf_counter() - t0
    for f in dataset_files(dataset):
        clip = md.load_motion_data(f)
        if clip.terrain.hf_mask is None or clip.hf_mask_inds is None:
            raise AssertionError(f"create_dataset wrote no masks into {f}")
    t = counted_train(["--dataset", dataset, "--out_dir", str(tracker),
                       "--device", device.type], tracker, TRAIN_ITERS,
                      device, "phase 5")
    return dict(t, dataset=dataset, dataset_s=dataset_s)


def counted_train(args, tracker, iters_asked, device, what):
    """train_tracker through the CLI at NUM_ENVS envs for ``iters_asked``
    iterations (``args`` give the rest), gated. Each train_iter and the
    trainer's test rollout are wrapped to count the kernel's launches, time
    them, and keep the metrics, the agent and the motion library; the
    wrappers are taken off before returning."""
    iters, tests, start = [], [], {}
    train_iter, make_test_fn = PPOAgent.train_iter, train_tracker.make_test_fn

    def counted_iter(agent, lib, state, timer=None):
        if not start:
            start.update({k: p.detach().clone()
                          for k, p in agent.net.named_parameters()})
        before = dict(timer.summary()) if timer is not None else {}
        n0, t = sub.control_step_packed.launches, time.perf_counter()
        out = train_iter(agent, lib, state, timer=timer)
        profiling.sync(device)
        wall = time.perf_counter() - t
        after = timer.summary() if timer is not None else {}
        ms = {k: 1e3 * (after[k]["total_s"]
                        - before.get(k, {"total_s": 0.0})["total_s"])
              for k in ("rollout", "update") if k in after}
        iters.append(dict(launches=sub.control_step_packed.launches - n0,
                          wall_s=wall, metrics=out[1], agent=agent, lib=lib,
                          **ms))
        return out

    def counted_test_fn(agent, *args, **kwargs):
        fn = make_test_fn(agent, *args, **kwargs)

        def run(lib, state, generator):
            n0, t = sub.control_step_packed.launches, time.perf_counter()
            out = fn(lib, state, generator)
            profiling.sync(device)
            tests.append(dict(launches=sub.control_step_packed.launches - n0,
                              wall_s=time.perf_counter() - t,
                              steps=int(out["test_steps"])))
            return out
        return run

    PPOAgent.train_iter = counted_iter
    train_tracker.make_test_fn = counted_test_fn
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        sub.control_step_packed.launches = 0
        t0 = time.perf_counter()
        state = cli.main(["train_tracker", "--num_envs", str(NUM_ENVS),
                          "--max_iters", str(iters_asked)] + args)
        profiling.sync(device)
        train_s = time.perf_counter() - t0
        launches = sub.control_step_packed.launches
        peak_gb = (torch.cuda.max_memory_allocated(device) / 1e9
                   if device.type == "cuda" else float("nan"))
    finally:
        PPOAgent.train_iter = train_iter
        train_tracker.make_test_fn = make_test_fn

    steps = PPOConfig().steps_per_iter
    samples = iters_asked * steps * NUM_ENVS
    if [it["launches"] for it in iters] != [steps] * iters_asked:
        raise AssertionError(f"{what}: control-step launches per train_iter "
                             f"{[it['launches'] for it in iters]}, expected "
                             f"{steps} each")
    if len(tests) != 1 or tests[0]["launches"] != tests[0]["steps"]:
        raise AssertionError(f"{what}: test rollouts {tests}: expected one, "
                             f"with one launch per step")
    if launches != samples // NUM_ENVS + tests[0]["steps"]:
        raise AssertionError(f"{what}: {launches} launches in the whole run")
    agent = iters[-1]["agent"]
    for i, it in enumerate(iters):
        m = it["metrics"]
        for name in ("actor_loss", "critic_loss", "bound_loss", "mean_reward"):
            if not torch.isfinite(getattr(m, name)).all():
                raise AssertionError(f"{what}: iteration {i + 1}: {name} not "
                                     f"finite")
    moved = {}
    for k, p in agent.net.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"{what}: parameter {k} is not finite")
        moved[k] = (p.detach() - start[k]).abs().max().item()
    if min(moved.values()) <= 0.0:
        raise AssertionError(f"{what}: parameters did not move: {moved}")
    if float(state.sample_count) != samples:
        raise AssertionError(f"{what}: sample_count "
                             f"{float(state.sample_count)}, expected "
                             f"{samples}")
    if float(state.obs_norm.count) != samples:
        raise AssertionError(f"{what}: normalizer count "
                             f"{float(state.obs_norm.count)}, expected "
                             f"{samples}")
    if ckpt_lib.all_steps(str(tracker / "checkpoints")) != [iters_asked]:
        raise AssertionError(f"{what}: no checkpoint at step {iters_asked} "
                             f"in {tracker / 'checkpoints'}")
    return dict(iters=iters, test=tests[0], launches=launches,
                tracker=str(tracker), train_s=train_s, state=state,
                obs_dim=agent.env.obs_dim,
                log_rate=log_samples_per_sec(tracker), moved=moved,
                peak_gb=peak_gb)


def dataset_files(dataset):
    """The clip files a dataset manifest lists."""
    with open(dataset) as f:
        return [e["file"] for e in yaml.safe_load(f)["motions"]]


def log_samples_per_sec(tracker):
    """Samples_Per_Sec of the trainer's log.tsv (its output iterations)."""
    with open(tracker / "log.tsv") as f:
        return [float(r["Samples_Per_Sec"])
                for r in csv.DictReader(f, delimiter="\t")]


def record_and_eval(t, device):
    """Phase 6: record (one env per clip, restored from phase 5's
    checkpoint) and eval --diagnostics, through the CLI."""
    config = WORK / "record.yaml"
    config.write_text(yaml.safe_dump(dict(
        start_fractions=list(RECORD_FRACTIONS))))
    sub.control_step_packed.launches = 0
    t0 = time.perf_counter()
    results = cli.main(["record", "--dataset", t["dataset"], "--tracker_dir",
                        t["tracker"], "--out_dir", str(WORK / "recorded"),
                        "--config", str(config), "--device", device.type])
    profiling.sync(device)
    record_s = time.perf_counter() - t0
    record_launches = sub.control_step_packed.launches
    clips = [c for c in results if c is not None]
    for c in clips:
        if c.frames.ndim != 2 or c.frames.shape[1] != 34:
            raise AssertionError(f"recorded frames {c.frames.shape}, not "
                                 f"(T, 34)")
        if not (np.isfinite(c.frames).all() and np.isfinite(c.contacts).all()):
            raise AssertionError("recorded clip not finite")
    lib = ml.load_motion_lib(humanoid_spec().build(device="cpu"),
                             dataset_files(t["dataset"]), device="cpu")
    per_round = record.round_steps(lib, record.RecordConfig().max_steps)
    if (record_launches % per_round != 0 or record_launches == 0
            or record_launches > len(RECORD_FRACTIONS) * per_round):
        raise AssertionError(f"record launched the kernel {record_launches} "
                             f"times, not a whole number of {per_round}-step "
                             f"rounds")
    sub.control_step_packed.launches = 0
    t0 = time.perf_counter()
    test, report = cli.main(["eval", "--dataset", t["dataset"],
                             "--tracker_dir", t["tracker"], "--num_envs",
                             str(EVAL_ENVS), "--diagnostics", "--device",
                             device.type])
    profiling.sync(device)
    eval_s = time.perf_counter() - t0
    eval_launches = sub.control_step_packed.launches
    if eval_launches != int(test["test_steps"]):
        raise AssertionError(f"eval: {eval_launches} launches over "
                             f"{int(test['test_steps'])} steps")
    if not all(torch.isfinite(v).all() for v in test.values()):
        raise AssertionError("eval statistics not finite")
    # the kernel against the plain version at both stages' env counts
    # (3 envs fill part of one block: the kernel's tail code); these
    # launches come after the stages' counts were read
    checks = [stage_state_check(t["dataset"], t["tracker"], device, n, rec)
              for n, rec in ((None, True), (EVAL_ENVS, False))]
    for c, what in zip(checks, ("record", "eval")):
        c["tol"] = judge(c, f"phase 6 {what} control step")
    return dict(recorded=len(clips), motions=len(results), record_s=record_s,
                record_launches=record_launches, per_round=per_round,
                eval_s=eval_s, eval_launches=eval_launches,
                eval_steps=int(test["test_steps"]),
                layers=len(report["weights"]), checks=checks)


def denoiser_flops(net, b):
    """Operations (a multiply-add is 2) of one cached-condition denoiser
    call on b windows: every Linear of the timestep MLP (1 token), the
    frame and output MLPs (seq_len tokens) and the encoder layers (all
    tokens), plus each layer's attention scores and weighted sums; the
    condition tokens come from the cache."""
    n = 1 + net.num_cond_tokens + net.seq_len

    def linears(module, tokens):
        return sum(2 * tokens * m.in_features * m.out_features
                   for m in module.modules() if isinstance(m, torch.nn.Linear))

    attention = 2 * 2 * n * n * net.d_model * len(net.layers)
    return b * (linears(net.t_mlp, 1) + linears(net.in_mlp, net.seq_len)
                + linears(net.out_mlp, net.seq_len)
                + linears(net.layers, n) + attention)


def train_mdm(t, device):
    """Phase 7a: train_mdm through the CLI at full width on phase 5's
    dataset."""
    out = WORK / "mdm"
    shutil.rmtree(out, ignore_errors=True)
    config = WORK / "mdm.yaml"
    config.write_text(yaml.safe_dump(dict(
        iters_per_epoch=MDM_ITERS, epochs_per_output=1,
        max_epochs=MDM_EPOCHS)))
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = cli.main(["train_mdm", "--dataset", t["dataset"], "--out_dir",
                      str(out), "--config", str(config)])
    profiling.sync(device)
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    with open(out / "log.tsv") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    losses = [float(r["Loss"]) for r in rows]
    if len(rows) != MDM_EPOCHS or not np.isfinite(losses).all():
        raise AssertionError(f"train_mdm logged {len(rows)} epochs, losses "
                             f"{losses}")
    if state.step != MDM_EPOCHS * MDM_ITERS:
        raise AssertionError(f"train_mdm took {state.step} steps")
    for net in (state.net, state.ema_net):
        for k, p in net.named_parameters():
            if not torch.isfinite(p).all():
                raise AssertionError(f"MDM parameter {k} is not finite")
    if ckpt_lib.all_steps(str(out / "checkpoints")) != [MDM_EPOCHS]:
        raise AssertionError(f"no MDM checkpoint at epoch {MDM_EPOCHS}")
    return dict(state=state, rows=rows, train_s=train_s, peak_gb=peak_gb,
                out=out)


@torch.no_grad()
def check_denoiser(mdm, state, batch, device):
    """Phase 7b: the trained denoiser on one batch: bf16 against f32 on the
    card, f32 on the card against the CPU, and its time per call."""
    g = torch.Generator(device=device).manual_seed(3)
    b = batch.frames.shape[0]
    gt_std, prev_std = mdm._standardize(state, batch.frames,
                                        batch.prev_states)
    t_ = torch.randint(0, mdm.rates.num_timesteps, (b,), generator=g,
                       device=device)
    x_t = schedules.forward_diffusion(mdm.rates, gt_std, t_, torch.randn(
        gt_std.shape, generator=g, device=device))
    args = (x_t, t_, prev_std, batch.hf, batch.target_dir)
    net16 = state.net
    if net16.compute_dtype != torch.bfloat16:
        raise AssertionError("the MDM's encoder does not run in bf16 on "
                             "the card")
    net32 = copy.deepcopy(net16)
    net32.compute_dtype = None
    dtypes = []
    hooks = [layer.register_forward_hook(
        lambda m, i, o: dtypes.append(o.dtype)) for layer in net16.layers]
    y16 = net16(*args)
    for h in hooks:
        h.remove()
    y32 = net32(*args)
    if dtypes != [torch.bfloat16] * len(net16.layers) or \
            y16.dtype != torch.float32:
        raise AssertionError(f"encoder layer outputs {dtypes}, denoiser "
                             f"output {y16.dtype}: not a bf16 stack")
    bf16_err = ((y16 - y32).abs().max() / y32.abs().max()).item()
    if not 0.0 < bf16_err < MDM_BF16_TOL:
        raise AssertionError(f"bf16 denoiser vs f32: relative error "
                             f"{bf16_err} outside (0, {MDM_BF16_TOL})")
    cpu32 = copy.deepcopy(net32).cpu()
    y_cpu = cpu32(*(a.cpu() for a in args))
    cpu_err = ((y32.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item()
    if not cpu_err <= MDM_CPU_TOL:
        raise AssertionError(f"f32 denoiser on the card vs the CPU: "
                             f"relative error {cpu_err}")
    ones = torch.ones((b,), device=device)
    cond = net16.encode_conditions(prev_std, batch.hf, batch.target_dir,
                                   ones, ones, ones)
    ms = {n: cuda_ms(lambda: net16(torch.cat([x_t] * k), torch.cat([t_] * k),
                                   cond_toks=torch.cat([cond] * k)), 20)
          for k, n in ((1, b), (2, 2 * b))}
    return dict(bf16_err=bf16_err, cpu_err=cpu_err, ms=ms,
                flops={n: denoiser_flops(net16, n) for n in ms})


def serve_mdm(mdm, t7, lib, model, batch, device):
    """Phase 7c: the epoch-4 checkpoint in a fresh MDM, gen_mdm_motion three
    ways and ddpm_sample once, on MDM_WINDOWS windows."""
    state = mdm.merge_persistent(
        mdm.init(lib, torch.Generator(device=device).manual_seed(1),
                 stats_samples=64),
        ckpt_lib.restore(str(t7["out"] / "checkpoints"), map_location=device))
    if state.step != MDM_EPOCHS * MDM_ITERS:
        raise AssertionError(f"restored MDM at step {state.step}")
    g = torch.Generator(device=device).manual_seed(7)
    n, dt = MDM_WINDOWS, 1.0 / mdm.scfg.fps
    ids = ml.sample_motions(lib, g, n)
    times = ml.sample_time(lib, g, ids, truncate_time=1.0 + dt)
    frames = ml.calc_motion_frame(
        lib, ids[:, None].expand(n, 2),
        times[:, None] + torch.tensor([0.0, dt], device=device))
    prev34, contacts = ml.frames_34d(model, frames), frames.contacts
    target = ml.calc_motion_frame(lib, ids, times + 1.0 + dt).root_pos[:, :2]
    runs = {"DDIM": gen_lib.GenSettings(),
            "DDIM, guidance scale 2.5":
                gen_lib.GenSettings(guidance_scale=2.5),
            "DDIM, target + hf guidance": gen_lib.GenSettings(
                guidance=GuidanceParams(use_target=True, use_hf=True))}
    steps = len(range(0, mdm.rates.num_timesteps, 5))
    out = {}
    for name, settings in runs.items():
        mdm.denoise_calls = 0
        t0 = time.perf_counter()
        f34, con = gen_lib.gen_mdm_motion(
            mdm, state, g, prev34, contacts, lib_terrain(lib), target,
            settings, terrain_idx=ids)
        profiling.sync(device)
        out[name] = dict(s=time.perf_counter() - t0,
                         calls=mdm.denoise_calls, expect=steps,
                         frames=f34, contacts=con)
    mdm.denoise_calls = 0
    t0 = time.perf_counter()
    feats = mdm.ddpm_sample(state, g, batch.prev_states, batch.hf,
                            batch.target_dir)
    profiling.sync(device)
    f34, con = gen_lib.frames34_from_features(mdm, feats)
    out["DDPM"] = dict(s=time.perf_counter() - t0, calls=mdm.denoise_calls,
                       expect=mdm.rates.num_timesteps, frames=f34,
                       contacts=torch.clamp(torch.round(con), 0.0, 1.0))
    for name, r in out.items():
        f34, con = r["frames"], r["contacts"]
        if f34.shape != (n, mdm.scfg.seq_len, 34) or \
                con.shape != (n, mdm.scfg.seq_len, model.num_bodies):
            raise AssertionError(f"{name}: shapes {tuple(f34.shape)}, "
                                 f"{tuple(con.shape)}")
        if not torch.isfinite(f34).all():
            raise AssertionError(f"{name}: frames not finite")
        if not ((con == 0) | (con == 1)).all():
            raise AssertionError(f"{name}: contacts not in {{0, 1}}")
        if r["calls"] != r["expect"]:
            raise AssertionError(f"{name}: {r['calls']} denoiser calls, "
                                 f"expected {r['expect']}")
        prev = (prev34 if name != "DDPM" else gen_lib.frames34_from_features(
            mdm, batch.prev_states)[0])
        r["root_travel"] = (f34[:, -1, :2] - prev[:, -1, :2]).norm(
            dim=-1).mean().item()
    return out


def mdm_phase(t, device, smi):
    """Phase 7: the MDM at full width: train, check, serve."""
    t7 = train_mdm(t, device)
    for r in t7["rows"]:
        rate = float(r["Samples_Per_Sec"])
        print(f"phase 7a: epoch {int(float(r['Epoch'])) + 1}: "
              f"{MDM_ITERS * MDMConfig().batch_size / rate:.3f} s, "
              f"{rate:.1f} windows/s, mean loss {float(r['Loss']):.4f} "
              f"| {smi}")
    model = humanoid_spec().build(device=device)
    lib = dataset_lib.load_dataset(model, t["dataset"], device=device)
    mdm = MDM(model, MDMConfig(), device=device)
    state = t7["state"]
    nparams = sum(p.numel() for p in state.net.parameters())
    print(f"phase 7a: train_mdm through the CLI: MDMConfig() ({nparams} "
          f"parameters, bf16 encoder), {MDM_EPOCHS} epochs x {MDM_ITERS} "
          f"steps x {MDMConfig().batch_size} windows in {t7['train_s']:.1f} "
          f"s (exact feature stats included); peak device memory "
          f"{t7['peak_gb']:.2f} GB; checkpoint at epoch {MDM_EPOCHS} "
          f"| {smi}")
    batch = sampler_lib.sample_batch(
        model, mdm.scfg, lib, torch.Generator(device=device).manual_seed(2),
        MDM_WINDOWS)
    d = check_denoiser(mdm, state, batch, device)
    share = {n: d["flops"][n] / BF16_RATE / (d["ms"][n] / 1e3)
             for n in d["ms"]}
    print(f"phase 7b: denoiser bf16 vs f32 on the card: relative max error "
          f"{d['bf16_err']:.3e} (gate (0, {MDM_BF16_TOL})); f32 card vs CPU "
          f"(TF32 off): {d['cpu_err']:.3e} (gate {MDM_CPU_TOL}); one call "
          + ", ".join(f"{ms:.3f} ms at {n} windows ({d['flops'][n] / 1e9:.1f}"
                      f" GFLOP, {share[n]:.3f} of the bf16 peak)"
                      for n, ms in d["ms"].items())
          + f" (CUDA events, 20 calls) | {smi}")
    # where a training step's and a DDIM window's time goes: the host's
    # wall clock of an unprofiled call (device_busy_ms's warm-up) against
    # the device's busy time in a profiler trace of the next one
    wall = {}

    def timed(name, fn):
        def run():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.setdefault(name, time.perf_counter() - t0)
        return run

    g = torch.Generator(device=device).manual_seed(4)
    step_busy = device_busy_ms(timed("train", lambda: [
        mdm.train_step(lib, state) for _ in range(5)]), 1)
    ddim_busy = device_busy_ms(timed("ddim", lambda: mdm.ddim_sample(
        state, g, batch.prev_states, batch.hf, batch.target_dir)), 1)
    for name, busy, n in (("train_step", step_busy, 5),
                          ("ddim_sample (201 steps)", ddim_busy, 1)):
        key = "train" if n == 5 else "ddim"
        print(f"phase 7b: {name} on {MDM_WINDOWS} windows: "
              f"{1e3 * wall[key] / n:.2f} ms wall, device busy "
              + ("not measured (no device time in the trace)" if busy is None
                 else f"{busy / n:.2f} ms, idle share "
                 f"{1.0 - busy / (1e3 * wall[key]):.3f}") + f" | {smi}")
    runs = serve_mdm(mdm, t7, lib, model, batch, device)
    for name, r in runs.items():
        print(f"phase 7c: {name}: {MDM_WINDOWS} windows in {r['s']:.3f} s, "
              f"{r['calls']} denoiser calls ({1e3 * r['s'] / r['calls']:.2f} "
              f"ms each), frames {tuple(r['frames'].shape)}, contacts "
              f"{tuple(r['contacts'].shape)}, mean root travel "
              f"{r['root_travel']:.3f} m | {smi}")


# ---------------------------------------------------------------------------
# Phase 8: kinematic generation (parc_2) through the CLI
# ---------------------------------------------------------------------------


def source_loss(model, terrain, frames, contacts, cfg, constraints=None):
    """The summed loss a contact optimization starts from: motion_opt_loss
    at the source frames, with the constraints the optimizer would
    estimate itself."""
    from parc_torch.opt import motion_opt
    f = torch.as_tensor(frames, dtype=torch.float32, device=model.device)
    c = torch.as_tensor(contacts, dtype=torch.float32, device=model.device)
    if constraints is None and cfg.auto_body_constraints \
            and cfg.w_body_constraint > 0:
        constraints = motion_opt.compute_approx_body_constraints(
            model, terrain, f, c, cfg)
    with torch.no_grad():
        total, _ = motion_opt.motion_opt_loss(model, cfg, terrain, f, f, c,
                                              constraints)
    return float(total)


@contextlib.contextmanager
def kin_gen_probes(device):
    """Count and time what kin-gen runs, by wrapping module functions for
    the duration (restored on exit): MDM windows (gen_mdm_motion: calls,
    rows, and the denoiser calls the MDM counts), native A* plans (ms
    each), the rollout batches' results and the contact optimizations
    (seconds, iterations, the loss summed over the clips at the source
    frames and at the result)."""
    from parc_torch.opt import motion_opt
    from parc_torch.procgen import astar, mdm_path
    rec = dict(windows=0, rows=0, denoise=0, astar_ms=[], results=[],
               opt=[])
    saved = []

    def patch(obj, name, make):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, make(getattr(obj, name)))

    def window(orig):
        def run(mdm, state, generator, prev_frames34, *a, **kw):
            rec["windows"] += 1
            rec["rows"] += prev_frames34.shape[0]
            calls = mdm.denoise_calls
            out = orig(mdm, state, generator, prev_frames34, *a, **kw)
            rec["denoise"] += mdm.denoise_calls - calls
            return out
        return run

    def plan(orig):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            rec["astar_ms"].append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    def rollouts(orig):
        def run(*a, **kw):
            out = orig(*a, **kw)
            rec["results"].extend(out if isinstance(out, list) else [out])
            return out
        return run

    def timed_opt(fn, cfg, before):
        profiling.sync(device)
        t0 = time.perf_counter()
        out = fn()
        profiling.sync(device)
        clips = out if isinstance(out, list) else [out]
        rec["opt"].append(dict(
            s=time.perf_counter() - t0, iters=cfg.iters, clips=len(clips),
            before=before,
            after=sum(sum(losses.values()) for _, losses in clips)))
        return out

    def optimize_one(orig):
        def run(model, terrain, frames, contacts,
                cfg=motion_opt.MotionOptConfig(), constraints=None):
            before = source_loss(model, terrain, frames, contacts, cfg,
                                 constraints)
            return timed_opt(lambda: orig(model, terrain, frames, contacts,
                                          cfg, constraints), cfg, before)
        return run

    def optimize_many(orig):
        def run(model, terrains, frames, contacts,
                cfg=motion_opt.MotionOptConfig(), pad_to=None):
            before = sum(source_loss(model, *clip, cfg)
                         for clip in zip(terrains, frames, contacts))
            return timed_opt(lambda: orig(model, terrains, frames, contacts,
                                          cfg, pad_to), cfg, before)
        return run

    patch(gen_lib, "gen_mdm_motion", window)
    patch(astar, "native_astar", plan)
    patch(mdm_path, "generate_frames_multi", rollouts)
    patch(mdm_path, "generate_frames_along_path", rollouts)
    patch(motion_opt, "motion_contact_optimization_batched", optimize_many)
    patch(motion_opt, "motion_contact_optimization", optimize_one)
    try:
        yield rec
    finally:
        for obj, name, orig in reversed(saved):
            setattr(obj, name, orig)


def run_kin_gen(t, device, name, motions, terrains_per_batch, seconds,
                opt_iters):
    """One kin_gen through the CLI from phase 7's checkpoint on phase 5's
    dataset at KinGenConfig() width, the keep thresholds at infinity."""
    out = WORK / "gen" / name
    shutil.rmtree(out, ignore_errors=True)
    config = WORK / f"{name}.yaml"
    config.write_text(yaml.safe_dump(dict(
        max_contact_loss=float("inf"), max_pen_loss=float("inf"),
        max_total_loss=float("inf"), terrains_per_batch=terrains_per_batch,
        path_cfg=dict(max_seconds=seconds),
        opt_cfg=dict(iters=opt_iters))))
    sub.control_step_packed.launches = 0
    with kin_gen_probes(device) as rec:
        t0 = time.perf_counter()
        paths = cli.main(["kin_gen", "--dataset", t["dataset"], "--mdm_dir",
                          str(WORK / "mdm"), "--out_dir", str(out), "-n",
                          str(motions), "--config", str(config)])
        profiling.sync(device)
        rec["s"] = time.perf_counter() - t0
    rec["launches"] = sub.control_step_packed.launches
    rec["paths"] = paths
    steps = len(range(0, MDMConfig().diffusion_timesteps, 5))  # DDIM
    kc = KinGenConfig()
    rec["expect_denoise"] = rec["windows"] * steps
    rec["default_kept"] = sum(int(np.sum(
        (r.contact_loss < kc.max_contact_loss) & (r.pen_loss < kc.max_pen_loss)
        & (r.total_loss < kc.max_total_loss))) for r in rec["results"])
    rec["rollouts"] = sum(len(r.total_loss) for r in rec["results"])
    expect_clips = motions * kc.top_k * 2
    if len(paths) != expect_clips:
        raise AssertionError(f"kin_gen {name}: {len(paths)} clips, expected "
                             f"{expect_clips} (top-{kc.top_k} + mirrors)")
    if rec["denoise"] != rec["expect_denoise"]:
        raise AssertionError(f"kin_gen {name}: {rec['denoise']} denoiser "
                             f"calls for {rec['windows']} windows, expected "
                             f"{rec['expect_denoise']}")
    if rec["launches"] != 0:
        raise AssertionError(f"kin_gen launched the physics kernel "
                             f"{rec['launches']} times")
    for o in rec["opt"]:
        if not (np.isfinite(o["before"]) and np.isfinite(o["after"])
                and o["after"] <= o["before"]):
            raise AssertionError(f"kin_gen {name}: contact optimization "
                                 f"loss {o['before']} -> {o['after']}")
    for p in paths:
        clip = md.load_motion_data(p)
        if not (np.isfinite(clip.frames).all() and clip.frames.shape[1] == 34
                and clip.terrain is not None
                and clip.terrain.hf_mask is not None):
            raise AssertionError(f"kin_gen {name}: bad clip {p}")
    return rec


def chain_stages(t, device, clips):
    """Phase 8c: optimize two of 8a's clips, augment, setup_iter, and
    create_dataset over every output, each clip reloaded and held against
    what its stage saved."""
    src = WORK / "gen" / "opt_in"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for p in clips[:2]:
        shutil.copy(p, src)
    config = WORK / "chain.yaml"
    config.write_text(yaml.safe_dump(dict(
        iters=OPT_ITERS, max_contact_loss=float("inf"),
        max_pen_loss=float("inf"), max_total_loss=float("inf"),
        opt_cfg=dict(iters=AUG_ITERS, auto_body_constraints=False))))
    out = {}
    with kin_gen_probes(device) as rec:
        t0 = time.perf_counter()
        opt = cli.main(["optimize", "--motions_dir", str(src), "--out_dir",
                        str(WORK / "gen" / "opt"), "--config", str(config)])
        out["optimize_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        aug = cli.main(["augment", "--motions_dir", str(src), "--out_dir",
                        str(WORK / "gen" / "aug"), "-n", str(AUG_MOTIONS),
                        "--config", str(config)])
        out["augment_s"] = time.perf_counter() - t0
    shutil.rmtree(src)
    if (len(opt), len(aug)) != (2, AUG_MOTIONS):
        raise AssertionError(f"optimize wrote {len(opt)}, augment "
                             f"{len(aug)} clips")
    iters = [o["iters"] for o in rec["opt"]]
    if iters != [OPT_ITERS] * 2 + [AUG_ITERS] * AUG_MOTIONS:
        raise AssertionError(f"optimizer iterations {iters}")
    for o in rec["opt"]:
        if not (np.isfinite(o["before"]) and np.isfinite(o["after"])
                and o["after"] <= o["before"]):
            raise AssertionError(f"optimize/augment loss {o['before']} -> "
                                 f"{o['after']}")
    configs = cli.main(["setup_iter", "--root", str(ITER_ROOT), "--iter",
                        "0"])
    for name, path in configs.items():
        with open(path) as f:
            if yaml.safe_load(f).get("device") != str(device):
                raise AssertionError(f"setup_iter {name}: {path}")
    saved = {p: clip_arrays(p)
             for p in glob.glob(str(WORK / "gen" / "*" / "*.npz"))}
    t0 = time.perf_counter()
    cli.main(["create_dataset", "--motions_dir", str(WORK / "gen"), "--out",
              str(WORK / "gen.yaml"), "--config", str(config)])
    out["dataset_s"] = time.perf_counter() - t0
    files = listed_as_saved(str(WORK / "gen.yaml"), saved, "phase 8c")
    out.update(opt=rec["opt"], clips=len(files), classes=sorted(
        {Path(f).parent.name for f in files}))
    return out


def clip_arrays(path):
    """What a stage saved of a clip: frames, contacts, terrain and its
    min point."""
    c = md.load_motion_data(str(path))
    return c.frames, c.contacts, c.terrain.hf, c.terrain.min_point


def listed_as_saved(dataset, saved, what):
    """The clip files a manifest lists, gated: exactly the clips of
    ``saved`` ({path: clip_arrays}), each reloading equal to what was
    saved."""
    saved = {str(Path(p).resolve()): v for p, v in saved.items()}
    files = [str(Path(f).resolve()) for f in dataset_files(dataset)]
    if sorted(files) != sorted(saved):
        raise AssertionError(f"{what}: create_dataset listed {len(files)} of "
                             f"{len(saved)} clips")
    for f in files:
        if not all(np.array_equal(a, b)
                   for a, b in zip(clip_arrays(f), saved[f])):
            raise AssertionError(f"{what}: {f} reloads unlike what was "
                                 f"saved")
    return files


@contextlib.contextmanager
def local_hf_hook(replace):
    """Wraps gen.sample_local_hf for the duration: each call's own result
    is appended to the list this yields, and ``replace(i, own)`` gives
    what the i-th call returns."""
    orig, seen = gen_lib.sample_local_hf, []

    def run(*a, **kw):
        seen.append(orig(*a, **kw))
        return replace(len(seen) - 1, seen[-1])
    gen_lib.sample_local_hf = run
    try:
        yield seen
    finally:
        gen_lib.sample_local_hf = orig


def card_vs_cpu(device, clip_path):
    """Phase 8d: f32 (bf16 off) on the card against the CPU, from phase 7's
    checkpoint: one window of generate_frames_along_path with explicit
    draws along a kin-gen path over its box terrain, the card's window
    given the CPU's local heightfield (a nearest-cell lookup moves a whole
    cell when a rotated sample point lands within rounding of a cell edge,
    so the count of the card's own cells that differ is reported apart);
    one motion-opt loss and its gradient on one of 8a's clips."""
    from parc_torch.opt import motion_opt
    from parc_torch.pipeline import kin_gen
    from parc_torch.procgen import mdm_path
    g = torch.Generator().manual_seed(8)
    cfg = mdm_path.PathGenSettings(batch_size=KIN_CHECK_ROWS,
                                   max_seconds=0.4)  # one window
    noise = torch.randn((KIN_CHECK_ROWS, 15, 91), generator=g)
    root_u = torch.rand((), generator=g)
    runs = []  # the CPU's, then the card's
    for dev in (torch.device("cpu"), device):
        model = humanoid_spec().build(device=dev)
        mdm = MDM(model, MDMConfig(bf16_compute=False), device=dev)
        lib = dataset_lib.load_dataset(model, str(WORK / "dataset.yaml"),
                                       device=dev)
        state = mdm.merge_persistent(
            mdm.init(lib, torch.Generator(device=dev).manual_seed(1),
                     stats_samples=64),
            ckpt_lib.restore(str(WORK / "mdm" / "checkpoints"),
                             map_location=dev))
        boxes, _, nodes = kin_gen._draw_terrain_and_path(
            KinGenConfig(), np.random.default_rng(KIN_CHECK_SEED), dev)
        cpu_hf = runs[0]["local_hf"] if runs else None
        with local_hf_hook(lambda i, own: own if cpu_hf is None
                           else cpu_hf[i].to(dev)) as local_hf:
            frames = mdm_path.generate_frames_along_path(
                mdm, state, boxes, nodes, None, None, None, cfg,
                draws=mdm_path.PathDraws(root_u=root_u,
                                         noise=[noise.to(dev)])).frames34
        run = dict(frames=frames, local_hf=[h.cpu() for h in local_hf])
        clip = md.load_motion_data(clip_path)
        x = torch.as_tensor(clip.frames, device=dev).requires_grad_(True)
        ocfg = motion_opt.MotionOptConfig()
        ter = clip.terrain.to_device(dev)
        bc = motion_opt.compute_approx_body_constraints(
            model, ter, clip.frames, clip.contacts, ocfg)
        total, terms = motion_opt.motion_opt_loss(
            model, ocfg, ter, x, torch.as_tensor(clip.frames, device=dev),
            torch.as_tensor(clip.contacts, device=dev), bc)
        total.backward()
        run.update(total=total.item(),
                   terms={k: v.item() for k, v in terms.items()},
                   grad=x.grad.cpu().numpy())
        runs.append(run)
    b, a = runs
    if len(a["local_hf"]) != len(b["local_hf"]) or not b["local_hf"]:
        raise AssertionError("phase 8d: the windows sampled "
                             f"{len(a['local_hf'])} and "
                             f"{len(b['local_hf'])} local heightfields")

    def rel(key):
        return float(np.abs(a[key] - b[key]).max() / np.abs(b[key]).max())
    out = dict(frames_err=rel("frames"), grad_err=rel("grad"),
               hf_cells=sum(int(torch.sum(x != y)) for x, y in
                            zip(a["local_hf"], b["local_hf"])),
               hf_total=sum(y.numel() for y in b["local_hf"]),
               hf_moved=max(float(torch.abs(x - y).max()) for x, y in
                            zip(a["local_hf"], b["local_hf"])))
    out["terms_err"] = max(abs(a["terms"][k] - b["terms"][k])
                           for k in b["terms"]) / abs(b["total"])
    for key, tol in (("frames_err", KIN_FRAMES_TOL),
                     ("terms_err", OPT_TERMS_TOL),
                     ("grad_err", OPT_GRAD_TOL)):
        if not out[key] <= tol:
            raise AssertionError(f"phase 8d: card vs CPU {key} {out[key]} "
                                 f"above {tol}")
    return out


def idle_shares(device, clip_paths):
    """Phase 8e: the device's idle share of one MDM window of 64 rows (a
    batched kin-gen's) and of an Adam iteration of the batched contact
    optimization on 8a's first two clips (a 20-iteration run less a
    0-iteration one, which estimates the constraints only), each from the
    host's wall clock of an unprofiled run against the device's busy time
    in a profiler trace of the next."""
    from parc_torch.opt import motion_opt
    from parc_torch.pipeline import kin_gen
    from parc_torch.procgen import mdm_path
    model = humanoid_spec().build(device=device)
    mdm = MDM(model, MDMConfig(), device=device)
    lib = dataset_lib.load_dataset(model, str(WORK / "dataset.yaml"),
                                   device=device)
    state = mdm.merge_persistent(
        mdm.init(lib, torch.Generator(device=device).manual_seed(1),
                 stats_samples=64),
        ckpt_lib.restore(str(WORK / "mdm" / "checkpoints"),
                         map_location=device))
    drawn = [kin_gen._draw_terrain_and_path(
        KinGenConfig(), np.random.default_rng(s), device)
        for s in (KIN_CHECK_SEED, KIN_CHECK_SEED + 1)]
    g = torch.Generator(device=device).manual_seed(9)
    cfg = mdm_path.PathGenSettings(max_seconds=0.4)  # one window, 64 rows
    clips = [md.load_motion_data(p) for p in clip_paths[:2]]
    wall = {}

    def timed(name, fn):
        def run():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.setdefault(name, time.perf_counter() - t0)
        return run

    def window():
        mdm_path.generate_frames_multi(
            mdm, state, [d[0] for d in drawn], [d[2] for d in drawn], g, cfg)

    def adam(iters):
        def run():
            motion_opt.motion_contact_optimization_batched(
                model, [c.terrain.to_device(device) for c in clips],
                [c.frames for c in clips], [c.contacts for c in clips],
                motion_opt.MotionOptConfig(iters=iters))
        return run

    busy = {name: device_busy_ms(timed(name, fn), 1)
            for name, fn in (("window", window), ("adam20", adam(20)),
                             ("adam0", adam(0)))}
    out = {"window": dict(wall_ms=1e3 * wall["window"],
                          busy_ms=busy["window"])}
    out["adam"] = dict(
        wall_ms=1e3 * (wall["adam20"] - wall["adam0"]) / 20,
        busy_ms=(None if busy["adam20"] is None or busy["adam0"] is None
                 else (busy["adam20"] - busy["adam0"]) / 20))
    return out


def kin_gen_phase(t, device, smi):
    """Phase 8: kin-gen and the stages that share its modules, on the
    card."""
    from parc_torch import cuda_build
    t0 = time.perf_counter()
    cuda_build.load_host("astar", ("astar.cpp",))  # the planner's g++ build
    astar_build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    a = run_kin_gen(t, device, "kin", KIN_MOTIONS, KIN_TERRAINS_PER_BATCH,
                    KIN_SECONDS, KIN_OPT_ITERS)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    b = run_kin_gen(t, device, "kin_seq", 1, 1, KIN_SEQ_SECONDS,
                    KIN_SEQ_OPT_ITERS)
    for (phase, mode), r in ((("8a", "batched"), a),
                             (("8b", "sequential"), b)):
        gen_s = r["s"] - sum(o["s"] for o in r["opt"])
        frames = r["rows"] * 15
        opt = r["opt"]
        adam_ms = (1e3 * sum(o["s"] for o in opt)
                   / max(sum(o["iters"] for o in opt), 1))
        print(f"phase {phase}: kin_gen through the CLI ({mode}, "
              f"KinGenConfig(): {KinGenConfig().num_rollouts} rollouts a "
              f"terrain, {2 * KinGenConfig().terrain_dim} x "
              f"{2 * KinGenConfig().terrain_dim} cells): "
              f"{len(r['paths'])} clips in {r['s']:.1f} s "
              f"({r['s'] / (KIN_MOTIONS if r is a else 1):.1f} s a motion "
              f"slot); {r['windows']} windows, {r['rows']} rows "
              f"({r['rows'] // max(r['windows'], 1)} a window), "
              f"{frames / gen_s:.1f} frames generated per second over "
              f"{gen_s:.1f} s of generation; {r['denoise']} denoiser calls "
              f"(= windows x {r['expect_denoise'] // max(r['windows'], 1)}); "
              f"A* {len(r['astar_ms'])} plans, "
              f"{np.mean(r['astar_ms']):.2f} ms each (native"
              + (f", built with g++ in {astar_build_s:.1f} s before"
                 if r is a else "") + "); contact "
              f"optimization {len(opt)} runs, "
              + ", ".join(f"{o['clips']} clips x {o['iters']} iterations "
                          f"{o['s']:.2f} s, loss {o['before']:.4g} -> "
                          f"{o['after']:.4g}" for o in opt)
              + f" ({adam_ms:.2f} ms per Adam iteration); the default "
              f"thresholds would keep {r['default_kept']} of "
              f"{r['rollouts']} rollouts; physics launches {r['launches']}"
              + (f"; peak device memory {peak_gb:.2f} GB" if r is a else "")
              + f" | {smi}")
    c = chain_stages(t, device, a["paths"])
    print(f"phase 8c: optimize 2 clips x {OPT_ITERS} iterations in "
          f"{c['optimize_s']:.1f} s, augment {AUG_MOTIONS} clips x "
          f"{AUG_ITERS} iterations in {c['augment_s']:.1f} s ("
          + ", ".join(f"{o['iters']} it {1e3 * o['s'] / o['iters']:.2f} ms "
                      f"each, loss {o['before']:.4g} -> {o['after']:.4g}"
                      for o in c["opt"])
          + f"); setup_iter wrote 5 configs; create_dataset over "
          f"{c['classes']} listed {c['clips']} clips in {c['dataset_s']:.1f}"
          f" s, each reloaded equal to what its stage saved | {smi}")
    d = card_vs_cpu(device, a["paths"][0])
    print(f"phase 8d: card vs CPU, f32 (bf16 off): one window of "
          f"{KIN_CHECK_ROWS} rows over a kin-gen box terrain, both given the "
          f"CPU's local heightfield, frames relative max error "
          f"{d['frames_err']:.3e} (gate {KIN_FRAMES_TOL}); the card's own "
          f"nearest-cell lookup differs in {d['hf_cells']} of "
          f"{d['hf_total']} cells (by up to {d['hf_moved']:.3g} m, not "
          f"gated); motion-opt loss terms {d['terms_err']:.3e} of the total "
          f"(gate {OPT_TERMS_TOL}), gradient {d['grad_err']:.3e} of its "
          f"largest (gate {OPT_GRAD_TOL}) | {smi}")
    e = idle_shares(device, a["paths"])
    print("phase 8e: " + "; ".join(
        f"{name} {r['wall_ms']:.1f} ms wall, device busy "
        + ("not measured (no device time in the trace)"
           if r["busy_ms"] is None else
           f"{r['busy_ms']:.1f} ms, idle share "
           f"{1.0 - r['busy_ms'] / r['wall_ms']:.3f}")
        for name, r in (("one window of 64 rows", e["window"]),
                        ("an Adam iteration on 2 clips (20 iterations less "
                         "0)", e["adam"])))
          + f" | {smi}")
    return a

# ---------------------------------------------------------------------------
# Phase 9: the parkour env (dm + mgdm rows, in-step MDM replans)
# ---------------------------------------------------------------------------


def parkour_config():
    """Phase 9's config YAML: the parkour env at PARKOUR_MGDM mgdm rows,
    ParkourConfig() and MDMConfig() otherwise; the test rollout and eval
    cut to PARKOUR_TEST_STEPS, record to one start fraction."""
    path = WORK / "parkour.yaml"
    path.write_text(yaml.safe_dump(dict(
        env_name="parkour", mgdm_num=PARKOUR_MGDM,
        test_steps=PARKOUR_TEST_STEPS, start_fractions=[0.0])))
    return str(path)


def train_parkour(t, device):
    """Phase 9a: train_tracker --env_name parkour through the CLI at 4096
    envs from phase 7's MDM. Each train_iter is wrapped to count launches
    and time it, each replan to time it (synchronized before and after:
    wall and CUDA-event ms) and count its denoiser calls."""
    from parc_torch.envs.parkour import ParkourEnv
    out = WORK / "parkour_tracker"
    shutil.rmtree(out, ignore_errors=True)
    iters, replans, seen = [], [], {}
    train_iter, replan = PPOAgent.train_iter, ParkourEnv._replan

    def counted_iter(agent, lib, state, timer=None):
        n0, r0, t0 = (sub.control_step_packed.launches, len(replans),
                      time.perf_counter())
        out_ = train_iter(agent, lib, state, timer=timer)
        profiling.sync(device)
        iters.append(dict(launches=sub.control_step_packed.launches - n0,
                          wall_s=time.perf_counter() - t0,
                          replans=len(replans) - r0, metrics=out_[1]))
        seen.update(agent=agent, lib=lib, state=out_[0])
        return out_

    def timed_replan(env, mdm_state, state, draws):
        profiling.sync(device)
        calls, t0 = env.mdm.denoise_calls, time.perf_counter()
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
              if device.type == "cuda" else None)
        if ev:
            ev[0].record()
        new = replan(env, mdm_state, state, draws)
        if ev:
            ev[1].record()
        profiling.sync(device)
        replans.append(dict(
            wall_ms=1e3 * (time.perf_counter() - t0),
            event_ms=ev[0].elapsed_time(ev[1]) if ev else float("nan"),
            calls=env.mdm.denoise_calls - calls, rows=draws.noise.shape[0]))
        return new

    PPOAgent.train_iter, ParkourEnv._replan = counted_iter, timed_replan
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        sub.control_step_packed.launches = 0
        t0 = time.perf_counter()
        state = cli.main(["train_tracker", "--dataset", t["dataset"],
                          "--out_dir", str(out), "--mdm_dir",
                          str(WORK / "mdm"), "--num_envs", str(NUM_ENVS),
                          "--max_iters", str(TRAIN_ITERS), "--config",
                          parkour_config(), "--device", device.type])
        profiling.sync(device)
        train_s = time.perf_counter() - t0
        launches = sub.control_step_packed.launches
        peak_gb = (torch.cuda.max_memory_allocated(device) / 1e9
                   if device.type == "cuda" else float("nan"))
    finally:
        PPOAgent.train_iter, ParkourEnv._replan = train_iter, replan

    agent, bundle = seen["agent"], seen["lib"]
    env = agent.env
    steps = agent.cfg.steps_per_iter
    if not isinstance(env, ParkourEnv) or env.pcfg.mgdm_num != PARKOUR_MGDM:
        raise AssertionError(f"train_tracker built {type(env).__name__}, not "
                             f"the parkour env with {PARKOUR_MGDM} mgdm rows")
    if [it["launches"] for it in iters] != [steps] * TRAIN_ITERS:
        raise AssertionError(f"phase 9a: launches per train_iter "
                             f"{[it['launches'] for it in iters]}, expected "
                             f"{steps} each")
    expect_calls = len(range(0, env.mdm.rates.num_timesteps,
                             env.pcfg.ddim_stride))
    if not replans or any(r["calls"] != expect_calls or r["rows"]
                          != PARKOUR_MGDM for r in replans):
        raise AssertionError(f"phase 9a: replans {replans}: expected "
                             f"{expect_calls} denoiser calls on "
                             f"{PARKOUR_MGDM} rows each")
    for i, it in enumerate(iters):
        m = it["metrics"]
        for name in ("actor_loss", "critic_loss", "mean_reward"):
            if not torch.isfinite(getattr(m, name)).all():
                raise AssertionError(f"phase 9a: iteration {i + 1}: {name} "
                                     f"not finite")
    if float(state.sample_count) != TRAIN_ITERS * steps * NUM_ENVS:
        raise AssertionError(f"phase 9a: sample_count "
                             f"{float(state.sample_count)}")
    if ckpt_lib.all_steps(str(out / "checkpoints")) != [TRAIN_ITERS]:
        raise AssertionError("phase 9a: no checkpoint at step "
                             f"{TRAIN_ITERS}")
    fr = ckpt_lib.restore(str(out / "checkpoints"))["fail_rates"]
    if fr.shape != (bundle.num_motions,):
        raise AssertionError(f"phase 9a: fail rates {tuple(fr.shape)}, not "
                             f"one per motion and the terrain slot")
    train_replans = sum(it["replans"] for it in iters)
    return dict(iters=iters, replans=replans, expect_calls=expect_calls,
                launches=launches, train_s=train_s, peak_gb=peak_gb,
                test_replans=len(replans) - train_replans,
                test_launches=launches - steps * TRAIN_ITERS,
                agent=agent, bundle=bundle, state=seen["state"],
                tracker=str(out))


@torch.no_grad()
def parkour_steps(p, device):
    """Phase 9a's step timings and 9b: from the trained agent's last env
    state, a control step with a replan and one without (wall, synchronized;
    the replan's device busy time from a profiler trace), then the kernel
    against the plain version on PARKOUR_CHECKS successive control steps
    from the state after the replan, whose mgdm rows stand on the platform
    slot of the grown terrain stack."""
    agent, bundle, state = p["agent"], p["bundle"], p["state"]
    env = agent.env
    lib, mdm_state = env._unwrap(bundle)
    g = torch.Generator(device=device).manual_seed(9)
    es = state.env_state
    action = agent.act(state, es.obs)

    def step_ms(timer, reps=3):
        walls = []
        for _ in range(reps):
            s = dataclasses.replace(es, replan_timer=timer)
            profiling.sync(device)
            t0 = time.perf_counter()
            env.step(bundle, s, action, generator=g)
            profiling.sync(device)
            walls.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(walls))

    with_replan, without = step_ms(1), step_ms(10 ** 6)
    draws = env.draw_replan(g)
    t0 = time.perf_counter()
    env._replan(mdm_state, es, draws)
    profiling.sync(device)
    replan_wall = 1e3 * (time.perf_counter() - t0)
    busy = (device_busy_ms(lambda: env._replan(mdm_state, es, draws), 1)
            if device.type == "cuda" else None)
    after = env.step(bundle, dataclasses.replace(es, replan_timer=1), action,
                     generator=g)
    slot = lib.num_motions - 1
    if not bool((after.motion_ids[env.n_dm:] == slot).all()):
        raise AssertionError("phase 9b: mgdm rows not on the terrain slot")
    checks = []
    for _ in range(PARKOUR_CHECKS):
        act = agent.act(state, after.obs)
        checks.append(step_vs_plain(env.model, env, lib, after, act))
        after = env.step(bundle, after, act, generator=g)
    return dict(step_replan_ms=with_replan, step_ms=without,
                replan_wall_ms=replan_wall, replan_busy_ms=busy,
                stack=tuple(lib.terrain_hf.shape), slot=slot, checks=checks)


def vision_policies(p, device):
    """Phase 9c: one train_iter each of the two vision policies on the
    parkour env at 4096 envs (bf16 trunks on the card), the ms of an act
    call, and a forward pass in bf16 against f32 on the same input."""
    from parc_torch.learning import normalizer as norm_lib
    env, bundle = p["agent"].env, p["bundle"]
    out = {}
    for name in ("dm_cnn_mlp", "dm_vit"):
        agent = PPOAgent(env, PPOConfig(actor_net=name), device=device)
        state = agent.init(bundle, torch.Generator(device=device)
                           .manual_seed(3))
        n0, t0 = sub.control_step_packed.launches, time.perf_counter()
        state, m = agent.train_iter(bundle, state)
        profiling.sync(device)
        wall = time.perf_counter() - t0
        launches = sub.control_step_packed.launches - n0
        if launches != agent.cfg.steps_per_iter:
            raise AssertionError(f"phase 9c {name}: {launches} launches in "
                                 f"a train_iter")
        for k in ("actor_loss", "critic_loss", "mean_reward"):
            if not torch.isfinite(getattr(m, k)).all():
                raise AssertionError(f"phase 9c {name}: {k} not finite")
        obs = state.env_state.obs
        act_ms = (cuda_ms(lambda: agent.act(state, obs), 10)
                  if device.type == "cuda" else float("nan"))
        with torch.no_grad():
            x = norm_lib.normalize(state.obs_norm, obs)
            low = agent.net(x)
            dtype, agent.net.compute_dtype = agent.net.compute_dtype, None
            full = agent.net(x)
            agent.net.compute_dtype = dtype
        err = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in ((low[0], full[0]), (low[2], full[2])))
        if device.type == "cuda" and not 0.0 < err < MDM_BF16_TOL:
            raise AssertionError(f"phase 9c {name}: bf16 vs f32 relative "
                                 f"max error {err:.3e} outside (0, "
                                 f"{MDM_BF16_TOL})")
        out[name] = dict(
            wall_s=wall, launches=launches, act_ms=act_ms, bf16_err=err,
            params=sum(q.numel() for q in agent.net.parameters()),
            critic_loss=m.critic_loss.item(), reward=m.mean_reward.item())
    return out


def parkour_record_eval(p, t, device):
    """Phase 9d: record (one env per clip, one start fraction) and eval at
    EVAL_ENVS envs from 9a's checkpoint with the parkour config: both must
    build the deepmimic env with SimParams()."""
    built, tracking_env = [], cli._tracking_env

    def spy(*args, **kwargs):
        built.append(tracking_env(*args, **kwargs))
        return built[-1]
    cli._tracking_env = spy
    common = ["--dataset", t["dataset"], "--tracker_dir", p["tracker"],
              "--config", parkour_config(), "--device", device.type]
    try:
        sub.control_step_packed.launches = 0
        t0 = time.perf_counter()
        results = cli.main(["record", "--out_dir",
                            str(WORK / "parkour_recorded")] + common)
        profiling.sync(device)
        record_s = time.perf_counter() - t0
        record_launches = sub.control_step_packed.launches
        sub.control_step_packed.launches = 0
        t0 = time.perf_counter()
        test, _ = cli.main(["eval", "--num_envs", str(EVAL_ENVS)] + common)
        profiling.sync(device)
        eval_s = time.perf_counter() - t0
        eval_launches = sub.control_step_packed.launches
    finally:
        cli._tracking_env = tracking_env
    for env in built:
        if (type(env) is not DeepMimicEnv
                or env.sim_params != engine.SimParams()):
            raise AssertionError(f"phase 9d: record/eval built "
                                 f"{type(env).__name__} with "
                                 f"{env.sim_params}")
    if len(built) != 2 or built[0].cfg.num_envs != len(results):
        raise AssertionError("phase 9d: record and eval envs not as asked")
    lib = ml.load_motion_lib(humanoid_spec().build(device="cpu"),
                             dataset_files(t["dataset"]), device="cpu")
    per_round = record.round_steps(lib, record.RecordConfig().max_steps)
    if record_launches != per_round:
        raise AssertionError(f"phase 9d: record launched {record_launches} "
                             f"times, not one {per_round}-step round")
    if eval_launches != int(test["test_steps"]):
        raise AssertionError(f"phase 9d: eval {eval_launches} launches over "
                             f"{int(test['test_steps'])} steps")
    return dict(recorded=sum(c is not None for c in results),
                motions=len(results), record_s=record_s,
                record_launches=record_launches, eval_s=eval_s,
                eval_launches=eval_launches,
                test_reward=float(test["mean_reward"]))


def parkour_phase(t, device, smi):
    """Phase 9: the parkour env through the CLI, its kernel check, the
    vision policies, and record/eval of a parkour tracker."""
    p = train_parkour(t, device)
    for i, it in enumerate(p["iters"]):
        print(f"phase 9a: iteration {i + 1}: {it['wall_s']:.3f} s, "
              f"{PPOConfig().steps_per_iter * NUM_ENVS / it['wall_s']:.1f} "
              f"samples/s, {it['replans']} replans, control-step launches "
              f"{it['launches']} | {smi}")
    walls = [r["wall_ms"] for r in p["replans"]]
    events = [r["event_ms"] for r in p["replans"]]
    print(f"phase 9a: train_tracker --env_name parkour through the CLI: "
          f"{NUM_ENVS} envs ({PARKOUR_MGDM} mgdm rows, ParkourConfig(): "
          f"{p['expect_calls']} DDIM steps a replan at MDMConfig() width), "
          f"PPOConfig(), {TRAIN_ITERS} iterations in {p['train_s']:.1f} s; "
          f"{len(walls)} replans ({p['test_replans']} in the test rollout, "
          f"{p['test_launches']} test steps), each {min(walls):.1f}-"
          f"{max(walls):.1f} ms wall (median {np.median(walls):.1f}), "
          f"{min(events):.1f}-{max(events):.1f} ms by CUDA events; "
          f"{p['launches']} launches; peak device memory "
          f"{p['peak_gb']:.2f} GB | {smi}")
    s = parkour_steps(p, device)
    busy = s["replan_busy_ms"]
    print(f"phase 9a: a control step {s['step_replan_ms']:.1f} ms with a "
          f"replan, {s['step_ms']:.1f} ms without (wall, median of 3); a "
          f"replan {s['replan_wall_ms']:.1f} ms wall, device busy "
          + ("not measured (no device time in the trace)" if busy is None
             else f"{busy:.1f} ms, idle share "
             f"{1.0 - busy / s['replan_wall_ms']:.3f}") + f" | {smi}")
    for i, c in enumerate(s["checks"]):
        ratio = f64_ratio(c)
        print(f"phase 9b: parkour env {i} control steps after a replan "
              f"({NUM_ENVS} envs, terrain stack "
              f"{s['stack']}, mgdm rows on slot {s['slot']}): kernel vs "
              f"plain control step "
              + ", ".join(f"{f} {v:.1e}" for f, v in c["step_err"].items())
              + f"; the kernel's float64 error on the state {ratio[0]:.2f}x "
              f"the plain version's in the worst env, {ratio[1]:.2f}x the "
              f"card's at the envs' 99.9th percentile; max|contact| "
              f"{c['max_contact']:.1f} N | {smi}")
    for i, c in enumerate(s["checks"]):
        c["tol"] = judge(c, f"phase 9b parkour control step {i} "
                                 f"steps after a replan")
    lims = [c["limits"] for c in s["checks"]]

    def most(rule):
        return [max(x[rule][i] for x in lims) for i in range(4)]
    print(f"phase 9b: all {PARKOUR_CHECKS} within phase 3's judge; the "
          f"largest limits over the steps {limits_text(most('new'))} "
          f"(state / contact), the old rule's {limits_text(most('old'))}; "
          f"every env but those taken out, excused or not rerun within "
          f"{limits_text(most('held'))}; "
          f"{sum(len(x['out']) for x in lims)} plain env(s) taken out, "
          f"{sum(bool(x['left']) for x in lims)} step(s) at the cap | {smi}")
    v = vision_policies(p, device)
    for name, r in v.items():
        print(f"phase 9c: {name} ({r['params']} parameters, bf16 trunk): "
              f"one train_iter at {NUM_ENVS} envs in {r['wall_s']:.2f} s "
              f"({r['launches']} launches; critic loss "
              f"{r['critic_loss']:.4g}, mean reward {r['reward']:.4f}); act "
              f"{r['act_ms']:.3f} ms (CUDA events, 10 calls); bf16 vs f32 "
              f"relative max error {r['bf16_err']:.3e} (gate (0, "
              f"{MDM_BF16_TOL})) | {smi}")
    d = parkour_record_eval(p, t, device)
    print(f"phase 9d: record from the parkour checkpoint (deepmimic env, "
          f"SimParams()): recorded {d['recorded']}/{d['motions']} in "
          f"{d['record_s']:.1f} s, {d['record_launches']} steps; eval at "
          f"{EVAL_ENVS} envs: {d['eval_launches']} steps in "
          f"{d['eval_s']:.1f} s, test reward {d['test_reward']:.4f} "
          f"| {smi}")
    return p


# ---------------------------------------------------------------------------
# phase 3g: the second character
# ---------------------------------------------------------------------------

# contact parameters scaled to the ~11 kg quadruped (tests/test_physics.py:
# 246-249)
QUAD_ROBOT = dict(contact_stiffness=2500.0, contact_damping=100.0,
                  max_contact_force=400.0)
QUAD_STAND_STEPS, QUAD_COLLAPSE_STEPS = 30, 45
# the input seeds of 3g's kernel-vs-plain check; the first is also timed
QUAD_SEEDS = (3, 4, 5, 6, 7, 8)


def bumpy_terrain(g, device):
    """Two stacked 16 x 16 heightfields of 0.4 m cells with bumps of up to
    8 cm (tests/test_torch_substep_host.py), drawn from the CPU generator
    ``g``."""
    return terrain_lib.stack_terrains([
        Terrain(hf=0.08 * torch.rand((16, 16), generator=g).to(device),
                hf_mask=None, hf_maxmin=None,
                min_point=torch.tensor(mp, device=device),
                dxdy=torch.tensor([0.4, 0.4], device=device))
        for mp in ([-3.2, -3.2], [-3.0, -2.8])])


def quadruped_inputs(model, n, seed, device):
    """Packed state, PD targets and terrain index of n quadrupeds near the
    standing pose (seeded noise on the joints, every second env's knees
    past their upper limit), feet in a bumpy stacked terrain, noisy
    velocities, PD targets near the stand; and the terrain. Drawn on the
    CPU, so that a seed gives the same states on every machine (the host
    build of the kernel's math can replay them)."""
    g = torch.Generator().manual_seed(seed)

    def noise(scale, *shape):
        return scale * torch.randn(shape, generator=g).to(device)

    def unif(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g).to(device)
    stand = torch.as_tensor(standing_pose_dof(), device=device)
    nd = model.dof_size
    knee = ((torch.arange(n, device=device)[:, None] % 2 == 1)
            & (torch.arange(nd, device=device) % 3 == 2))
    dof = torch.where(knee, model.dof_limits_upper + unif(0.05, 0.3, n, nd),
                      stand + noise(0.15, n, nd))
    root_rot = noise(0.05, n, 4)
    root_rot[:, 3] = 1.0
    root_rot = root_rot / root_rot.norm(dim=-1, keepdim=True)
    root_pos = torch.cat([unif(-1.5, 1.5, n, 2), unif(0.26, 0.30, n, 1)],
                         dim=-1)
    st = engine.create_state(model, root_pos, root_rot,
                             cm.dof_to_rot(model, dof), noise(0.3, n, 3),
                             noise(0.3, n, 3), noise(1.0, n, nd),
                             device=device)
    act = stand + noise(0.1, n, nd)
    tidx = torch.randint(0, 2, (n,), generator=g,
                         dtype=torch.int32).to(device)
    terrain = bumpy_terrain(g, device)
    return (sub.pack(sub.state_layout(model), vars(st), n), act, tidx,
            terrain)


def check_quadruped(device):
    """Phase 3g: the quadruped (13 bodies, 12 hinge dofs) at 4096 envs.
    The kernel against the plain version in pd_implicit and pd_1d with the
    robot's contact parameters, on the states of each of QUAD_SEEDS (judged
    by quadruped_phase, as in phase 3); its time and bound; then the stand
    (30 control steps through engine.control_step on the kernel, root
    height within 0.2-0.45 m) and the passive collapse (45 steps without
    stiffness, below 0.2 m), the launches of which are the path's count."""
    model = quadruped_spec().build(device=device)
    n = NUM_ENVS
    model64, layout = as_f64(model), sub.state_layout(model)
    cases = []
    for seed, mode in itertools.product(QUAD_SEEDS, ("pd_implicit",
                                                     "pd_1d")):
        state_p, act, tidx, terrain = quadruped_inputs(model, n, seed,
                                                       device)
        terrain64 = terrain_f64(terrain)
        params = engine.SimParams(control_mode=mode, **QUAD_ROBOT)
        const_p = const_packed(model, mode, act)
        args = (model, params, terrain, state_p, const_p, tidx, 2)
        got, got_c = sub.control_step_packed(*args)
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.isfinite(got_c).all()):
            raise AssertionError(f"phase 3g: kernel output not finite "
                                 f"({mode}, seed {seed})")
        c, want, want_c = packed_check(args, got, got_c, model64, terrain64)
        c.update(mode=mode, seed=seed, max_contact=want_c.abs().max().item(),
                 errs={name: (sub.unpack(got, layout, name)
                              - sub.unpack(want, layout, name)).abs().max()
                       .item() for name, _ in layout.fields})
        cases.append(c)
    if max(c["max_contact"] for c in cases) < 20.0:
        raise AssertionError("phase 3g: the quadrupeds' feet are not in "
                             "contact")
    # time and bound of the mode the hinge-only character runs in
    state_p, act, tidx, terrain = quadruped_inputs(model, n, QUAD_SEEDS[0],
                                                   device)
    args = (model, engine.SimParams(control_mode="pd_1d", **QUAD_ROBOT),
            terrain, state_p, const_packed(model, "pd_1d", act), tidx, 2)
    call_ms = cuda_ms(lambda: sub.control_step_packed(*args), 200)
    ms = device_busy_ms(lambda: sub.control_step_packed(*args), 200,
                        "control_step_kernel")
    timed_by = "profiler"
    if ms is None:
        ms, timed_by = call_ms, "CUDA events"
    plain_ms = cuda_ms(lambda: sub.control_step_packed_reference(*args), 5)
    first = sub.control_step_packed(*args)
    hf, min_point, dxdy = sub.stacked_terrain(terrain)
    nbytes = 4 * (state_p.numel() + args[4].numel() + first[0].numel()
                  + first[1].numel() + tidx.numel() + hf.numel()
                  + min_point.numel() + dxdy.numel())
    nbytes += sum(t.numel() * 4 for t in sub.model_tables(model))
    ops = substep_operations(model) * 2 * args[1].substeps * n

    # the stand and the collapse: the path whose launches are counted
    flat = terrain_lib.create_terrain(64, 64, dx=0.4, min_x=-12.8,
                                      min_y=-12.8, device=device)
    dof = torch.as_tensor(standing_pose_dof(), device=device)
    st0 = engine.create_state(
        model, torch.tensor([0.0, 0.0, 0.32], device=device).expand(n, 3),
        torch.tensor([0.0, 0.0, 0.0, 1.0], device=device).expand(n, 4),
        cm.dof_to_rot(model, dof).expand(n, -1, -1), device=device)
    params = engine.SimParams(**QUAD_ROBOT)
    passive = model.replace(
        dof_stiffness=torch.zeros_like(model.dof_stiffness))
    sub.control_step_packed.launches = 0
    t0 = time.perf_counter()
    st = st0
    for _ in range(QUAD_STAND_STEPS):
        st = engine.control_step(model, params, flat, st, dof)
    stand_z = st.root_pos[:, 2]
    st = st0
    for _ in range(QUAD_COLLAPSE_STEPS):
        st = engine.control_step(passive, params, flat, st, dof)
    collapse_z = st.root_pos[:, 2]
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = sub.control_step_packed.launches
    if launches != QUAD_STAND_STEPS + QUAD_COLLAPSE_STEPS:
        raise AssertionError(f"phase 3g: {launches} launches over the stand "
                             f"and the collapse")
    if not (torch.isfinite(stand_z).all() and bool((stand_z > 0.2).all())
            and bool((stand_z < 0.45).all())):
        raise AssertionError(f"phase 3g: the quadruped did not stand: root "
                             f"z {stand_z.min().item()}-"
                             f"{stand_z.max().item()}")
    if not bool((collapse_z < 0.2).all()):
        raise AssertionError(f"phase 3g: the passive quadruped did not "
                             f"collapse: root z up to "
                             f"{collapse_z.max().item()}")
    return dict(cases=cases, ms=ms, timed_by=timed_by, call_ms=call_ms,
                plain_ms=plain_ms, bytes=nbytes, ops=ops, launches=launches,
                path_s=path_s, points=model.contact_point_body.shape[0],
                stand_z=(stand_z.min().item(), stand_z.max().item()),
                collapse_z=collapse_z.max().item(),
                max_abs_err=max(c["state_err"] for c in cases))


def quadruped_phase(device, smi):
    q = check_quadruped(device)
    for c in q["cases"]:
        ratio = f64_ratio(c)
        print(f"phase 3g: quadruped {c['mode']:11s} seed {c['seed']} 2x2 at "
              f"{NUM_ENVS} envs: max|kernel-plain| state "
              f"{c['state_err']:.3e}, contact {c['contact_err']:.3e} past "
              f"rtol; vs float64: kernel {c['kernel64_err']['state']:.2e} / "
              f"{c['kernel64_err']['contact']:.2e}, plain "
              f"{c['plain64_err']['state']:.2e} / "
              f"{c['plain64_err']['contact']:.2e} (card "
              f"{c['plain64_err']['card']['state']:.2e}, CPU "
              f"{c['plain64_err']['cpu']['state']:.2e} on the state): on the "
              f"state {ratio[0]:.2f}x in the worst env, {ratio[1]:.2f}x the "
              f"card's plain version at the envs' 99.9th percentile; "
              f"max|contact| "
              f"{c['max_contact']:.1f} N ("
              + ", ".join(f"{k} {v:.1e}" for k, v in c["errs"].items()) + ")")
    for c in q["cases"]:
        # the quadruped's states are less well conditioned in f32 than the
        # humanoid's (the plain version 8e-4-1.6e-3 off float64 in dof and
        # body angular velocities), and which f32 order lands nearer float64
        # in the single worst of 4096 envs swings with the mode and the
        # seed, while the two per-env error distributions agree up to their
        # 99.9th percentile; so the state gets the contact forces' 2x
        c["tol"] = judge(c, f"phase 3g quadruped {c['mode']} seed "
                            f"{c['seed']}", state_ratio=2.0)
    print(f"phase 3g: all {len(q['cases'])} cases within phase 3's judge "
          f"(tolerance state {max(c['tol'][0] for c in q['cases']):.1e} at "
          f"most)")
    bytes_s, ops_s = q["bytes"] / mem_rate(smi), q["ops"] / F32_RATE
    q["bound_ms"] = 1e3 * max(bytes_s, ops_s)
    q["bound_by"] = "bytes" if bytes_s >= ops_s else "operations"
    print(f"phase 3g: quadruped kernel {q['ms']:.4f} ms ({q['timed_by']}, "
          f"pd_1d, mean of 200 launches; {q['call_ms']:.4f} ms per wrapper "
          f"call), plain {q['plain_ms']:.3f} ms per control step at "
          f"{NUM_ENVS} envs (13 bodies, 12 dofs, {q['points']} contact "
          f"points); bound {q['bound_ms']:.4f} ms by {q['bound_by']} "
          f"({q['bytes']} B: {1e3 * bytes_s:.4f} ms; {q['ops']} f32 ops: "
          f"{1e3 * ops_s:.4f} ms); stand {QUAD_STAND_STEPS} steps: root z "
          f"{q['stand_z'][0]:.3f}-{q['stand_z'][1]:.3f} m; passive "
          f"{QUAD_COLLAPSE_STEPS} steps: root z at most "
          f"{q['collapse_z']:.3f} m; {q['launches']} launches in "
          f"{q['path_s']:.2f} s | {smi}")
    return q


# ---------------------------------------------------------------------------
# phase 10: data parallelism over torch.distributed
# ---------------------------------------------------------------------------

DP_RANKS, DP_ITERS = 2, 2
DP_DIR = WORK / "dp"
DP_DEVICE = "cuda:0"  # 10(a)-(b): every rank on the one card, over gloo
# 10(a): tests/test_torch_ppo.py's deterministic setup (its TRAIN_PPO) at
# PPOConfig()'s network widths: no random reset, no action noise, one
# minibatch an epoch, 4 steps an iteration (longer rollouts drift through
# contact switches: with 32, the second iteration's tracking error leaves
# the tolerance 10x over in a CPU rehearsal), in f32 (bf16 rounds each
# rank's weight gradients apart from the whole batch's)
DP_PPO = dict(steps_per_iter=4, reset_pool_k=1, update_epochs=2,
              batch_size=8, exp_prob_beg=0.0, exp_prob_end=0.0,
              bf16_compute=False)
# tests/test_torch_ppo.py's tolerances
DP_NORM_TOL, DP_FAIL_TOL, DP_TOL = 1e-5, 1e-6, 1e-4


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(cmd, timeout):
    """Run cmd in its own process group; on a timeout, kill the whole
    group (torchrun and its ranks) and fail."""
    import signal
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            cwd=Path(__file__).resolve().parent)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{' '.join(map(str, cmd))} ran past {timeout} s")
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(map(str, cmd))} failed "
                             f"({proc.returncode}):\n{out[-6000:]}\n"
                             f"{err[-6000:]}")
    return out


def torchrun(nproc, worker, timeout):
    """``python -m torch.distributed.run`` of this script's worker mode,
    ``nproc`` ranks on this host."""
    return run_group([sys.executable, "-m", "torch.distributed.run",
                      "--nproc_per_node", str(nproc), "--master_addr",
                      "127.0.0.1", "--master_port", str(free_port()),
                      str(Path(__file__).resolve()), "--dp-worker", *worker],
                     timeout)


def dp_env_agent(device):
    """10(a)'s agent: the humanoid tracking one standing clip at NUM_ENVS
    envs in all."""
    model = humanoid_spec().build(device=device)
    lib = ml.build_motion_lib(model, [standing_clip()], device=device)
    env = DeepMimicEnv(model, engine.SimParams(),
                       EnvConfig(num_envs=NUM_ENVS, rand_reset=False),
                       device=device)
    return PPOAgent(env, PPOConfig(**DP_PPO), device=device), lib


def to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return {f.name: to_cpu(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    return tree


def dp_single(device):
    """10(a)'s start (written for the ranks) and its one-process run:
    DP_ITERS train_iters at NUM_ENVS envs. The start is tests/
    test_torch_ppo.py's: the elbows' bias past the action bound (the bound
    loss drives the actor without noise), a normalizer that has seen 256
    spread samples."""
    from parc_torch.learning import normalizer as norm_lib
    from parc_torch.learning import ppo as ppo_lib
    agent, lib = dp_env_agent(device)
    g = torch.Generator(device=device).manual_seed(0)
    state = agent.init(lib, g)
    with torch.no_grad():
        agent.net.actor_head.bias[[9, 13]] = torch.tensor([1.1, -1.1],
                                                          device=device)
    obs0 = state.env_state.obs[:1]
    spread = (obs0 * (1.0 + 0.5 * torch.randn((256, obs0.shape[1]),
                                              generator=g, device=device))
              + torch.randn((256, obs0.shape[1]), generator=g,
                            device=device))
    state = state.replace(obs_norm=norm_lib.update(state.obs_norm, spread))
    start = ppo_lib.persistent_state(agent, state)
    DP_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(dict(start=to_cpu(start), env_state=state.env_state),
               DP_DIR / "start.pt")
    runs, state = dp_iterations(agent, lib, state, 1)
    # what dp_replay needs to run the second iteration again
    after1 = dict(env_state=state.env_state,
                  generator=state.generator.get_state())
    more, _ = dp_iterations(agent, lib, state, DP_ITERS - 1)
    return dict(start=to_cpu(start), runs=runs + more, after1=after1)


def dp_iterations(agent, lib, state, iters):
    """``iters`` train_iters of one process: each one's time, metrics,
    launches and persistent state after it; and the state after them."""
    from parc_torch.learning import ppo as ppo_lib
    runs = []
    for _ in range(iters):
        n0, t0 = sub.control_step_packed.launches, time.perf_counter()
        state, m = agent.train_iter(lib, state)
        profiling.sync(agent.device)
        runs.append(dict(wall_s=time.perf_counter() - t0, metrics=to_cpu(m),
                         launches=sub.control_step_packed.launches - n0,
                         state=to_cpu(ppo_lib.persistent_state(agent,
                                                               state))))
    return runs, state


def ranks_env(device, ranks):
    """The ranks' env states after their first iteration put back together
    (their fail rates are the same)."""
    def cat(parts):
        first = parts[0]
        return dataclasses.replace(first, **{
            f.name: (cat([getattr(p, f.name) for p in parts])
                     if dataclasses.is_dataclass(getattr(first, f.name))
                     else getattr(first, f.name).to(device)
                     if f.name == "fail_rates"
                     else torch.cat([getattr(p, f.name).to(device)
                                     for p in parts]))
            for f in dataclasses.fields(first)})
    return cat([r["env_after1"] for r in ranks])


def env_gap(a, b):
    """Largest difference of two env states' simulator states."""
    return max((getattr(a.sim, f.name).double()
                - getattr(b.sim, f.name).double()).abs().max().item()
               for f in dataclasses.fields(a.sim))


def dp_replay(device, single, ranks, move=0.0, their_env=False,
              their_norm=False):
    """Witnesses of what parts the ranks' free second iteration from the
    one process's (dp_compare): the one process's second iteration run
    again from its own state after its first (its env state, normalizer
    and generator), with each parameter and momentum entry moved by
    ``move`` times the ranks' gap from it after the first iteration, in
    random signs, and with the ranks' env state or normalizer in place of
    its own where ``their_env`` or ``their_norm``. With none of these it
    reruns the free iteration; ``move`` 1 moves the parameters by the
    rounding gap between a 2048-row and a 4096-row first iteration,
    pointed elsewhere. Its deviation from the free second iteration, as
    dp_deviation's shares of the tolerances."""
    from parc_torch.learning import ppo as ppo_lib
    agent, lib = dp_env_agent(device)
    state = agent.init(lib, torch.Generator(device=device).manual_seed(0))
    own, theirs = single["runs"][0]["state"], ranks[0]["runs"][0]["state"]
    g = torch.Generator().manual_seed(0)

    def moved(a, b):
        sign = 2.0 * torch.randint(0, 2, a.shape, generator=g) - 1.0
        return a + move * sign * (b - a).abs()
    start = dict(own, obs_norm=(theirs if their_norm else own)["obs_norm"],
                 params={k: moved(v, theirs["params"][k])
                         for k, v in own["params"].items()},
                 opt_state={"momentum": {
                     k: moved(v, theirs["opt_state"]["momentum"][k])
                     for k, v in own["opt_state"]["momentum"].items()}})
    state = state.replace(env_state=(ranks_env(device, ranks) if their_env
                                     else single["after1"]["env_state"]))
    state = ppo_lib.merge_persistent(agent, state, start)
    state.generator.set_state(single["after1"]["generator"])
    (run,), _ = dp_iterations(agent, lib, state, 1)
    want = single["runs"][1]
    return dp_deviation(run["state"], want["state"], run["metrics"],
                        want["metrics"], single["start"]["params"])


def dp_resume(device, ranks):
    """One process's second iteration from the ranks' state after their
    first: rank 0's persistent state (the ranks' are bit-identical) and
    the ranks' env blocks put back together."""
    from parc_torch.learning import ppo as ppo_lib
    agent, lib = dp_env_agent(device)
    state = agent.init(lib, torch.Generator(device=device).manual_seed(0))
    state = ppo_lib.merge_persistent(agent, state,
                                     ranks[0]["runs"][0]["state"])
    state = state.replace(env_state=ranks_env(device, ranks))
    return dp_iterations(agent, lib, state, 1)[0][0]


def dp_worker_a(backend):
    """One rank of 10(a) (or of 10(c) over NCCL, one rank a card): the
    start's block of this rank through make_sharded_train_iter."""
    from parc_torch.learning import ppo as ppo_lib
    from parc_torch.parallel import mesh
    info = mesh.init_distributed(
        backend=backend, device=DP_DEVICE if backend == "gloo" else None)
    group, rank, world, dev = (mesh.default_group(), info.rank,
                               info.world_size, info.device)
    if dev.type == "cuda":
        mesh.primary_first(group, sub.library)  # one nvcc at most
    inp = torch.load(DP_DIR / "start.pt", map_location=dev,
                     weights_only=False)
    agent, lib = dp_env_agent(dev)
    local = mesh.local_agent(agent, world)
    state = local.init(lib, mesh.rank_generator(0, rank, dev))
    agent.net = local.net
    state = ppo_lib.merge_persistent(local, state, inp["start"])
    state = state.replace(env_state=mesh.local_block(
        agent.env, inp["env_state"], rank, world))
    sync0 = mesh.check_param_sync(agent.net.parameters(), group)
    train_iter = mesh.make_sharded_train_iter(agent, group)
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    sub.control_step_packed.launches = 0
    for _ in range(DP_ITERS):
        n0, t0 = sub.control_step_packed.launches, time.perf_counter()
        state, m = train_iter(lib, state)
        profiling.sync(dev)
        runs.append(dict(wall_s=time.perf_counter() - t0, metrics=to_cpu(m),
                         launches=sub.control_step_packed.launches - n0,
                         state=to_cpu(ppo_lib.persistent_state(local,
                                                               state))))
        if len(runs) == 1:
            env_after1 = state.env_state
    sync = mesh.check_param_sync(agent.net.parameters(), group)
    es = state.env_state  # the kernel against the plain version at its shape
    check = rank_check(local.env, lib, state, local.act(state, es.obs),
                       f"phase 10a: rank {rank}'s control step at "
                       f"{es.done.shape[0]} envs")
    torch.save(dict(
        rank=rank, device=str(dev), backend=info.backend, runs=runs,
        env_after1=env_after1, check=check,
        envs=state.env_state.done.shape[0], sync0=sync0, sync=sync,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        allocated={i: torch.cuda.memory_allocated(i)
                   for i in range(torch.cuda.device_count())}),
        DP_DIR / f"a_{backend}_rank{rank}.pt")
    mesh.shutdown()


def rank_check(env, lib, state, action, what):
    """A rank's kernel-vs-plain control step of its own envs, judged in the
    rank (judge's float64 reruns need the rank's state): step_vs_plain's
    figures and judge's tolerances, for the parent to print."""
    es = state.env_state
    c = step_vs_plain(env.model, env, lib, es, action)
    c["tol"] = judge(c, what)
    return {k: v for k, v in c.items() if k not in ("rerun", "save")}


def dp_deviation(got, want, metrics, ref_metrics, start):
    """Each field of a ranks' persistent state and metrics against the one
    process's, as a share of its tolerance (tests/test_torch_ppo.py's:
    the normalizer 1e-5, the fail rates 1e-6, a parameter's change 1e-4 of
    its largest plus 1e-6 of the parameter, a metric 1e-4 relative with a
    floor of 1e-4 of its scale)."""
    err = {}
    for f in ("mean", "var", "count"):
        g, w = got["obs_norm"][f].double(), want["obs_norm"][f].double()
        err[f"obs_norm.{f}"] = ((g - w).abs()
                                / (DP_NORM_TOL * (1 + w.abs()))).max().item()
    err["fail_rates"] = (got["fail_rates"] - want["fail_rates"]).abs() \
        .max().item() / DP_FAIL_TOL
    for name, tree in (("params", "params"), ("momentum", "opt_state")):
        pick = ((lambda s, k: s["params"][k]) if tree == "params"
                else (lambda s, k: s["opt_state"]["momentum"][k]))
        err[name] = max(
            ((pick(got, k) - pick(want, k)).abs().max()
             / (DP_TOL * (pick(want, k) - (p0 if tree == "params" else 0))
                .abs().max() + 1e-6 * p0.abs().max() + 1e-12)).item()
            for k, p0 in start.items())
    for f, w in ref_metrics.items():
        g, w = metrics[f].double(), w.double()
        scale = max(w.abs().max().item(), 1.0)
        err[f] = ((g - w).abs() / (DP_TOL * (w.abs() + scale))).max().item()
    return err


def dp_compare(single, resume, ranks, what):
    """10(a)'s gates: every rank launched once per control step, the
    kernel agreed with the plain version on its block (judged in the
    rank, rank_check), its
    parameters in sync and bit-identical to the other ranks' after every
    iteration, the sample count summed over the ranks; and each of the
    ranks' iterations against one process's iteration from the same state
    at tests/test_torch_ppo.py's tolerances: the first from the start, the
    second (``resume``) from the ranks' state after the first.

    The one process's free run of both iterations from the start is
    measured against the ranks', not gated: after the first iteration the
    two runs differ by the rounding of 2048-row and 4096-row sums, and
    with every env the same, that difference moves every sample of the
    second rollout at once; dp_replay's witnesses show which part of the
    state carries it (PERF.md)."""
    steps = DP_PPO["steps_per_iter"]
    for r in ranks:
        if [x["launches"] for x in r["runs"]] != [steps] * DP_ITERS:
            raise AssertionError(f"{what}: rank {r['rank']} launches "
                                 f"{[x['launches'] for x in r['runs']]}")
        if r["sync0"] != 0.0 or r["sync"] != 0.0:
            raise AssertionError(f"{what}: check_param_sync {r['sync0']}, "
                                 f"{r['sync']}")
        if r["envs"] != NUM_ENVS // DP_RANKS:
            raise AssertionError(f"{what}: rank {r['rank']} ran {r['envs']} "
                                 f"envs")
        own = torch.device(r["device"]).index
        if any(v for i, v in r["allocated"].items() if i != own):
            raise AssertionError(f"{what}: rank {r['rank']} allocated on "
                                 f"another card: {r['allocated']}")
    for i in range(DP_ITERS):
        a, b = (r["runs"][i]["state"] for r in ranks)
        for k in a["params"]:
            if not (torch.equal(a["params"][k], b["params"][k])
                    and torch.equal(a["opt_state"]["momentum"][k],
                                    b["opt_state"]["momentum"][k])):
                raise AssertionError(f"{what}: the ranks' {k} differ")
        if not torch.equal(a["fail_rates"], b["fail_rates"]):
            raise AssertionError(f"{what}: the ranks' fail rates differ")
        samples = (i + 1) * steps * NUM_ENVS
        want = single["runs"][i]["state"]
        if not float(a["sample_count"]) == float(want["sample_count"]) \
                == samples:
            raise AssertionError(f"{what}: sample_count "
                                 f"{float(a['sample_count'])}, one process "
                                 f"{float(want['sample_count'])}")
    r1, r2 = ranks[0]["runs"]
    gated = [dp_deviation(r1["state"], single["runs"][0]["state"],
                          r1["metrics"], single["runs"][0]["metrics"],
                          single["start"]["params"]),
             dp_deviation(r2["state"], resume["state"], r2["metrics"],
                          resume["metrics"], r1["state"]["params"])]
    for i, e in enumerate(gated):
        worst = max(e, key=e.get)
        if e[worst] > 1.0:
            raise AssertionError(f"{what}: iteration {i + 1}, ranks vs one "
                                 f"process from the same state: {worst} at "
                                 f"{e[worst]:.3g} of its tolerance ({e})")
    free = dp_deviation(r2["state"], single["runs"][1]["state"],
                        r2["metrics"], single["runs"][1]["metrics"],
                        single["start"]["params"])
    return gated, free


def dp_worker_b(argv):
    """One rank of 10(b): the CLI's train_tracker (``argv``) under
    torchrun, recording what the rank writes, the steps it replans on,
    each train_iter's time and launches, its final persistent state and
    its peak memory; then one control step of its final state through the
    kernel, the plain version and float64."""
    from parc_torch.envs.parkour import ParkourEnv
    from parc_torch.learning import ppo as ppo_lib
    rec = dict(saves=[], logs=[], replans=[], steps=0, iters=[])
    save, logger = ckpt_lib.save, train_tracker.Logger
    step, replan = ParkourEnv.step, ParkourEnv._replan
    train_iter = ppo_lib.PPOAgent.train_iter

    def spy_save(directory, s, state):
        rec["saves"].append(s)
        return save(directory, s, state)

    class SpyLogger(logger):
        def __init__(self, output_file=None, **kw):
            rec["logs"].append(output_file)
            super().__init__(output_file=output_file, **kw)

    def spy_step(self, *a, **kw):
        rec["steps"] += 1
        return step(self, *a, **kw)

    def spy_replan(self, *a, **kw):
        rec["replans"].append(rec["steps"])
        return replan(self, *a, **kw)

    def spy_iter(self, lib, state, **kw):
        rec["agent"], rec["lib"] = self, lib
        n0, t0 = sub.control_step_packed.launches, time.perf_counter()
        out = train_iter(self, lib, state, **kw)
        profiling.sync(self.device)
        rec["iters"].append(dict(
            wall_s=time.perf_counter() - t0,
            launches=sub.control_step_packed.launches - n0))
        return out

    ckpt_lib.save, train_tracker.Logger = spy_save, SpyLogger
    ParkourEnv.step, ParkourEnv._replan = spy_step, spy_replan
    ppo_lib.PPOAgent.train_iter = spy_iter
    sub.control_step_packed.launches = 0
    dev = torch.device(argv[argv.index("--device") + 1])
    state = cli.main(argv)  # a fresh process: its peak memory is the run's
    agent, bundle = rec.pop("agent"), rec.pop("lib")
    rec.update(end=to_cpu(ppo_lib.persistent_state(agent, state)),
               envs=agent.env.cfg.num_envs, mgdm=agent.env.pcfg.mgdm_num,
               launches=sub.control_step_packed.launches,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    # the kernel against the plain version on the rank's own block: its
    # terrain stack and its share of the mgdm rows
    es = state.env_state
    rec["check"] = rank_check(agent.env, agent.env._unwrap(bundle)[0], state,
                              agent.act(state, es.obs),
                              f"phase 10b: rank {os.environ['RANK']}'s "
                              f"control step at {es.done.shape[0]} envs")
    torch.save(rec, DP_DIR / f"b_rank{os.environ['RANK']}.pt")


def dp_worker_nccl1():
    """10(c) on one card: a world-size-1 NCCL group that inits, then an
    all_reduce and a broadcast on the card."""
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1,
                            device_id=dev)
    x = torch.arange(8.0, device=dev)
    dist.all_reduce(x)
    m = torch.arange(8.0, device=dev)
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    y = torch.full((5,), 7.0, device=dev)
    dist.broadcast(y, src=0)
    torch.cuda.synchronize()
    ok = (torch.equal(x, torch.arange(8.0, device=dev))
          and torch.equal(m, torch.arange(8.0, device=dev))
          and torch.equal(y, torch.full((5,), 7.0, device=dev)))
    print(json.dumps({"nccl": dist.get_backend(),
                      "world": dist.get_world_size(),
                      "ok": bool(ok), "version": torch.cuda.nccl.version()}))
    dist.destroy_process_group()
    if not ok:
        raise AssertionError("NCCL all_reduce / broadcast values wrong")


def dp_parkour_config():
    """10(b)'s config YAML: phase 9's parkour config, the params' sync
    checked every iteration."""
    path = WORK / "dp_parkour.yaml"
    path.write_text(yaml.safe_dump(dict(
        env_name="parkour", mgdm_num=PARKOUR_MGDM,
        test_steps=PARKOUR_TEST_STEPS, iters_per_sync_check=1)))
    return str(path)


def dp_parkour(t, device):
    """10(b): train_tracker --env_name parkour through the CLI under
    torchrun, DP_RANKS ranks on the one card over gloo, from phase 7's
    MDM; then the checkpoint restored into a one-process eval."""
    out = WORK / "dp_parkour_tracker"
    shutil.rmtree(out, ignore_errors=True)
    DP_DIR.mkdir(parents=True, exist_ok=True)
    cfg = dp_parkour_config()
    t0 = time.perf_counter()
    torchrun(DP_RANKS, ["b", "train_tracker", "--dataset", t["dataset"],
                        "--out_dir", str(out), "--mdm_dir",
                        str(WORK / "mdm"), "--num_envs", str(NUM_ENVS),
                        "--max_iters", str(DP_ITERS), "--config", cfg,
                        "--device", DP_DEVICE, "--dist_backend", "gloo"], 900)
    wall_s = time.perf_counter() - t0
    ranks = [torch.load(DP_DIR / f"b_rank{r}.pt", weights_only=False)
             for r in range(DP_RANKS)]
    steps = PPOConfig().steps_per_iter
    for r, rec in enumerate(ranks):
        if (rec["envs"], rec["mgdm"]) != (NUM_ENVS // DP_RANKS,
                                          PARKOUR_MGDM // DP_RANKS):
            raise AssertionError(f"phase 10b: rank {r} ran {rec['envs']} "
                                 f"envs, {rec['mgdm']} mgdm rows")
        if [x["launches"] for x in rec["iters"]] != [steps] * DP_ITERS:
            raise AssertionError(f"phase 10b: rank {r} launches per "
                                 f"train_iter {rec['iters']}")
        if not rec["replans"]:
            raise AssertionError(f"phase 10b: rank {r} did not replan")
    r0, r1 = ranks
    if r0["replans"] != r1["replans"]:
        raise AssertionError(f"phase 10b: the ranks replanned on other "
                             f"steps: {r0['replans']} / {r1['replans']}")
    if r0["saves"] != [DP_ITERS] or r1["saves"] != []:
        raise AssertionError(f"phase 10b: checkpoints written {r0['saves']}"
                             f" / {r1['saves']}")
    if r0["logs"] != [f"{out}/log.tsv"] or r1["logs"] != []:
        raise AssertionError(f"phase 10b: logs {r0['logs']} / {r1['logs']}")
    if not (out / "log.tsv").exists() or ckpt_lib.all_steps(
            str(out / "checkpoints")) != [DP_ITERS]:
        raise AssertionError("phase 10b: no log or checkpoint from rank 0")
    a, b = r0["end"], r1["end"]
    if not torch.equal(a["fail_rates"], b["fail_rates"]):
        raise AssertionError("phase 10b: the ranks' fail rates differ")
    for k in a["params"]:
        if not torch.equal(a["params"][k], b["params"][k]):
            raise AssertionError(f"phase 10b: the ranks' {k} differ")
    if float(a["sample_count"]) != DP_ITERS * steps * NUM_ENVS:
        raise AssertionError(f"phase 10b: sample_count "
                             f"{float(a['sample_count'])}")
    saved = ckpt_lib.restore(str(out / "checkpoints"))
    if not all(torch.equal(saved["params"][k], a["params"][k])
               for k in a["params"]):
        raise AssertionError("phase 10b: the checkpoint is not rank 0's")
    sub.control_step_packed.launches = 0
    test, _ = cli.main(["eval", "--dataset", t["dataset"], "--tracker_dir",
                        str(out), "--num_envs", str(EVAL_ENVS), "--config",
                        cfg, "--device", device.type])
    profiling.sync(device)
    eval_launches = sub.control_step_packed.launches
    if eval_launches != int(test["test_steps"]) or not all(
            torch.isfinite(v).all() for v in test.values()):
        raise AssertionError(f"phase 10b: eval from the checkpoint: "
                             f"{eval_launches} launches, {test}")
    return dict(ranks=ranks, wall_s=wall_s, eval_steps=eval_launches,
                eval_reward=float(test["mean_reward"]),
                launches=sum(r["launches"] for r in ranks))


def dp_phase(t, p9, device, smi):
    """Phase 10: data parallelism on the card: (a) DP_RANKS ranks on the
    one card over gloo against one process; (b) the parkour env through
    the CLI under torchrun; (c) NCCL."""
    shutil.rmtree(DP_DIR, ignore_errors=True)
    single = dp_single(device)
    torch.cuda.empty_cache()  # the ranks share the card
    t0 = time.perf_counter()
    torchrun(DP_RANKS, ["a", "gloo"], 600)
    a_s = time.perf_counter() - t0
    ranks = [torch.load(DP_DIR / f"a_gloo_rank{r}.pt", weights_only=False)
             for r in range(DP_RANKS)]
    resume = dp_resume(device, ranks)
    gated, free = dp_compare(single, resume, ranks, "phase 10a")
    replay = {"unmoved": dp_replay(device, single, ranks),
              "moved": dp_replay(device, single, ranks, move=1.0),
              "their env": dp_replay(device, single, ranks, their_env=True),
              "their normalizer": dp_replay(device, single, ranks,
                                            their_norm=True)}
    gap = env_gap(ranks_env(device, ranks), single["after1"]["env_state"])

    def shares(e):
        return (f"worst {max(e, key=e.get)} {max(e.values()):.3g}, params "
                f"{e['params']:.3g}, momentum {e['momentum']:.3g}, "
                f"obs_norm.var {e['obs_norm.var']:.3g}, fail rates "
                f"{e['fail_rates']:.3g}, tracking_error "
                f"{e['tracking_error']:.3g}")
    print(f"phase 10a: {DP_RANKS} ranks on one card over gloo "
          f"(torch.distributed.run, {ranks[0]['backend']}), "
          f"{NUM_ENVS // DP_RANKS} envs each, PPOConfig() widths in f32, "
          f"{DP_ITERS} iterations of {DP_PPO['steps_per_iter']} steps "
          f"against one process at {NUM_ENVS} envs from the same state, as "
          f"shares of tests/test_torch_ppo.py's tolerances: iteration 1 "
          f"{shares(gated[0])}; "
          f"iteration 2 {shares(gated[1])}; the one process's free run of "
          f"both iterations (not gated) {shares(free)}; ranks bit-identical, "
          f"check_param_sync {ranks[0]['sync']}; launches per rank "
          f"{[[x['launches'] for x in r['runs']] for r in ranks]}; "
          f"s an iteration per rank "
          f"{[[round(x['wall_s'], 3) for x in r['runs']] for r in ranks]}, "
          f"one process {[round(x['wall_s'], 3) for x in single['runs']]}; "
          f"peak memory per rank "
          f"{[round(r['peak_gb'], 2) for r in ranks]} GB; torchrun "
          f"{a_s:.1f} s | {smi}")
    print(f"phase 10a: the one process's second iteration again from its "
          f"own state after the first, against its free run: unmoved "
          f"{shares(replay['unmoved'])}; parameters and momentum moved by "
          f"the ranks' first-iteration gap in random signs "
          f"{shares(replay['moved'])}; from the ranks' env state (the two "
          f"runs' simulator states {gap:.3e} apart after the first "
          f"iteration) {shares(replay['their env'])}; with the ranks' "
          f"normalizer {shares(replay['their normalizer'])} | {smi}")
    for r in ranks:
        c = r["check"]
        print(f"phase 10a: rank {r['rank']}'s env ({r['envs']} envs, after "
              f"{DP_ITERS} iterations): kernel vs plain control step "
              + ", ".join(f"{f} {v:.1e}" for f, v in c["step_err"].items())
              + f" (tolerance state {c['tol'][0]:.1e}, contact "
              f"{c['tol'][1]:.1e}) | {smi}")

    b = dp_parkour(t, device)
    steps = PPOConfig().steps_per_iter
    for r, rec in enumerate(b["ranks"]):
        print(f"phase 10b: rank {r}: " + "; ".join(
            f"iteration {i + 1} {x['wall_s']:.3f} s, "
            f"{steps * NUM_ENVS // DP_RANKS / x['wall_s']:.1f} samples/s"
            for i, x in enumerate(rec["iters"]))
            + f"; {len(rec['replans'])} replans at steps {rec['replans']}; "
            f"{rec['launches']} launches; peak memory {rec['peak_gb']:.2f} "
            f"GB; kernel vs plain control step at {rec['envs']} envs "
            + ", ".join(f"{f} {v:.1e}" for f, v
                        in rec["check"]["step_err"].items())
            + f" (tolerance state {rec['check']['tol'][0]:.1e}, contact "
            f"{rec['check']['tol'][1]:.1e}) | {smi}")
    walls = [max(r["iters"][i]["wall_s"] for r in b["ranks"])
             for i in range(DP_ITERS)]
    nine = [it["wall_s"] for it in p9["iters"]]
    print(f"phase 10b: train_tracker --env_name parkour through the CLI "
          f"under torchrun, {DP_RANKS} ranks on one card over gloo "
          f"({NUM_ENVS} envs, {PARKOUR_MGDM} mgdm rows in all): "
          f"{', '.join(f'{w:.3f}' for w in walls)} s an iteration, "
          f"{', '.join(f'{steps * NUM_ENVS / w:.1f}' for w in walls)} "
          f"samples/s in all (phase 9a, one process: "
          f"{', '.join(f'{w:.3f}' for w in nine)} s, "
          f"{', '.join(f'{steps * NUM_ENVS / w:.1f}' for w in nine)}); "
          f"torchrun {b['wall_s']:.1f} s; replans on the same steps, fail "
          f"rates and params bit-identical, only rank 0 wrote; eval from "
          f"its checkpoint at {EVAL_ENVS} envs: {b['eval_steps']} steps, "
          f"test reward {b['eval_reward']:.4f} | {smi}")

    if torch.cuda.device_count() >= 2:
        torchrun(DP_RANKS, ["a", "nccl"], 600)
        ranks = [torch.load(DP_DIR / f"a_nccl_rank{r}.pt", weights_only=False)
                 for r in range(DP_RANKS)]
        gated, _ = dp_compare(single, dp_resume(device, ranks), ranks,
                              "phase 10c")
        print(f"phase 10c: 10a over NCCL, one rank a card "
              f"({[r['device'] for r in ranks]}): iterations 1 and 2 at "
              f"{max(gated[0].values()):.3g} and {max(gated[1].values()):.3g}"
              f" of their tolerances | {smi}")
    else:
        out = run_group([sys.executable, str(Path(__file__).resolve()),
                         "--dp-worker", "nccl1"], 300)
        probe = json.loads(out.strip().splitlines()[-1])
        if not probe["ok"]:
            raise AssertionError(f"phase 10c: {probe}")
        print(f"phase 10c: a world-size-1 NCCL group (NCCL "
              f"{probe['version']}) inits, all_reduce (sum, max) and "
              f"broadcast on the card give the expected values | {smi}")
        print("phase 10c: the two-rank NCCL run waits for a machine with "
              "two cards (NCCL refuses two ranks on one GPU)")
    return b


# ---------------------------------------------------------------------------
# Phase 11: the tools (metrics, fidelity, validation, retargeting) and the
# editing and geometry helpers
# ---------------------------------------------------------------------------

TOOLS_REL = 1e-4      # 11a: card vs CPU metrics, 11e: card vs CPU edits
FIDELITY_COPIES = 1024  # 11b: the 4 clips x 1024 = 4096 envs
FIDELITY_CHECK_STEP = 30  # 11b: the control step held against the plain one
# 11b: tests/test_fidelity.py:27-43's thresholds for the default sweep
FIDELITY_MIN = {"stand": (1.2, 0.30), "walk": (0.74, 0.24)}
VALIDATION_TOP_K = 4
VALIDATION_SECONDS = 3.0  # 11c: path length cut from 10 s
RETARGET_ERR = 0.06  # 11d: tests/test_retarget.py:27
# 11d: the URDF the script carries (tests/test_retarget.py's arm: two
# revolute joints, a fixed wrist and a prismatic tool)
ARM_URDF = """<robot name="arm">
  <link name="base"/><link name="upper"/><link name="fore"/>
  <link name="hand"/><link name="tool"/>
  <joint name="shoulder" type="revolute">
    <parent link="base"/><child link="upper"/>
    <origin xyz="0 0 1" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-1.5" upper="1.5"/></joint>
  <joint name="elbow" type="revolute">
    <parent link="upper"/><child link="fore"/>
    <origin xyz="1 0 0" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.0" upper="2.0"/></joint>
  <joint name="wrist" type="fixed">
    <parent link="fore"/><child link="hand"/>
    <origin xyz="0.5 0 0" rpy="0 0 0"/></joint>
  <joint name="slider" type="prismatic">
    <parent link="hand"/><child link="tool"/>
    <origin xyz="0 0 0" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="0" upper="0.3"/></joint>
</robot>"""
ARM_MAP = {"pelvis": "base", "left_hip": "upper", "left_knee": "fore",
           "left_ankle": "hand", "left_foot": "tool"}


def rel_same(got, want, rel, what):
    """Every value of ``got`` within ``rel`` relative of ``want``'s (inf,
    None and counts equal)."""
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str) or w is None or not np.isfinite(w):
            if g != w:
                raise AssertionError(f"{what}: {k} {g} against {w}")
        elif abs(g - w) > rel * max(abs(w), 1e-6):
            raise AssertionError(f"{what}: {k} {g} against {w} (relative "
                                 f"{rel})")


def metrics_stage(clip_dir, device):
    """11a: the CLI's metrics stage on phase 8's kin-gen clips, and the
    same call on the CPU."""
    from parc_torch.tools import metrics
    out = WORK / "metrics.csv"
    t0 = time.perf_counter()
    rows, stats = cli.main(["metrics", "--motions_dir", str(clip_dir),
                            "--out", str(out)])
    profiling.sync(device)
    s = time.perf_counter() - t0
    if not rows or not out.exists():
        raise AssertionError(f"phase 11a: metrics wrote {len(rows)} rows")
    for r in rows:
        for k, v in r.items():
            if k != "file" and v is not None and not np.isfinite(v):
                raise AssertionError(f"phase 11a: {r['file']} {k} = {v}")
    if not all(np.isfinite(v) for v in stats.values()):
        raise AssertionError(f"phase 11a: statistics {stats}")
    cpu_rows = metrics.evaluate_motion_dir(
        humanoid_spec().build(device="cpu"), str(clip_dir))
    worst = 0.0
    for g, w in zip(rows, cpu_rows):
        rel_same(g, w, TOOLS_REL, f"phase 11a: {w['file']} card vs CPU")
        worst = max([worst] + [abs(g[k] - w[k]) / max(abs(w[k]), 1e-6)
                               for k in w if k != "file" and w[k]
                               is not None])
    return dict(rows=rows, stats=stats, s=s, worst=worst)


def fidelity_phase(device):
    """11b: run_sweeps on the card, one launch a control step; then the
    harness at 4096 envs and one of its control steps against the plain
    version."""
    from parc_torch.tools import fidelity
    clips = fidelity.fidelity_clips(include_reference=False)
    cfg = EnvConfig()
    steps = int(max(np.floor(np.float32((c.frames.shape[0] - 1) / c.fps)
                             / cfg.control_dt) - 1 for c in clips.values()))
    per_sweep = []
    replay = fidelity.pd_replay

    def timed(*a, **kw):
        before = sub.control_step_packed.launches
        profiling.sync(device)
        t0 = time.perf_counter()
        out = replay(*a, **kw)
        profiling.sync(device)
        per_sweep.append((time.perf_counter() - t0,
                          sub.control_step_packed.launches - before))
        return out
    fidelity.pd_replay = timed
    sub.control_step_packed.launches = 0
    try:
        results = fidelity.run_sweeps(device=device, include_reference=False)
    finally:
        fidelity.pd_replay = replay
    launches = sub.control_step_packed.launches
    for name, (s, n) in zip(results, per_sweep):
        if n != steps:
            raise AssertionError(f"phase 11b: sweep {name}: {n} launches "
                                 f"for {steps} control steps")
    for name, rs in results.items():
        for r in rs:
            if not (np.isfinite(r.mean_reward)
                    and np.all(np.isfinite(r.tracking_error))):
                raise AssertionError(f"phase 11b: {name} {r}")
    for r in results["default"]:
        lo = FIDELITY_MIN.get(r.clip)
        if lo and not (r.mean_reward > lo[0] and r.survival > lo[1]):
            raise AssertionError(f"phase 11b: default {r.clip}: reward "
                                 f"{r.mean_reward}, survival {r.survival} "
                                 f"(need > {lo})")
        if not r.tracking_error[0] < 0.5:
            raise AssertionError(f"phase 11b: default {r.clip}: root "
                                 f"tracking error {r.tracking_error[0]}")

    # the harness at full width: 4 clips x 1024 copies, and one control
    # step of its state (the first of the envs alive at the check step)
    model = humanoid_spec().build(device=device)
    seen = {}
    env_step = DeepMimicEnv.step

    def spy(self, lib, state, actions, **kw):
        seen["n"] = seen.get("n", 0) + 1
        if seen["n"] == FIDELITY_CHECK_STEP:
            seen.update(env=self, lib=lib, state=state, action=actions)
        return env_step(self, lib, state, actions, **kw)
    DeepMimicEnv.step = spy
    sub.control_step_packed.launches = 0
    try:
        profiling.sync(device)
        t0 = time.perf_counter()
        wide = fidelity.pd_replay(model, engine.SimParams(), clips,
                                  device=device, copies=FIDELITY_COPIES)
        profiling.sync(device)
        wide_s = time.perf_counter() - t0
    finally:
        DeepMimicEnv.step = env_step
    wide_launches = sub.control_step_packed.launches
    if wide_launches != steps:
        raise AssertionError(f"phase 11b: {wide_launches} launches at "
                             f"{len(wide)} envs for {steps} control steps")
    first = {}
    for e, r in enumerate(wide):
        ref = first.setdefault(r.clip, r)
        if not ((r.mean_reward, r.survival, r.failed)
                == (ref.mean_reward, ref.survival, ref.failed)
                and np.array_equal(r.tracking_error, ref.tracking_error)):
            raise AssertionError(f"phase 11b: env {e} ({r.clip}) {r} "
                                 f"against its first copy {ref}")
    check = step_vs_plain(model, seen["env"], seen["lib"], seen["state"],
                          seen["action"])
    check["tol"] = judge(check, f"phase 11b fidelity control step "
                         f"{FIDELITY_CHECK_STEP}")
    return dict(results=results, per_sweep=per_sweep, steps=steps,
                launches=launches, wide=wide, wide_s=wide_s,
                wide_launches=wide_launches, check=check,
                default_1024=[first[c] for c in clips])


def validation_phase(t, device):
    """11c: run_validation from phase 7's checkpoint on two fixtures, each
    a kin-gen boxes terrain with its A* path."""
    from parc_torch.pipeline import kin_gen
    from parc_torch.procgen import mdm_path
    from parc_torch.tools import validation
    model = humanoid_spec().build(device=device)
    mdm = MDM(model, MDMConfig(), device=device)
    lib = dataset_lib.load_dataset(model, t["dataset"], device=device)
    state = mdm.merge_persistent(
        mdm.init(lib, torch.Generator(device=device).manual_seed(1),
                 stats_samples=64),
        ckpt_lib.restore(str(WORK / "mdm" / "checkpoints"),
                         map_location=device))
    fixtures, seed = [], KIN_CHECK_SEED
    while len(fixtures) < 2:
        drawn = kin_gen._draw_terrain_and_path(
            KinGenConfig(), np.random.default_rng(seed), device)
        seed += 1
        if drawn is not None:
            fixtures.append(validation.ValidationFixture(
                f"boxes{seed - 1}", drawn[0], drawn[2]))
    cfg = mdm_path.PathGenSettings(max_seconds=VALIDATION_SECONDS)
    mdm.denoise_calls = 0
    t0 = time.perf_counter()
    rows = validation.run_validation(mdm, state, fixtures,
                                     output_dir=str(WORK / "validation"),
                                     seed=0, path_cfg=cfg,
                                     top_k=VALIDATION_TOP_K)
    profiling.sync(device)
    s = time.perf_counter() - t0
    if len(rows) != len(fixtures) * VALIDATION_TOP_K:
        raise AssertionError(f"phase 11c: {len(rows)} rows for "
                             f"{len(fixtures)} fixtures x top "
                             f"{VALIDATION_TOP_K}")
    for r in rows:
        for k, v in r.items():
            if isinstance(v, float) and not np.isfinite(v):
                raise AssertionError(f"phase 11c: {r['fixture']} {k} = {v}")
    return dict(rows=rows, s=s, summary=validation.summarize(rows),
                denoise=mdm.denoise_calls, batch=cfg.batch_size,
                gen_s=sorted({r["gen_time_s"] for r in rows}))


def retarget_phase(device):
    """11d: the humanoid round trip through retarget_keypoints at
    RetargetConfig(), and retarget_keypoints_to_robot on the arm URDF."""
    from parc_torch.retarget import keypoint_ik, urdf
    model = humanoid_spec().build(device=device)
    frames = walking_clip(seed=0, n=30).frames
    kps = keypoint_ik.keypoints_from_motion(model, frames)
    cfg = keypoint_ik.RetargetConfig()
    mapping = {n: n for n in model.body_names}
    profiling.sync(device)
    t0 = time.perf_counter()
    got, losses = keypoint_ik.retarget_keypoints(
        model, kps, keypoint_names=model.body_names, mapping=mapping,
        cfg=cfg, device=device)
    profiling.sync(device)
    s = time.perf_counter() - t0
    err = np.linalg.norm(keypoint_ik.keypoints_from_motion(model, got) - kps,
                         axis=-1).mean()
    lo = model.dof_limits_lower.cpu().numpy()
    hi = model.dof_limits_upper.cpu().numpy()
    if not (np.isfinite(got).all() and err < RETARGET_ERR
            and np.all(got[:, 6:] >= lo - 1e-5)
            and np.all(got[:, 6:] <= hi + 1e-5)):
        raise AssertionError(f"phase 11d: round trip error {err} (need < "
                             f"{RETARGET_ERR}) or frames past the limits")

    robot = urdf.parse_urdf(ARM_URDF)
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.uniform(-0.5, 0.5, (30, robot.num_dofs)),
                        dtype=torch.float32, device=device)
    pos = urdf.forward_kinematics(robot, q)[0].cpu().numpy()
    names = list(keypoint_ik.SMPL_JOINT_NAMES)
    arm_kps = rng.normal(0, 0.01, (30, len(names), 3)).astype(np.float32)
    for smpl, link in ARM_MAP.items():
        arm_kps[:, names.index(smpl)] += pos[:, robot.link_index(link)]
    before = urdf.retarget_keypoints_to_robot(
        robot, arm_kps, ARM_MAP, cfg=urdf.UrdfRetargetConfig(iters=0),
        device=device)[3]
    profiling.sync(device)
    t0 = time.perf_counter()
    *_, after = urdf.retarget_keypoints_to_robot(robot, arm_kps, ARM_MAP,
                                                 device=device)
    profiling.sync(device)
    urdf_s = time.perf_counter() - t0
    if not (all(np.isfinite(v) for v in after.values())
            and sum(after.values()) < sum(before.values())):
        raise AssertionError(f"phase 11d: URDF losses {before} -> {after}")
    return dict(s=s, iters=cfg.iters, err=err, losses=losses, urdf_s=urdf_s,
                urdf_iters=urdf.UrdfRetargetConfig().iters,
                before=before, after=after)


def slerp_small_angle(models, a, b):
    """(T, 34) mask of the frame columns whose slerp from frames ``a`` to
    ``b`` (root, then each joint) takes one of ``rot.slerp``'s small-angle
    branches on any of ``models``' devices: q0 where the cosine of the half
    angle rounds to 1, the midpoint where its sine is under 1e-3. The slerp
    is discontinuous there, and f32 resolves that sine only to about 20 %
    near 1e-3, so which branch it takes flips between two devices (up to
    1e-3 apart; the JAX package's slerp has the same branches). Each
    device's test is the slerp's own, on that device's f32 quaternions."""
    from parc_torch.utils import rotation as rot
    small = torch.zeros((len(a), models[0].num_bodies), dtype=torch.bool)
    for model in models:
        fa, fb = (torch.as_tensor(np.asarray(x, np.float32),
                                  device=model.device) for x in (a, b))
        pairs = ((rot.exp_map_to_quat(fa[:, 3:6]),
                  rot.exp_map_to_quat(fb[:, 3:6])),
                 (cm.dof_to_rot(model, fa[:, 6:]),
                  cm.dof_to_rot(model, fb[:, 6:])))
        for cols, (q0, q1) in zip((slice(0, 1), slice(1, None)), pairs):
            cos_half = torch.abs(torch.sum(q0 * q1, dim=-1))
            c = torch.clamp(cos_half, -1.0, 1.0)
            sin_half = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-12))
            small[:, cols] |= ((sin_half < 1e-3) | (cos_half >= 1.0)).reshape(
                len(a), -1).cpu()
    mask = np.zeros((len(a), 34), bool)
    mask[:, 3:6] = small[:, 0:1].numpy()
    for j in range(1, models[0].num_bodies):
        o, e = models[0].joint_dof_slice(j)
        mask[:, 6 + o:6 + e] = small[:, j:j + 1].numpy()
    return mask


def edits_phase(clip_path, other_path, device):
    """11e: the editing and geometry helpers on the card against the CPU,
    on one of phase 8's clips and its terrain (the match search from it
    into another)."""
    from parc_torch.anim import motion_edit as me
    from parc_torch.retarget import keypoint_ik
    from parc_torch.utils import rotation as rot
    clip = md.load_motion_data(clip_path)
    card, cpu = (humanoid_spec().build(device=d) for d in (device, "cpu"))
    f = clip.frames.astype(np.float32)
    errs, small = {}, {}

    def close(name, g, w, edge=None):
        """Card against CPU within TOOLS_REL; ``edge`` marks the values
        whose slerp runs in its small-angle regime, held apart."""
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else w
        if g.shape != w.shape:
            raise AssertionError(f"phase 11e: {name} {g.shape} vs {w.shape}")
        d = np.abs(g - w)
        if edge is not None:
            small[name] = (int((d[edge] > TOOLS_REL).sum()), int(edge.sum()))
            d = np.where(edge, 0.0, d)
        errs[name] = float(d.max())
        if errs[name] > TOOLS_REL:
            at = np.unravel_index(np.argmax(d), d.shape)
            raise AssertionError(f"phase 11e: {name} card vs CPU "
                                 f"{errs[name]} at (frame, column) {at}: "
                                 f"card {g[at]}, CPU {w[at]} (gate "
                                 f"{TOOLS_REL})")

    idx = me._linspace(0.0, (len(f) - 1) / clip.fps,
                       int(round((len(f) - 1) / clip.fps * 20.0)) + 1)
    i0 = np.clip(np.floor(idx * np.float32(clip.fps)).astype(int), 0,
                 len(f) - 1)
    i1 = np.minimum(i0 + 1, len(f) - 1)
    close("resample_fps", me.resample_fps(card, f, clip.fps, 20.0),
          me.resample_fps(cpu, f, clip.fps, 20.0),
          slerp_small_angle((card, cpu), f[i0], f[i1]))
    back = f[::-1].copy()
    edge = np.zeros((2 * len(f) - 8, 34), bool)
    edge[len(f) - 8:len(f)] = slerp_small_angle((card, cpu), f[-8:],
                                                back[:8])
    close("blend_motions", me.blend_motions(card, f, back, 8),
          me.blend_motions(cpu, f, back, 8), edge)
    close("correct_foot_ground_pen", me.correct_foot_ground_pen(card, f, 0.1),
          me.correct_foot_ground_pen(cpu, f, 0.1))

    t_card = clip.terrain.to_device(device)
    t_cpu = clip.terrain.to_device("cpu")
    got = me.compute_contacts(card, t_card, f).cpu().numpy()
    want = me.compute_contacts(cpu, t_cpu, f).numpy()
    differ = np.argwhere(got != want)
    # a label may flip only where a contact point's nearest cell differs
    # (a point on a cell edge) or its height sits on the eps band's edge
    excused = 0
    if len(differ):
        def points(model, terrain):
            fr = torch.as_tensor(f, device=model.device)
            bp, br = me._fk(model, fr)
            b = model.contact_point_body
            p = bp[:, b] + rot.quat_rotate(
                br[:, b], model.contact_point_offset.expand(bp[:, b].shape))
            cell = terrain_lib.get_grid_index(terrain, p[..., 0:2])
            h = (p[..., 2] - model.contact_point_radius
                 - terrain_lib.get_hf_val(terrain, p[..., 0:2]))
            return cell.cpu().numpy(), h.cpu().numpy()
        cell_g, h_g = points(card, t_card)
        cell_w, h_w = points(cpu, t_cpu)
        body = cpu.contact_point_body.numpy()
        for fr, b in differ:
            pts = body == b
            if (np.any(cell_g[fr, pts] != cell_w[fr, pts])
                    or np.any(np.abs(h_w[fr, pts] - 0.04) < 1e-5)
                    or np.any(np.abs(h_g[fr, pts] - 0.04) < 1e-5)):
                excused += 1
            else:
                raise AssertionError(f"phase 11e: compute_contacts frame "
                                     f"{fr} body {b} differs card vs CPU")
    contacts = dict(labels=got.size, differ=len(differ), excused=excused)

    f2 = md.load_motion_data(other_path).frames.astype(np.float32)
    g = me.search_for_matching_motion_frames(card, f, f2, clip.fps)
    w = me.search_for_matching_motion_frames(cpu, f, f2, clip.fps)
    if g[:2] != w[:2]:
        raise AssertionError(f"phase 11e: match {g[:2]} card, {w[:2]} CPU")

    def same(name, a, b):
        for fld in ("hf", "hf_mask", "hf_maxmin", "min_point", "dxdy"):
            if not torch.equal(getattr(a, fld).cpu(), getattr(b, fld)):
                raise AssertionError(f"phase 11e: {name} {fld} card vs CPU")
    same("flat_maxpool_3x3", terrain_lib.flat_maxpool_3x3(t_card),
         terrain_lib.flat_maxpool_3x3(t_cpu))
    same("downsample_terrain", terrain_lib.downsample_terrain(t_card),
         terrain_lib.downsample_terrain(t_cpu))
    hf2 = t_cpu.hf + 0.7 * torch.sin(torch.arange(t_cpu.hf.numel()).reshape(
        t_cpu.hf.shape).float())
    mask = torch.rand(t_cpu.hf.shape, generator=torch.Generator().manual_seed(
        0)) < 0.3
    merged = terrain_lib.merge_hfs(t_card.hf, mask.to(device),
                                   t_card.hf_maxmin, hf2.to(device))
    if not torch.equal(merged.cpu(), terrain_lib.merge_hfs(
            t_cpu.hf, mask, t_cpu.hf_maxmin, hf2)):
        raise AssertionError("phase 11e: merge_hfs card vs CPU")
    body = keypoint_ik.keypoints_from_motion(card, f)
    same("hf_from_motion", terrain_lib.hf_from_motion(body, device=device),
         terrain_lib.hf_from_motion(body, device="cpu"))
    t0 = time.perf_counter()
    verts, tris = terrain_lib.hf_to_trimesh(
        clip.terrain.hf, float(clip.terrain.min_point[0]),
        float(clip.terrain.min_point[1]), float(clip.terrain.dxdy[0]),
        float(clip.terrain.dxdy[1]))
    mesh_s = time.perf_counter() - t0
    tri = verts[tris]
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                   tri[:, 2] - tri[:, 0]), axis=-1)
    if not (tris.min() >= 0 and tris.max() < len(verts) and area.min() > 0):
        raise AssertionError("phase 11e: hf_to_trimesh gave an index out "
                             "of range or a degenerate triangle")
    return dict(errs=errs, small=small, contacts=contacts, match=g[:2],
                mesh=(len(verts), len(tris), mesh_s))


def tools_phase(t, k8, device, smi):
    """Phase 11: the tools on the card, from phases 5, 7 and 8's outputs."""
    t0 = time.perf_counter()
    clip_dir = Path(k8["paths"][0]).parent
    a = metrics_stage(clip_dir, device)
    print(f"phase 11a: metrics through the CLI on {clip_dir.name}/: "
          f"{len(a['rows'])} clips in {a['s']:.2f} s "
          f"({1e3 * a['s'] / len(a['rows']):.1f} ms a clip); "
          + ", ".join(f"{k} {v:.4f}" for k, v in a["stats"].items())
          + f"; card vs CPU within {a['worst']:.2e} relative (gate "
          f"{TOOLS_REL}) | {smi}")

    from parc_torch.tools import fidelity
    b = fidelity_phase(device)
    print("phase 11b: fidelity sweeps (run_sweeps, 4 synthetic clips, "
          f"{b['steps']} control steps a sweep):\n"
          + fidelity.format_markdown(b["results"]))
    print(f"phase 11b: s a sweep "
          + ", ".join(f"{name} {s:.2f}" for name, (s, _) in
                      zip(b["results"], b["per_sweep"]))
          + f"; {b['launches']} launches ({b['steps']} a sweep, one a "
          f"control step); default: " + ", ".join(
              f"{r.clip} {r.mean_reward:.3f} / {r.survival:.2f}"
              for r in b["results"]["default"])
          + f"; at {len(b['wide'])} envs ({FIDELITY_COPIES} copies a clip) "
          f"{b['wide_s']:.2f} s, {b['wide_launches']} launches, every copy "
          f"of a clip the same bits; kernel vs plain control step "
          f"{FIDELITY_CHECK_STEP} "
          + ", ".join(f"{f} {v:.1e}" for f, v in b["check"]["step_err"].items())
          + f" (tolerance state {b['check']['tol'][0]:.1e}, contact "
          f"{b['check']['tol'][1]:.1e}) | {smi}")

    c = validation_phase(t, device)
    print(f"phase 11c: run_validation from phase 7's checkpoint, "
          f"{len(c['rows']) // VALIDATION_TOP_K} kin-gen boxes fixtures x "
          f"{c['batch']} rollouts, {VALIDATION_SECONDS} s paths, top "
          f"{VALIDATION_TOP_K}: {len(c['rows'])} rows in {c['s']:.1f} s "
          f"(generation " + ", ".join(f"{g:.2f}" for g in c["gen_s"])
          + f" s a fixture, {c['denoise']} denoiser calls); "
          + ", ".join(f"{k} {v:.4g}" for k, v in c["summary"].items())
          + f" | {smi}")

    d = retarget_phase(device)
    print(f"phase 11d: retarget_keypoints, the walking clip's 30 frames at "
          f"RetargetConfig() ({d['iters']} Adam iterations): {d['s']:.2f} s, "
          f"{1e3 * d['s'] / d['iters']:.2f} ms an iteration; round trip "
          f"mean keypoint error {d['err']:.4f} m (gate {RETARGET_ERR}); "
          f"final losses " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       d["losses"].items())
          + f"; the arm URDF: {d['urdf_iters']} iterations in "
          f"{d['urdf_s']:.2f} s ({1e3 * d['urdf_s'] / d['urdf_iters']:.2f} "
          f"ms each), total loss {sum(d['before'].values()):.4g} -> "
          f"{sum(d['after'].values()):.4g} | {smi}")

    e = edits_phase(k8["paths"][0], k8["paths"][-1], device)
    print(f"phase 11e: editing helpers, card vs CPU: "
          + ", ".join(f"{k} {v:.1e}" for k, v in e["errs"].items())
          + f" (gate {TOOLS_REL}; in the slerp's small-angle regime, held "
          f"apart, " + ", ".join(f"{k} {n} of {m} values past it" for k, (
              n, m) in e["small"].items())
          + f"); compute_contacts {e['contacts']['differ']}"
          f" of {e['contacts']['labels']} labels differ, all on a cell edge "
          f"or the eps band's edge; match frames {e['match']} on both; "
          f"flat_maxpool_3x3, downsample_terrain, merge_hfs, hf_from_motion "
          f"equal; hf_to_trimesh {e['mesh'][0]} vertices, {e['mesh'][1]} "
          f"triangles in {e['mesh'][2]:.3f} s, valid | {smi}")
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return dict(launches=b["launches"] + b["wide_launches"])


# ---------------------------------------------------------------------------
# Phase 12: the viewer and the studio
# ---------------------------------------------------------------------------

VIEW_BODY_TOL = 1e-4 + 2e-6  # 12a: 4-decimal body positions, f32 FK apart
VIEW_CENTER_TOL = 1e-3 + 2e-6  # 12a: their mean, rounded to 3 decimals
STUDIO_SIM_STEPS = 64  # 12b: sim_step's control steps (8 chunks of 8)
STUDIO_OPT_ITERS = 300  # 12b: optimize at the studio's default


def view_data(path):
    """The DATA object of an exported viewer page."""
    import re
    html = Path(path).read_text()
    return json.loads(re.search(r"const DATA = (.*?);\n", html,
                                re.S).group(1))


def view_phase(k8, device):
    """12a: the CLI's view stage on an 8a clip against its 8c optimized
    copy, on the card and on the CPU; the two pages' DATA must match."""
    clip = Path(k8["paths"][0])
    other = WORK / "gen" / "opt" / f"{clip.stem}_opt.npz"
    out = WORK / "view"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    written, secs = {}, {}
    for dev in (device.type, "cpu"):
        t0 = time.perf_counter()
        written[dev] = cli.main(["view", "--input", str(clip), "--compare",
                                 str(other), "--out", str(out / f"{dev}.html"),
                                 "--device", dev])
        secs[dev] = time.perf_counter() - t0
    got, want = (view_data(out / f"{dev}.html") for dev in (device.type,
                                                             "cpu"))
    body_err = 0.0
    for k in ("title", "fps", "parents", "terrain", "path"):
        if got[k] != want[k]:
            raise AssertionError(f"phase 12a: {k} differs from the CPU's")
    if abs(np.subtract(got["center"], want["center"])).max() > \
            VIEW_CENTER_TOL:
        raise AssertionError(f"phase 12a: center {got['center']} against "
                             f"{want['center']}")
    if len(got["clips"]) != 2 or len(want["clips"]) != 2:
        raise AssertionError("phase 12a: not two clips")
    for g, w in zip(got["clips"], want["clips"]):
        for k in ("label", "color", "contacts"):
            if g[k] != w[k]:
                raise AssertionError(f"phase 12a: {k} differs from the CPU's")
        g_bp, w_bp = np.asarray(g["body_pos"]), np.asarray(w["body_pos"])
        if g_bp.shape != w_bp.shape or not np.isfinite(g_bp).all():
            raise AssertionError(f"phase 12a: body_pos {g_bp.shape}")
        body_err = max(body_err, float(np.abs(g_bp - w_bp).max()))
    if body_err > VIEW_BODY_TOL:
        raise AssertionError(f"phase 12a: body_pos {body_err} from the "
                             f"CPU's (tolerance {VIEW_BODY_TOL})")
    return dict(clip=clip.name, other=other.name, s=secs[device.type],
                cpu_s=secs["cpu"], body_err=body_err,
                frames=[len(c["body_pos"]) for c in got["clips"]],
                png=len(written[device.type]) == 2,
                html_bytes=(out / f"{device.type}.html").stat().st_size)


def studio_phase(t, device):
    """12b-c: the studio over HTTP on 127.0.0.1 from phases 5 and 7's
    checkpoints; the ops a user runs to make, check and edit a clip, each
    gated at 200 and finite frames; the kernel's launches per op; then one
    control step of the live sim's 1-env state through the kernel and
    the plain version."""
    import http.client
    import threading

    from parc_torch.viewer import studio as studio_lib
    ws = WORK / "studio"
    shutil.rmtree(ws, ignore_errors=True)
    ws.mkdir(parents=True)
    model = humanoid_spec().build(device=device)
    st = studio_lib.Studio(
        model, md.load_motion_data(dataset_files(t["dataset"])[1]),
        mdm_dir=str(WORK / "mdm"), tracker_dir=t["tracker"],
        workspace=str(ws), device=device)
    server = studio_lib.make_server(st, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    ops, sims = [], []
    try:
        host, port = server.server_address
        conn = http.client.HTTPConnection(host, port, timeout=900)

        def call(op, body=None):
            n0, t0 = sub.control_step_packed.launches, time.perf_counter()
            if body is None:
                conn.request("GET", f"/api/{op}")
            else:
                conn.request("POST", f"/api/{op}", body=json.dumps(body),
                             headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            raw = r.read()
            profiling.sync(device)
            ms = 1e3 * (time.perf_counter() - t0)
            if r.status != 200:
                raise AssertionError(f"phase 12b: {op} answered {r.status}: "
                                     f"{raw[:300]!r}")
            out = json.loads(raw)
            for c in out["clips"]:
                if not np.isfinite(np.asarray(c["body_pos"])).all():
                    raise AssertionError(f"phase 12b: {op}: {c['label']} "
                                         "not finite")
            for m in (st.motion, st.overlay):
                if m is not None and not np.isfinite(m.frames).all():
                    raise AssertionError(f"phase 12b: {op}: frames not "
                                         "finite")
            ops.append(dict(op=op, ms=ms, bytes=len(raw), status=out["status"],
                            launches=sub.control_step_packed.launches - n0))
            return out

        sub.control_step_packed.launches = 0
        call("procgen", {"kind": "boxes", "x_dim": 32, "y_dim": 32})
        out = call("astar", {"start": [0, 0], "end": [31, 31]})
        if out["path"] is None:
            raise AssertionError(f"phase 12b: A* {out['status']}")
        call("mdm_gen", {})
        call("recompute_contacts", {})
        call("optimize", {"iters": STUDIO_OPT_ITERS})
        call("accept_overlay", {})
        motion = st.motion
        track_steps = min(int(np.ceil(motion.frames.shape[0] / motion.fps
                                      * 30) + 2), 600)
        lib_cpu = ml.build_motion_lib(humanoid_spec().build(device="cpu"),
                                      [motion], device="cpu")
        track_steps = record.round_steps(lib_cpu, track_steps)
        call("track", {})
        call("sim_start", {})
        call("sim_step", {"steps": STUDIO_SIM_STEPS})
        sims.append(st._sim)
        call("sim_stop", {})
        call("flip", {})
        call("resample", {"fps": 60})
        n = st.motion.frames.shape[0]
        call("slice", {"start": n // 8, "end": n - n // 8})
        call("save", {"path": "studio_clip.npz"})
        n = st.motion.frames.shape[0]
        out = call("stitch", {"path": "studio_clip.npz",
                              "range_a": [n // 2, n // 2 + 30]})
        call("state")
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
    launches = {o["op"]: o["launches"] for o in ops}
    want = {op: 0 for op in launches}
    want.update(track=track_steps, sim_step=STUDIO_SIM_STEPS)
    if launches != want:
        raise AssertionError(f"phase 12b: control-step launches per op "
                             f"{launches}, expected {want}")
    if st.overlay is not None or st.motion.frames.shape[0] != n:
        raise AssertionError("phase 12b: the stitch changed the clip's "
                             "length")

    sim = sims[0]
    agent, es = sim["agent"], sim["es"]
    with torch.no_grad():
        action = agent.act(sim["state"], es.obs)
    c = step_vs_plain(agent.env.model, agent.env, sim["lib"], es, action)
    c["tol"] = judge(c, "phase 12c control step")
    return dict(ops=ops, track_steps=track_steps,
                launches=sum(launches.values()), check=c,
                frames=len(sim["frames"]) * studio_lib.SIM_CHUNK)


def viewer_phase(k8, t, device, smi):
    """Phase 12: the viewer and the studio on the card."""
    t0 = time.perf_counter()
    a = view_phase(k8, device)
    print(f"phase 12a: view through the CLI, {a['clip']} ({a['frames'][0]} "
          f"frames) against {a['other']} ({a['frames'][1]}): "
          f"{a['s']:.2f} s on the card, {a['cpu_s']:.2f} s on the CPU, "
          f"{a['html_bytes']} B of HTML; body positions within "
          f"{a['body_err']:.1e} of the CPU's (gate {VIEW_BODY_TOL:.1e}), "
          f"the rest equal; PNG strip "
          + ("drawn" if a["png"] else "not drawn (no matplotlib)")
          + f" | {smi}")
    b = studio_phase(t, device)
    print(f"phase 12b: the studio over HTTP (127.0.0.1, device {device}, "
          "PPOConfig() tracker from phase 5, MDMConfig() from phase 7): "
          + "; ".join(f"{o['op']} {o['ms']:.1f} ms, {o['bytes']} B"
                      + (f", {o['launches']} launches" if o["launches"]
                         else "") + f" ({o['status']})" for o in b["ops"])
          + f" | {smi}")
    c = b["check"]
    print(f"phase 12c: the live sim's 1-env state after {b['frames']} steps: "
          f"kernel vs plain control step "
          + ", ".join(f"{f} {v:.1e}" for f, v in c["step_err"].items())
          + f" (tolerance state {c['tol'][0]:.1e}, contact "
          f"{c['tol'][1]:.1e}); max|contact| {c['max_contact']:.1f} N "
          f"| {smi}")
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return dict(launches=b["launches"], track_steps=b["track_steps"],
                check=c)


# ---------------------------------------------------------------------------
# Phase 13: one PARC iteration's hand-off (kin-gen's clips -> the tracker)
# ---------------------------------------------------------------------------

ITER_TRAIN_ITERS, ITER_TEST_STEPS = 2, 100  # 13b, 13d's eval
WALL_EDGE = 1e-4  # 13c: cells from a grid line where the normal jumps


def iter_dataset(t, device):
    """13a: iteration 0's motions+gen.yaml: phase 5's bench clips and every
    clip of phase 8 copied into one motions directory (a class a stage),
    create_dataset over it (the keep thresholds at infinity, as in 8c);
    every listed clip reloads equal to what its stage saved, and the motion
    library stacks the terrains one slot a clip."""
    base = ITER_ROOT / "iter_0"
    motions = base / "motions+gen"
    shutil.rmtree(motions, ignore_errors=True)
    sources = [(Path(f), "bench") for f in dataset_files(t["dataset"])] + [
        (Path(f), Path(f).parent.name)
        for f in sorted(glob.glob(str(WORK / "gen" / "*" / "*.npz")))]
    saved = {}
    for src, cls in sources:
        dst = motions / cls / src.name
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
        saved[dst] = clip_arrays(src)
    config = WORK / "keep_all.yaml"
    config.write_text(yaml.safe_dump(dict(
        max_contact_loss=float("inf"), max_pen_loss=float("inf"),
        max_total_loss=float("inf"))))
    dataset = base / "motions+gen.yaml"
    t0 = time.perf_counter()
    cli.main(["create_dataset", "--motions_dir", str(motions), "--out",
              str(dataset), "--config", str(config), "--device", device.type])
    dataset_s = time.perf_counter() - t0
    files = listed_as_saved(str(dataset), saved, "phase 13a")
    lib = dataset_lib.load_dataset(humanoid_spec().build(device="cpu"),
                                   str(dataset), device="cpu")
    if lib.terrain_hf.shape[0] != len(files):
        raise AssertionError(f"phase 13a: {lib.terrain_hf.shape[0]} terrain "
                             f"slots for {len(files)} clips")
    for k, f in enumerate(files):
        _, _, clip_hf, min_point = clip_arrays(f)
        h, w = clip_hf.shape
        if not (np.array_equal(lib.terrain_hf[k, :h, :w].numpy(), clip_hf)
                and np.array_equal(lib.terrain_min_point[k].numpy(),
                                   np.asarray(min_point[:2], np.float32))):
            raise AssertionError(f"phase 13a: slot {k} of the terrain stack "
                                 f"is not {f}'s terrain")
    hf = lib.terrain_hf
    boxes = int((hf.amax((1, 2)) > hf.amin((1, 2))).sum())
    return dict(clips=len(files), boxes=boxes, stack=tuple(hf.shape),
                dataset_s=dataset_s,
                classes=sorted({Path(f).parent.name for f in files}))


def wall_edge_points(model, lib, sim, ids):
    """Contact points of ``sim`` (a row an env, ``ids`` its terrain slots)
    whose cell coordinate lies within WALL_EDGE cell of a grid line where
    the heightfield bends (the bilinear normal differs on its two sides:
    a box wall beside it), and of any grid line: two (n,) counts."""
    bidx = model.contact_point_body
    pos = sim.body_pos[:, bidx]
    x = pos + rot.quat_rotate(sim.body_rot[:, bidx],
                              model.contact_point_offset.expand(pos.shape))
    uv = (x[..., :2] - lib.terrain_min_point[ids][:, None]) / lib.terrain_dxdy
    hf = lib.terrain_hf[ids]
    dims = hf.shape[-2:]
    row = torch.arange(len(ids), device=hf.device)[:, None]
    near_any = torch.zeros(uv.shape[:2], dtype=torch.bool, device=hf.device)
    near_wall = torch.zeros_like(near_any)
    for a in (0, 1):
        c, o = uv[..., a], uv[..., 1 - a].clamp(0, dims[1 - a] - 1)
        k = torch.round(c)
        near = ((c - k).abs() < WALL_EDGE) & (k >= 1) & (k <= dims[a] - 2)
        k = k.long().clamp(1, dims[a] - 2)
        j0 = torch.floor(o).long().clamp(max=dims[1 - a] - 2)

        def h(i, j):
            return hf[row, i, j] if a == 0 else hf[row, j, i]
        bend = torch.zeros_like(near)
        for j in (j0, j0 + 1):
            bend |= (h(k + 1, j) - 2 * h(k, j) + h(k - 1, j)).abs() > 1e-6
        near_any |= near
        near_wall |= near & bend
    return near_wall.sum(1).cpu(), near_any.sum(1).cpu()


@torch.no_grad()
def iter_kernel_check(b, device):
    """13c: from (b)'s env as training left it, SETTLE control steps with
    the deterministic actor, then one control step through the kernel and
    the plain version, judged as in phase 3; the box-terrain rows in
    contact, and the contact points at a grid line beside a wall."""
    agent, lib, state = b["iters"][-1]["agent"], b["iters"][-1]["lib"], \
        b["state"]
    env, es = agent.env, state.env_state
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(0)
    for _ in range(SETTLE):
        es = env.step(lib, es, agent.act(state, es.obs), generator=g)
    hf = lib.terrain_hf
    box_slot = hf.amax((1, 2)) > hf.amin((1, 2))
    touching = torch.linalg.vector_norm(es.sim.contact_forces, dim=-1) > 0
    box_rows = box_slot[es.motion_ids] & touching.any(1)
    # a foot pressing a cell off its slot's median height: a box's top or
    # a pit's floor
    feet = torch.tensor([env.model.body_names.index(f"{side}_foot")
                         for side in ("right", "left")], device=device)
    ids = es.motion_ids
    cell = torch.round((es.sim.body_pos[:, feet, :2]
                        - lib.terrain_min_point[ids][:, None])
                       / lib.terrain_dxdy).long()
    cell[..., 0].clamp_(0, hf.shape[1] - 1)
    cell[..., 1].clamp_(0, hf.shape[2] - 1)
    under = hf[ids[:, None], cell[..., 0], cell[..., 1]]
    median = hf.flatten(1).median(1).values[ids][:, None]
    on_box = (((under - median).abs() > 0.05) & touching[:, feet]).any(1)
    if not box_rows.any():
        raise AssertionError("phase 13c: no row of a box-terrain slot in "
                             "contact")
    walls = wall_edge_points(env.model, lib, es.sim, ids)
    r = step_vs_plain(env.model, env, lib, es, agent.act(state, es.obs))
    r.update(envs=es.obs.shape[0], box_rows=int(box_rows.sum()),
             on_box=int(on_box.sum()), box_slots=int(box_slot.sum()),
             slots=hf.shape[0], walls=walls,
             box_slot=box_slot[ids].tolist(),
             points=ids.numel() * env.model.contact_point_body.numel(),
             s=time.perf_counter() - t0)
    return r


def iter_record_eval(base, device):
    """13d: record (one env a clip, one start fraction) and eval
    --diagnostics through iteration 0's record.yaml, restored from (b)'s
    checkpoint."""
    config = base / "record.yaml"
    cfg = yaml.safe_load(config.read_text())
    cfg["start_fractions"] = [0.0]  # the run-length cut (6 by default)
    config.write_text(yaml.safe_dump(cfg))
    sub.control_step_packed.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    results = cli.main(["record", "--config", str(config)])
    profiling.sync(device)
    record_s = time.perf_counter() - t0
    record_launches = sub.control_step_packed.launches
    files = dataset_files(cfg["dataset"])
    lib = ml.load_motion_lib(humanoid_spec().build(device="cpu"), files,
                             device="cpu")
    per_round = record.round_steps(lib, record.RecordConfig().max_steps)
    if len(results) != len(files) or record_launches != per_round:
        raise AssertionError(f"phase 13d: record rolled {len(results)} "
                             f"clips of {len(files)} and launched the "
                             f"kernel {record_launches} times, not one "
                             f"{per_round}-step round")
    for k, c in enumerate(results):
        if c is None:
            continue
        src = md.load_motion_data(files[k]).terrain
        h, w = src.hf.shape
        if (c.frames.ndim != 2 or c.frames.shape[1] != 34
                or not np.isfinite(c.frames).all()
                or not np.isfinite(c.contacts).all()):
            raise AssertionError(f"phase 13d: recorded clip {k}: frames "
                                 f"{c.frames.shape}, not finite (T, 34)")
        if not (np.array_equal(c.terrain.hf[:h, :w], src.hf)
                and np.allclose(c.terrain.min_point, src.min_point[:2],
                                rtol=0, atol=0)):
            raise AssertionError(f"phase 13d: recorded clip {k} does not "
                                 f"carry {files[k]}'s terrain")
    sub.control_step_packed.launches = 0
    t0 = time.perf_counter()
    test, report = cli.main(["eval", "--config", str(config), "--num_envs",
                             str(EVAL_ENVS), "--test_steps",
                             str(ITER_TEST_STEPS), "--diagnostics"])
    profiling.sync(device)
    eval_s = time.perf_counter() - t0
    eval_launches = sub.control_step_packed.launches
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    if eval_launches != int(test["test_steps"]):
        raise AssertionError(f"phase 13d: eval {eval_launches} launches over "
                             f"{int(test['test_steps'])} steps")
    if not all(torch.isfinite(v).all() for v in test.values()):
        raise AssertionError("phase 13d: eval statistics not finite")
    weights, acts = report["weights"], report["activations"]
    names = ({f"params/{net}_trunk/Dense_{i}" for net in ("actor", "critic")
              for i in range(3)}
             | {"params/actor_head", "params/critic_head"})
    if set(weights) != names or not {n[len("params/"):] for n in names} \
            <= set(acts):
        raise AssertionError(f"phase 13d: diagnostics rows {sorted(weights)}"
                             f", {sorted(acts)}: not the JAX package's names")
    recorded = [r for r in results if r is not None]
    return dict(recorded=len(recorded), motions=len(results),
                record_s=record_s, record_launches=record_launches,
                per_round=per_round, eval_s=eval_s,
                eval_launches=eval_launches,
                eval_steps=int(test["test_steps"]),
                test_reward=float(test["mean_reward"]),
                rows=(len(weights), len(acts)), peak_gb=peak_gb)


def tree_diff(got, want, path=""):
    """The paths where two checkpoint trees (nested dicts of tensors and
    numbers) differ, compared bit for bit on the CPU; the generator's
    stream is left out."""
    if isinstance(want, dict):
        if set(got) != set(want):
            return [path or "/"]
        return sum((tree_diff(got[k], want[k], f"{path}/{k}") for k in want
                    if k != "generator"), [])
    if isinstance(want, torch.Tensor):
        return [] if torch.equal(got.cpu(), want.cpu()) else [path]
    return [] if got == want else [path]


def iter_mdm(d, mdm_dir, device):
    """13e: setup_iter --iter 1, iteration 1's create_dataset where 13d
    recorded a clip, and train_mdm warm-started (--init_from) from phase
    7's run for one epoch; train_mdm.train is wrapped to read the state it
    starts from. Then the same call again, which resumes from its own
    checkpoint and ignores --init_from."""
    from parc_torch.pipeline import train_mdm as train_mdm_lib
    configs = cli.main(["setup_iter", "--root", str(ITER_ROOT), "--iter",
                        "1"])
    for name, path in configs.items():
        if yaml.safe_load(Path(path).read_text()).get("device") != \
                str(device):
            raise AssertionError(f"phase 13e: setup_iter {name}: {path}")
    base = ITER_ROOT / "iter_0"
    extra, dataset_s = [], None
    if d["recorded"]:
        t0 = time.perf_counter()
        cli.main(["create_dataset", "--config",
                  str(base / "create_dataset.yaml")])
        dataset_s = time.perf_counter() - t0
        dataset = yaml.safe_load(
            (base / "create_dataset.yaml").read_text())["out"]
        if len(dataset_files(dataset)) != d["recorded"]:
            raise AssertionError(f"phase 13e: iteration 1's dataset lists "
                                 f"{len(dataset_files(dataset))} clips of "
                                 f"{d['recorded']} recorded")
    else:
        dataset = str(base / "motions+gen.yaml")
        extra = ["--dataset", dataset]
    want = ckpt_lib.restore(str(mdm_dir / "checkpoints"))
    started, train = [], train_mdm_lib.train

    def spy(mdm, lib, cfg, state=None, **kw):
        started.append((mdm, None if state is None
                        else mdm.persistent_state(state)))
        return train(mdm, lib, cfg, state=state, **kw)
    argv = ["train_mdm", "--config", str(configs["train_mdm"]),
            "--init_from", str(mdm_dir), "--max_epochs", "1"] + extra
    out = Path(yaml.safe_load(Path(configs["train_mdm"]).read_text())
               ["out_dir"])
    train_mdm_lib.train = spy
    try:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        state = cli.main(argv)
        profiling.sync(device)
        train_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        t0 = time.perf_counter()
        again = cli.main(argv)
        profiling.sync(device)
        resume_s = time.perf_counter() - t0
    finally:
        train_mdm_lib.train = train
    first = started[0][1]
    if first is None or tree_diff(first, want):
        raise AssertionError(
            "phase 13e: the state train_mdm started from differs from "
            "phase 7's checkpoint in "
            + ("everything (no --init_from state)" if first is None
               else str(tree_diff(first, want))))
    iters = train_mdm_lib.MDMTrainerConfig().iters_per_epoch
    with open(out / "log.tsv") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    losses = [float(r["Loss"]) for r in rows]
    if len(rows) != 1 or not np.isfinite(losses).all():
        raise AssertionError(f"phase 13e: train_mdm logged {len(rows)} "
                             f"epochs, losses {losses}")
    if state.step != int(want["step"]) + iters:
        raise AssertionError(f"phase 13e: warm-started MDM at step "
                             f"{state.step}, expected {int(want['step'])} + "
                             f"{iters}")
    for net in (state.net, state.ema_net):
        for k, p in net.named_parameters():
            if not torch.isfinite(p).all():
                raise AssertionError(f"phase 13e: MDM parameter {k} is not "
                                     f"finite")
    own = ckpt_lib.restore(str(out / "checkpoints"))
    if ckpt_lib.all_steps(str(out / "checkpoints")) != [1]:
        raise AssertionError(f"phase 13e: checkpoints "
                             f"{ckpt_lib.all_steps(str(out / 'checkpoints'))}"
                             f" in {out}, expected epoch 1")
    mdm, second = started[1]
    if second is not None or again.step != state.step or \
            tree_diff(mdm.persistent_state(again), own):
        raise AssertionError("phase 13e: the second train_mdm did not "
                             "resume from its own checkpoint (it took "
                             "--init_from, or trained on)")
    moved = max((state.net.get_parameter(k).detach().cpu() - v).abs().max()
                .item() for k, v in want["params"].items())
    return dict(dataset_s=dataset_s, train_s=train_s,
                resume_s=resume_s, loss=losses[0], step=state.step,
                start_step=int(want["step"]), iters=iters, moved=moved,
                peak_gb=peak_gb, recorded=d["recorded"])


def parc_iter_phase(t, device, smi):
    """Phase 13: one PARC iteration's hand-off, from phases 5, 7 and 8's
    outputs, through the CLI and the configs setup_iter wrote in 8c."""
    t0 = time.perf_counter()
    a = iter_dataset(t, device)
    print(f"phase 13a: iter_0/motions+gen.yaml: create_dataset over phase "
          f"5's 3 bench clips and phase 8's clips ({', '.join(a['classes'])}"
          f") in {a['dataset_s']:.1f} s: {a['clips']} clips listed, each "
          f"reloaded equal to what its stage saved; terrains stacked "
          f"{a['stack'][0]} x {a['stack'][1]} x {a['stack'][2]}, one slot a "
          f"clip, {a['boxes']} of them not flat | {smi}")
    base = ITER_ROOT / "iter_0"
    b = counted_train(["--config", str(base / "train_tracker.yaml"),
                       "--test_steps", str(ITER_TEST_STEPS)],
                      base / "tracker", ITER_TRAIN_ITERS, device,
                      "phase 13b")
    for i, it in enumerate(b["iters"]):
        print(f"phase 13b: iteration {i + 1}: {it['wall_s']:.3f} s, "
              f"{PPOConfig().steps_per_iter * NUM_ENVS / it['wall_s']:.1f} "
              f"samples/s (rollout {it.get('rollout', float('nan')):.1f} ms, "
              f"update {it.get('update', float('nan')):.1f} ms), "
              f"control-step launches {it['launches']} | {smi}")
    m = b["iters"][-1]["metrics"]
    print(f"phase 13b: train_tracker --config iter_0/train_tracker.yaml "
          f"through the CLI on {a['clips']} clips: {NUM_ENVS} envs x "
          f"{ITER_TRAIN_ITERS} iterations of PPOConfig(), {b['train_s']:.1f} "
          f"s in all; the log's Samples_Per_Sec "
          f"{', '.join(f'{r:.1f}' for r in b['log_rate'])}; test rollout "
          f"{b['test']['steps']} steps (cut to {ITER_TEST_STEPS}) in "
          f"{b['test']['wall_s']:.2f} s ({b['test']['launches']} launches); "
          f"last iteration: actor {m.actor_loss.item():.4g}, critic "
          f"{m.critic_loss.item():.4g}, mean reward "
          f"{m.mean_reward.item():.4f}; {b['launches']} launches; peak "
          f"device memory {b['peak_gb']:.2f} GB | {smi}")
    c = iter_kernel_check(b, device)
    tol_s, tol_c, spared = judge(c, "phase 13c parc_iter control step")
    wall, edge = c["walls"]
    spared_boxes = [k for k in spared if c["box_slot"][k]]
    print(f"phase 13c: (b)'s env ({c['envs']} envs over {c['slots']} "
          f"terrain slots, {c['box_slots']} not flat; after {SETTLE} steps, "
          f"{c['s']:.1f} s with the step's four evaluations): "
          f"{c['box_rows']} rows of box-terrain slots in contact, "
          f"{c['on_box']} with a foot on a box's top or a pit's floor; "
          f"{int(wall.sum())} of {c['points']} contact points within "
          f"{WALL_EDGE} cell of a grid line beside a wall, in "
          f"{int((wall > 0).sum())} envs ({int(edge.sum())} of any grid "
          f"line); kernel vs plain control step "
          + ", ".join(f"{f} {v:.1e}" for f, v in c["step_err"].items())
          + f" (judge's limits state {tol_s:.1e}, contact {tol_c:.1e}; "
          f"{len(spared)} env(s) excused or taken out, "
          f"{len(spared_boxes)} of them on a box-terrain slot, with "
          f"{sum(int(wall[k]) for k in spared)} contact points at a grid "
          f"line beside a wall); max|contact| {c['max_contact']:.1f} N "
          f"| {smi}")
    d = iter_record_eval(base, device)
    print(f"phase 13d: record --config iter_0/record.yaml (one start "
          f"fraction) from (b)'s checkpoint: recorded {d['recorded']}/"
          f"{d['motions']} in {d['record_s']:.1f} s, {d['record_launches']} "
          f"launches (one {d['per_round']}-step round, "
          f"{d['record_launches'] / d['record_s']:.1f} steps/s); eval "
          f"--diagnostics at {EVAL_ENVS} envs: {d['eval_steps']} steps in "
          f"{d['eval_s']:.1f} s, {d['eval_launches']} launches, test reward "
          f"{d['test_reward']:.4f}, {d['rows'][0]} weight rows "
          f"(params/...) and {d['rows'][1]} activation rows under the JAX "
          f"package's names; peak device memory {d['peak_gb']:.2f} GB "
          f"| {smi}")
    e = iter_mdm(d, WORK / "mdm", device)
    windows = e["iters"] * MDMConfig().batch_size
    print(f"phase 13e: setup_iter --iter 1; "
          + (f"create_dataset --config iter_0/create_dataset.yaml over the "
             f"{e['recorded']} recorded clip(s) in {e['dataset_s']:.1f} s; "
             if e["recorded"] else
             "13d recorded no clip, so no iteration-1 dataset: train_mdm "
             "runs on iter_0/motions+gen.yaml; ")
          + f"train_mdm --config iter_1/train_mdm.yaml --init_from phase "
          f"7's run: started from phase 7's checkpoint bit for bit (step "
          f"{e['start_step']}), 1 epoch of {e['iters']} steps x "
          f"{MDMConfig().batch_size} windows in {e['train_s']:.1f} s "
          f"({windows / e['train_s']:.1f} windows/s, set-up included), loss "
          f"{e['loss']:.4f}, step {e['step']}, largest parameter move "
          f"{e['moved']:.3e}; peak device memory {e['peak_gb']:.2f} GB; the "
          f"same call again resumed from iter_1/mdm's checkpoint, "
          f"--init_from ignored, in {e['resume_s']:.1f} s | {smi}")
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")
    return dict(launches=b["launches"] + d["record_launches"]
                + d["eval_launches"])


def dp_worker(argv):
    """The ranks of phase 10, started by torchrun (``--dp-worker``)."""
    if argv[0] == "a":
        dp_worker_a(argv[1])
    elif argv[0] == "b":
        dp_worker_b(argv[1:])
    elif argv[0] == "nccl1":
        dp_worker_nccl1()
    else:
        raise SystemExit(f"unknown worker {argv[0]!r}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs only "
                 "on an NVIDIA GPU")
    device = torch.device("cuda")
    shutil.rmtree(WORK, ignore_errors=True)

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1: device {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32} (set False)")

    from concurrent.futures import ThreadPoolExecutor

    from parc_torch import cuda_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:  # the kernel and its phase-clock build
        so_lib, _ = pool.map(sub.library, ((), sub.PHASE_CLOCKS))
    so = cuda_build.library_path(sub.LIBRARY, sub.SOURCES)
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "stack frame" in ln]
    model = humanoid_spec().build(device=device)
    npt = model.contact_point_body.shape[0]
    blocks = so_lib.parc_control_step_blocks(NUM_ENVS, model.num_bodies)
    smem = so_lib.parc_control_step_smem_bytes(model.num_bodies,
                                               model.dof_size, npt)
    print(f"phase 2: built {so.relative_to(cuda_build.BUILD_DIR.parent.parent)}"
          f" from parc_torch/csrc/{', '.join(sub.SOURCES)} with nvcc sm_90a "
          f"(and its phase-clock variant, in parallel) in "
          f"{time.perf_counter() - t0:.1f} s | " + " | ".join(ptxas)
          + f" | {blocks} blocks of 128 threads at {NUM_ENVS} envs, "
          f"{smem} B of shared memory each")

    lib = build_lib(model, device)
    k = check_kernel(model, lib, device)
    bytes_s, ops_s = k["bytes"] / mem_rate(smi), k["ops"] / F32_RATE
    bound_s = max(bytes_s, ops_s)
    bound_by = "bytes" if bytes_s >= ops_s else "operations"
    print(f"phase 3d: kernel {k['ms']:.4f} ms ({k['timed_by']}, mean of "
          f"200 launches; {k['call_ms']:.4f} ms per wrapper call by CUDA "
          f"events), plain {k['plain_ms']:.3f} ms per control step (2 x 2 "
          f"substeps, contact included) at {NUM_ENVS} envs | {smi}")
    print(f"phase 3e: bound {1e3 * bound_s:.4f} ms by {bound_by} "
          f"({k['bytes']} B: {1e3 * bytes_s:.4f} ms; {k['ops']} f32 ops: "
          f"{1e3 * ops_s:.4f} ms); the kernel at {bound_s / (k['ms'] / 1e3):.3f} "
          f"of its bound; max abs state error {k['max_abs_err']:.3e}")
    total = sum(k["cycles"].values())
    print("phase 3f: where a substep's time goes (phase clock, clock64 "
          "cycles of a block's first thread per substep, mean of the "
          f"blocks): {total:.0f} cycles = "
          + ", ".join(f"{name} {c:.0f} ({c / total:.3f})"
                      for name, c in k["cycles"].items()))
    q = quadruped_phase(device, smi)

    r = rollout(model, lib, device)
    busy = ("not measured (no device time in the trace)"
            if r["busy_ms"] is None else
            f"{r['busy_ms']:.3f} ms per control step, idle share "
            f"{1.0 - r['busy_ms'] / r['step_ms']:.3f}")
    print(f"phase 4: rollout {NUM_ENVS} envs x {ROLLOUT_STEPS} steps, median "
          f"of {ROLLOUT_RUNS} runs {r['wall_s']:.3f} s: "
          f"{r['env_steps_per_s']:.1f} env-steps/s (min {r['rate_min']:.1f}, "
          f"max {r['rate_max']:.1f}), {r['step_ms']:.3f} ms per control step "
          f"(policy {r['policy_ms']:.3f}, physics {r['physics_ms']:.3f}, obs "
          f"{r['obs_ms']:.3f}, env step {r['env_step_ms']:.3f} ms timed "
          f"alone); device busy {busy}; mean reward {r['mean_reward']:.4f} "
          f"(first run); dones {r['dones']}; control-step launches "
          f"{r['launches']} (first run); setup {r['setup_s']:.1f} s; kernel "
          f"vs plain control step "
          + ", ".join(f"{f} {v:.1e}" for f, v in r["step_err"].items())
          + f" | {smi}")
    judge(r, "phase 4 control step")

    t = train(device)
    for i, it in enumerate(t["iters"]):
        print(f"phase 5: iteration {i + 1}: {it['wall_s']:.3f} s, "
              f"{PPOConfig().steps_per_iter * NUM_ENVS / it['wall_s']:.1f} "
              f"samples/s (rollout {it.get('rollout', float('nan')):.1f} ms, "
              f"update {it.get('update', float('nan')):.1f} ms), "
              f"control-step launches {it['launches']} | {smi}")
    m = t["iters"][-1]["metrics"]
    print(f"phase 5: train_tracker through the CLI: {NUM_ENVS} envs x "
          f"{TRAIN_ITERS} iterations of PPOConfig() (obs dim {t['obs_dim']}, "
          f"3x2048 bf16 trunks), {t['train_s']:.1f} s in all, dataset "
          f"{t['dataset_s']:.1f} s; the log's Samples_Per_Sec "
          f"{', '.join(f'{r:.1f}' for r in t['log_rate'])}; test rollout "
          f"{t['test']['steps']} steps in {t['test']['wall_s']:.2f} s "
          f"({t['test']['launches']} launches); last iteration: actor "
          f"{m.actor_loss.item():.4g}, critic {m.critic_loss.item():.4g}, "
          f"bound {m.bound_loss.item():.4g}, clip frac "
          f"{m.clip_frac.item():.4g}, mean reward {m.mean_reward.item():.4f}; "
          f"largest parameter move {max(t['moved'].values()):.3e}, smallest "
          f"{min(t['moved'].values()):.3e}; {t['launches']} launches; peak "
          f"device memory {t['peak_gb']:.2f} GB; checkpoint at step "
          f"{TRAIN_ITERS} | {smi}")
    r6 = record_and_eval(t, device)
    print(f"phase 6: record from the step-{TRAIN_ITERS} checkpoint: recorded "
          f"{r6['recorded']}/{r6['motions']} in {r6['record_s']:.1f} s, "
          f"{r6['record_launches']} steps ({r6['record_launches'] // r6['per_round']}"
          f" rounds of {r6['per_round']}); eval --diagnostics at {EVAL_ENVS} "
          f"envs: {r6['eval_steps']} steps in {r6['eval_s']:.1f} s, "
          f"{r6['eval_launches']} launches, {r6['layers']} layers reported "
          f"| {smi}")
    for c, what in zip(r6["checks"], ("record", "eval")):
        print(f"phase 6: {what} env ({c['envs']} envs, after {SETTLE} steps): "
              f"kernel vs plain control step "
              + ", ".join(f"{f} {v:.1e}" for f, v in c["step_err"].items())
              + f" (tolerance state {c['tol'][0]:.1e}, contact "
              f"{c['tol'][1]:.1e}); max|contact| {c['max_contact']:.1f} N")
    mdm_phase(t, device, smi)
    k8 = kin_gen_phase(t, device, smi)
    p9 = parkour_phase(t, device, smi)
    p10 = dp_phase(t, p9, device, smi)
    p11 = tools_phase(t, k8, device, smi)
    p12 = viewer_phase(k8, t, device, smi)
    p13 = parc_iter_phase(t, device, smi)

    print(json.dumps({"kernels": [{
        "name": "control_step", "route": "cuda",
        "source": "parc_torch/csrc/control_step.cu",
        "replaces": "parc_tpu/physics/pallas_substep.py:286 "
                    "(_substep_kernel) + parc_tpu/physics/engine.py:187 "
                    "(compute_contact_forces)",
        "launches": r["launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": 1e3 * bound_s,
        "bound_by": bound_by, "library_ms": None,
        "launches_by_path": {"rollout": r["launches"],
                             "train_tracker": t["launches"],
                             "record": r6["record_launches"],
                             "eval": r6["eval_launches"],
                             "kin_gen": k8["launches"],
                             "parkour": p9["launches"],
                             "ddp": p10["launches"],
                             "fidelity": p11["launches"],
                             "studio": p12["launches"],
                             "parc_iter": p13["launches"],
                             "quadruped": q["launches"]},
        "quadruped": {"ms": q["ms"], "plain_ms": q["plain_ms"],
                      "bound_ms": q["bound_ms"], "bound_by": q["bound_by"],
                      "max_abs_err": q["max_abs_err"]}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(sys.argv[2:])
    else:
        main()
