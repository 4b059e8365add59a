#!/usr/bin/env python3
"""Smoke run of parc_torch on one NVIDIA GPU: build the kernel, check it,
drive the tracker rollout, training, the MDM, kin-gen and the parkour env
at full width, and report.

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
   restores) and ``eval --diagnostics`` at 64 envs, through the CLI: the
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
   0.4 m, 32 rollouts a terrain, top-2, 500 Adam iterations, mirroring) with
   the MDM at MDMConfig() (bf16 encoder), the keep thresholds at infinity
   so that keep -> optimize -> mirror -> save runs on a 200-step MDM; run
   length cut from 10 s: (a) ``kin_gen`` through the CLI, 2 motion slots
   with 2 terrains a batch (64 rows a denoise step), 5 s paths; (b) the
   sequential mode once, 1 slot, 2 s; each with its seconds, windows, rows,
   frames generated per second, denoiser calls (gated at windows x 201),
   native A* ms per plan, the contact optimization's ms per Adam iteration
   and its summed loss before and after (gated: finite, not raised), how
   many rollouts the default thresholds would have kept, and no physics
   launch; (c) ``optimize`` on two of (a)'s clips (500 of its default 3,000
   iterations), ``augment`` (2 motions, 200 of 1,000 iterations),
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
   against the plain version, as in phase 3, on the parkour state after a
   replan, the mgdm rows on the platform slot of the grown terrain stack;
   (c) one train_iter each of the vision policies (dm_cnn_mlp, dm_vit,
   bf16 trunks) on that env at 4096 envs, an act call's ms, and a forward
   pass bf16 against f32 within (0, 2e-2) relative; (d) ``record`` (one
   env per clip, one start fraction) and ``eval`` (64 envs) from 9a's
   checkpoint with the parkour config, both gated to build the deepmimic
   env with SimParams(). The vision nets and the replans reach no
   hand-written kernel (the JAX package runs them outside Pallas too).
The line before the last holds the kernel report as JSON; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0)
before that line; without CUDA the script exits non-zero and runs nothing.
"""

import contextlib
import copy
import csv
import dataclasses
import glob
import json
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
from parc_torch.utils.terrain import Terrain

NUM_ENVS = 4096
TRAIN_ITERS = 3  # phase 5; the test rollout runs once, at iteration 1
EVAL_ENVS = 64   # phase 6
SETTLE = 10      # phase 6: control steps before the kernel-vs-plain step
WORK = Path(__file__).resolve().parent / "build" / "chip_smoke"
ROLLOUT_STEPS = 64
ROLLOUT_RUNS = 5  # 64-step runs timed; the first is the counted main path
ATOL = 2e-4  # tests/test_pallas.py:190-193
CONTACT_ATOL, CONTACT_RTOL = 2e-3, 1e-5  # tests/test_torch_engine.py
H = 1.0 / 120.0
LOWER = 0.04  # m the phase-3 states are lowered into their terrain
STATE_CHECK = ("root_pos", "joint_rot", "dof_vel", "body_pos")

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
KIN_SEQ_SECONDS = 2.0  # 8b, one motion slot
OPT_ITERS, AUG_MOTIONS, AUG_ITERS = 500, 2, 200  # 8c (defaults 3000, 1000)
KIN_CHECK_ROWS, KIN_CHECK_SEED = 8, 3  # 8d, 8e
# 8d, card vs CPU in f32, relative max errors: a window's frames over a
# box terrain, both given the CPU's local heightfield; the motion-opt loss
# terms and gradient
KIN_FRAMES_TOL = 1e-4
OPT_TERMS_TOL, OPT_GRAD_TOL = 1e-5, 1e-4
# phase 9: the parkour env at 4096 envs, PARKOUR_MGDM of them mgdm rows;
# its test rollout (and 9d's eval) cut from 300 steps
PARKOUR_MGDM, PARKOUR_TEST_STEPS = 512, 100


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
    ``kernel``; None if the trace shows no such device time."""
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
                  if e.device_type == DeviceType.CUDA and kernel in e.name)
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


def contact_excess(got, want):
    """max(|got - want| - CONTACT_RTOL |want|): what the contact forces'
    error spends of the absolute tolerance."""
    return ((got.double() - want.double()).abs()
            - CONTACT_RTOL * want.double().abs()).max().item()


def judge(state_err, contact_err, plain64, kernel64, what):
    """Fail unless the kernel agrees with the plain version: the state
    within 2e-4 and the contact forces within 2e-3 N + rtol 1e-5, or,
    where f32 itself is less accurate than that, within twice the plain f32
    version's own error against float64; and the kernel's own error against
    float64 (or within the tolerance) at most 1.5x the plain version's on
    the state and 2x on the contact forces. The contact forces pass
    thresholds (a point in or out of contact, the force clamp, friction
    saturation), so which of two f32 versions lands nearer float64 there
    swings more from state to state: on the fallen characters of the
    rollout's end the kernel was 1.55x, in phase 3b 0.86x."""
    tol_s = max(ATOL, 2.0 * plain64["state"])
    tol_c = max(CONTACT_ATOL, 2.0 * plain64["contact"])
    ok = (state_err <= tol_s and contact_err <= tol_c
          and kernel64["state"] <= max(ATOL, 1.5 * plain64["state"])
          and kernel64["contact"] <= max(CONTACT_ATOL,
                                         2.0 * plain64["contact"]))
    if not ok:
        raise AssertionError(
            f"{what}: kernel disagrees with plain version: state "
            f"{state_err} (tolerance {tol_s}), contact {contact_err} "
            f"(tolerance {tol_c}); vs float64 kernel {kernel64}, plain "
            f"{plain64}")
    return tol_s, tol_c


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
        want, want_c = sub.control_step_packed_reference(
            model, params, terrain, state_p, const_p, tidx, sim_steps)
        want64, want64_c = sub.control_step_packed_reference(
            model64, params, terrain64, state_p.double(), const_p.double(),
            tidx, sim_steps)
        if not (torch.isfinite(got).all() and torch.isfinite(got_c).all()):
            raise AssertionError(f"kernel output not finite ({mode}, "
                                 f"hard={hard}, sim_steps={sim_steps})")
        errs = {name: (sub.unpack(got, layout, name)
                       - sub.unpack(want, layout, name)).abs().max().item()
                for name, _ in layout.fields}
        state_err = max(errs.values())
        contact_err = contact_excess(got_c, want_c)
        plain64 = {"state": (want.double() - want64).abs().max().item(),
                   "contact": contact_excess(want_c, want64_c)}
        kernel64 = {"state": (got.double() - want64).abs().max().item(),
                    "contact": contact_excess(got_c, want64_c)}
        what = (f"{'b' if sim_steps > 1 else 'a'} {mode:11s} "
                f"{'hard' if hard else 'soft'} {sim_steps}x{params.substeps}")
        tol_s, tol_c = judge(state_err, contact_err, plain64, kernel64, what)
        worst = max(worst, state_err)
        print(f"phase 3{what}: max|kernel-plain| state {state_err:.3e} "
              f"(tolerance {tol_s:.1e}), contact {contact_err:.3e} past rtol "
              f"(tolerance {tol_c:.1e}); vs float64: kernel {kernel64['state']:.2e} / "
              f"{kernel64['contact']:.2e}, plain {plain64['state']:.2e} / "
              f"{plain64['contact']:.2e}; max|contact| "
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
    """One control step of env from es: kernel, plain f32, and plain
    float64 (the yardstick of what f32 can hold here); the errors, for
    judge()."""
    terrain = lib_terrain(lib)
    kw = dict(terrain_idx=es.motion_ids,
              sim_steps=env.cfg.sim_steps_per_control)
    got = engine.control_step(model, env.sim_params, terrain, es.sim,
                              action, **kw)
    plain = engine.control_step(model, env.sim_params, terrain, es.sim,
                                action, step_fn=sub.control_step_packed_reference,
                                **kw)
    sim64 = engine.SimState(**{k: v.double() for k, v in vars(es.sim).items()})
    plain64 = engine.control_step(as_f64(model), env.sim_params,
                                  terrain_f64(terrain), sim64,
                                  action.double(),
                                  step_fn=sub.control_step_packed_reference,
                                  **kw)

    def err(a, b):
        return {"state": max((getattr(a, f).double() - getattr(b, f).double())
                             .abs().max().item() for f in STATE_CHECK),
                "contact": contact_excess(a.contact_forces, b.contact_forces)}
    step_err = {f: (getattr(got, f) - getattr(plain, f)).abs().max().item()
                for f in STATE_CHECK}
    step_err["contact_forces"] = contact_excess(got.contact_forces,
                                                plain.contact_forces)
    plain64_err, kernel64_err = err(plain, plain64), err(got, plain64)
    step_err.update({f"plain_vs_f64_{k}": v for k, v in plain64_err.items()})
    step_err.update({f"kernel_vs_f64_{k}": v for k, v in kernel64_err.items()})
    return dict(step_err=step_err, plain64_err=plain64_err,
                kernel64_err=kernel64_err,
                max_contact=got.contact_forces.abs().max().item())


def judge_step(r, what):
    """judge() on step_vs_plain's errors."""
    e = r["step_err"]
    return judge(max(e[f] for f in STATE_CHECK), e["contact_forces"],
                 r["plain64_err"], r["kernel64_err"], what)


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
    width. Each train_iter and the trainer's test rollout are wrapped to
    count the kernel's launches, time them, and keep the metrics; the
    wrappers are taken off before returning."""
    shutil.rmtree(WORK, ignore_errors=True)
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
                          wall_s=wall, metrics=out[1], agent=agent, **ms))
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
        state = cli.main(["train_tracker", "--dataset", dataset, "--out_dir",
                          str(tracker), "--num_envs", str(NUM_ENVS),
                          "--max_iters", str(TRAIN_ITERS), "--device",
                          device.type])
        profiling.sync(device)
        train_s = time.perf_counter() - t0
        launches = sub.control_step_packed.launches
        peak_gb = (torch.cuda.max_memory_allocated(device) / 1e9
                   if device.type == "cuda" else float("nan"))
    finally:
        PPOAgent.train_iter = train_iter
        train_tracker.make_test_fn = make_test_fn

    steps = PPOConfig().steps_per_iter
    samples = TRAIN_ITERS * steps * NUM_ENVS
    if [it["launches"] for it in iters] != [steps] * TRAIN_ITERS:
        raise AssertionError(f"control-step launches per train_iter "
                             f"{[it['launches'] for it in iters]}, expected "
                             f"{steps} each")
    if len(tests) != 1 or tests[0]["launches"] != tests[0]["steps"]:
        raise AssertionError(f"test rollouts {tests}: expected one, with one "
                             f"launch per step")
    if launches != samples // NUM_ENVS + tests[0]["steps"]:
        raise AssertionError(f"{launches} launches in the whole run")
    agent = iters[-1]["agent"]
    for i, it in enumerate(iters):
        m = it["metrics"]
        for name in ("actor_loss", "critic_loss", "bound_loss", "mean_reward"):
            if not torch.isfinite(getattr(m, name)).all():
                raise AssertionError(f"iteration {i + 1}: {name} not finite")
    moved = {}
    for k, p in agent.net.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"parameter {k} is not finite")
        moved[k] = (p.detach() - start[k]).abs().max().item()
    if min(moved.values()) <= 0.0:
        raise AssertionError(f"parameters did not move: {moved}")
    if float(state.sample_count) != samples:
        raise AssertionError(f"sample_count {float(state.sample_count)}, "
                             f"expected {samples}")
    if float(state.obs_norm.count) != samples:
        raise AssertionError(f"normalizer count {float(state.obs_norm.count)}"
                             f", expected {samples}")
    if ckpt_lib.all_steps(str(tracker / "checkpoints")) != [TRAIN_ITERS]:
        raise AssertionError("no checkpoint at step "
                             f"{TRAIN_ITERS} in {tracker / 'checkpoints'}")
    return dict(iters=iters, test=tests[0], launches=launches,
                dataset=dataset, tracker=str(tracker), dataset_s=dataset_s,
                train_s=train_s, obs_dim=agent.env.obs_dim,
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
    sub.control_step_packed.launches = 0
    t0 = time.perf_counter()
    results = cli.main(["record", "--dataset", t["dataset"], "--tracker_dir",
                        t["tracker"], "--out_dir", str(WORK / "recorded"),
                        "--device", device.type])
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
    lib = ml.load_motion_lib(humanoid_spec().build(),
                             dataset_files(t["dataset"]), device="cpu")
    per_round = record.round_steps(lib, record.RecordConfig().max_steps)
    if record_launches % per_round != 0 or record_launches == 0:
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
        c["tol"] = judge_step(c, f"phase 6 {what} control step")
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
        r["root_travel"] = (f34[:, -1, :2] - prev34[:, -1, :2]).norm(
            dim=-1).mean().item() if name != "DDPM" else float("nan")
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


def run_kin_gen(t, device, name, motions, terrains_per_batch, seconds):
    """One kin_gen through the CLI from phase 7's checkpoint on phase 5's
    dataset at KinGenConfig() width, the keep thresholds at infinity."""
    out = WORK / "gen" / name
    shutil.rmtree(out, ignore_errors=True)
    config = WORK / f"{name}.yaml"
    config.write_text(yaml.safe_dump(dict(
        max_contact_loss=float("inf"), max_pen_loss=float("inf"),
        max_total_loss=float("inf"), terrains_per_batch=terrains_per_batch,
        path_cfg=dict(max_seconds=seconds))))
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
    configs = cli.main(["setup_iter", "--root", str(WORK / "parc"), "--iter",
                        "0"])
    for name, path in configs.items():
        with open(path) as f:
            if yaml.safe_load(f).get("device") != str(device):
                raise AssertionError(f"setup_iter {name}: {path}")
    saved = {}
    for p in glob.glob(str(WORK / "gen" / "*" / "*.npz")):
        c = md.load_motion_data(p)
        saved[str(Path(p).resolve())] = (c.frames, c.contacts, c.terrain.hf)
    t0 = time.perf_counter()
    cli.main(["create_dataset", "--motions_dir", str(WORK / "gen"), "--out",
              str(WORK / "gen.yaml"), "--config", str(config)])
    out["dataset_s"] = time.perf_counter() - t0
    files = [str(Path(f).resolve()) for f in dataset_files(
        str(WORK / "gen.yaml"))]
    if sorted(files) != sorted(saved):
        raise AssertionError(f"create_dataset listed {len(files)} of "
                             f"{len(saved)} clips")
    for f in files:
        c = md.load_motion_data(f)
        for a, b in zip((c.frames, c.contacts, c.terrain.hf), saved[f]):
            if not np.array_equal(a, b):
                raise AssertionError(f"{f} reloads unlike what was saved")
    out.update(opt=rec["opt"], clips=len(files), classes=sorted(
        {Path(f).parent.name for f in files}))
    return out


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
                    KIN_SECONDS)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    b = run_kin_gen(t, device, "kin_seq", 1, 1, KIN_SEQ_SECONDS)
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
    against the plain version on the state after the replan, whose mgdm
    rows stand on the platform slot of the grown terrain stack."""
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
    r = step_vs_plain(env.model, env, lib, after,
                      agent.act(state, after.obs))
    r["tol"] = judge_step(r, "phase 9b parkour control step")
    return dict(step_replan_ms=with_replan, step_ms=without,
                replan_wall_ms=replan_wall, replan_busy_ms=busy,
                stack=tuple(lib.terrain_hf.shape), slot=slot, check=r)


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
    lib = ml.load_motion_lib(humanoid_spec().build(),
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
    c = s["check"]
    print(f"phase 9b: parkour env after a replan ({NUM_ENVS} envs, terrain "
          f"stack {s['stack']}, mgdm rows on slot {s['slot']}): kernel vs "
          f"plain control step "
          + ", ".join(f"{f} {v:.1e}" for f, v in c["step_err"].items())
          + f" (tolerance state {c['tol'][0]:.1e}, contact "
          f"{c['tol'][1]:.1e}); max|contact| {c['max_contact']:.1f} N "
          f"| {smi}")
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


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs only "
                 "on an NVIDIA GPU")
    device = torch.device("cuda")

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
    judge_step(r, "phase 4 control step")

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
                             "parkour": p9["launches"]}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
