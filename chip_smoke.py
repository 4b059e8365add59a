#!/usr/bin/env python3
"""Smoke run of parc_torch on one NVIDIA GPU: build the kernel, check it,
drive the tracker rollout at full width, and report.

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
   as in phase 3.
The line before the last holds the kernel report as JSON; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0)
before that line; without CUDA the script exits non-zero and runs nothing.
"""

import dataclasses
import json
import subprocess
import sys
import time

import torch

from parc_torch.anim import char_model as cm
from parc_torch.anim import motion_lib as ml
from parc_torch.data.humanoid import humanoid_spec
from parc_torch.data.synthetic import standing_clip, walking_clip
from parc_torch.envs.base import EnvConfig
from parc_torch.envs.deepmimic import DeepMimicEnv
from parc_torch.learning.ppo import PPOAgent, PPOConfig
from parc_torch.physics import engine
from parc_torch.physics import substep as sub
from parc_torch.utils.terrain import Terrain

NUM_ENVS = 4096
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

        # one control step from the same start state: kernel, plain f32,
        # and plain float64 (the yardstick of what f32 can hold here)
        got = engine.control_step(model, env.sim_params, terrain, es.sim,
                                  action, terrain_idx=es.motion_ids)
        plain = engine.control_step(model, env.sim_params, terrain, es.sim,
                                    action, terrain_idx=es.motion_ids,
                                    step_fn=sub.control_step_packed_reference)
        sim64 = engine.SimState(**{k: v.double() for k, v in vars(es.sim).items()})
        plain64 = engine.control_step(as_f64(model), env.sim_params,
                                      terrain_f64(terrain), sim64,
                                      action.double(),
                                      terrain_idx=es.motion_ids,
                                      step_fn=sub.control_step_packed_reference)

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
    rates = sorted(NUM_ENVS * ROLLOUT_STEPS / w for w in walls)
    step_ms = 1e3 * wall / ROLLOUT_STEPS
    return dict(launches=launches, wall_s=wall, setup_s=setup_s,
                env_steps_per_s=NUM_ENVS * ROLLOUT_STEPS / wall,
                rate_min=rates[0], rate_max=rates[-1], step_ms=step_ms,
                busy_ms=busy, mean_reward=mean_reward, step_err=step_err,
                plain64_err=plain64_err, kernel64_err=kernel64_err,
                dones=dones, **parts)


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
    e = r["step_err"]
    judge(max(e[f] for f in STATE_CHECK), e["contact_forces"],
          r["plain64_err"], r["kernel64_err"], "phase 4 control step")

    print(json.dumps({"kernels": [{
        "name": "control_step", "route": "cuda",
        "source": "parc_torch/csrc/control_step.cu",
        "replaces": "parc_tpu/physics/pallas_substep.py:286 "
                    "(_substep_kernel) + parc_tpu/physics/engine.py:187 "
                    "(compute_contact_forces)",
        "launches": r["launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": 1e3 * bound_s,
        "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
