"""The yardstick's counts of work and the card's peaks.

Operations and bytes are counted from the configuration's widths and the
cell's shapes, never from the program, so a later change to the program
reads against the same work. A multiply-add is 2 operations. The model
structure comes from the reference's frozen copy of the humanoid.
"""

from __future__ import annotations

import math
from typing import Sequence

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at 700 W
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# peak device-memory rates (bytes/s) by card name; the first substring of
# torch.cuda.get_device_name() that matches wins
MEM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12))


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


def humanoid():
    """The reference's humanoid (15 bodies, 28 dofs, 52 contact points),
    on the CPU."""
    from reference.data.humanoid import humanoid_spec
    return humanoid_spec().build(device="cpu")


def substep_operations(model) -> int:
    """f32 operations of one substep of one env, contact included, counted
    per stage of the control step's math (a multiply-add is 2; a sqrt,
    divide or transcendental is 1): a lower bound for the op-rate bound."""
    from reference.anim import char_model as cm
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


def control_step_operations(model, envs: int, sim_steps: int,
                            substeps: int) -> int:
    """Operations of one control step of ``envs`` envs."""
    return substep_operations(model) * sim_steps * substeps * envs


def control_step_bytes(model, envs: int, terrain_slots: int, hf_rows: int,
                       hf_cols: int) -> int:
    """Bytes one control step must move: the packed state read and
    written, the PD targets and joint quats read, the contact forces
    written, each env's terrain index, the stacked heightfields with their
    corners and cell size, and the model's tables, each once."""
    from reference.physics import substep as sub
    state = sub.state_layout(model).total
    const = sub.const_layout(model).total
    contact = 3 * model.num_bodies
    per_env = 2 * state + const + contact + 1
    terrain = terrain_slots * (hf_rows * hf_cols + 2) + 2
    ints, floats = sub.model_tables(model)
    return 4 * (envs * per_env + terrain + ints.numel() + floats.numel())


def _mlp_flops(widths: Sequence[int], rows: int) -> int:
    """Forward operations of a dense stack of ``widths`` over ``rows``."""
    return sum(2 * rows * a * b for a, b in zip(widths[:-1], widths[1:]))


def _mlp_train_flops(widths: Sequence[int], rows: int) -> int:
    """Forward and backward: each layer's weight gradient costs its
    forward, and its input gradient the same except at the first layer,
    whose input is data."""
    fwd = _mlp_flops(widths, rows)
    first = 2 * rows * widths[0] * widths[1]
    return fwd + fwd + (fwd - first)


def ppo_iteration_flops(obs_dim: int, act_dim: int, actor: Sequence[int],
                        critic: Sequence[int], steps: int, envs: int,
                        epochs: int) -> int:
    """The networks' operations of one PPO iteration: the actor in the
    rollout, the critic over next and current observations for the
    targets, and ``epochs`` passes of both nets forward and backward over
    every sample in the update."""
    a = [obs_dim, *actor, act_dim]
    c = [obs_dim, *critic, 1]
    rows = steps * envs
    rollout = _mlp_flops(a, rows)
    targets = 2 * _mlp_flops(c, rows)
    update = epochs * (_mlp_train_flops(a, rows) + _mlp_train_flops(c, rows))
    return rollout + targets + update


def _conv_out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


# the heightfield tokenizer (diffusion/transformer.py): (c_in, c_out, k,
# stride, pad) of its four convolutions over the 31 x 31 local heightfield,
# then a dense layer from 64 channels to d_model on each of 64 tokens
HF_CONVS = ((1, 32, 5, 1, 2), (32, 64, 5, 2, 2), (64, 64, 5, 1, 2),
            (64, 64, 4, 2, 1))
HF_SIDE, HF_TOKENS = 31, 64


def denoiser_flops(d_model: int, d_hid: int, num_layers: int, seq_len: int,
                   num_prev: int, frame_dim: int, windows: int,
                   conditions: bool) -> int:
    """Forward operations of the denoiser on ``windows`` windows: the
    timestep MLP (1 token), the frame MLPs (``seq_len`` tokens in and
    out) and the encoder layers over every token, with each layer's
    attention scores and weighted sums; with ``conditions`` also the
    condition tokens (the heightfield CNN and its dense layer, the target
    MLP, the previous states through the frame MLP), which a
    cached-condition call takes from its cache."""
    d = d_model
    n = 1 + HF_TOKENS + 1 + num_prev + seq_len
    t_mlp = _mlp_flops([d, d, d], 1)
    frames_in = _mlp_flops([frame_dim, 1024, d], seq_len)
    frames_out = _mlp_flops([d, 1024, frame_dim], seq_len)
    layer = 2 * n * (4 * d * d + 2 * d * d_hid)
    attention = 2 * 2 * n * n * d
    total = (t_mlp + frames_in + frames_out
             + num_layers * (layer + attention))
    if conditions:
        side, cnn = HF_SIDE, 0
        for c_in, c_out, k, s, p in HF_CONVS:
            side = _conv_out(side, k, s, p)
            cnn += 2 * side * side * c_out * c_in * k * k
        cnn += 2 * HF_TOKENS * 64 * d
        target = _mlp_flops([2, 512, d], 1)
        prev = _mlp_flops([frame_dim, 1024, d], num_prev)
        total += cnn + target + prev
    return windows * total


def mdm_train_step_flops(d_model: int, d_hid: int, num_layers: int,
                         seq_len: int, num_prev: int, frame_dim: int,
                         windows: int) -> int:
    """One training step: the full forward (condition tokens included)
    and the backward at twice the forward. The losses' FK and the
    optimizer are left out: they are elementwise."""
    return 3 * denoiser_flops(d_model, d_hid, num_layers, seq_len, num_prev,
                              frame_dim, windows, conditions=True)


def share(least_s: float, measured_s: float) -> float:
    """A roofline or peak share in %, of the least time over the time
    taken."""
    if not (measured_s > 0 and math.isfinite(measured_s)):
        raise ValueError(f"no time to share against: {measured_s}")
    return 100.0 * least_s / measured_s
