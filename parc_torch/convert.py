"""Carry weights and state from the JAX package's trees into the port.

Every function takes numpy arrays (or nested dicts / attribute objects of
numpy arrays), never a JAX type: convert a JAX tree first with
``jax.tree.map(np.asarray, tree)``. They let a test start both stacks from
identical state and compare them step for step.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from parc_torch.anim import motion_lib as ml
from parc_torch.envs.base import EnvState
from parc_torch.envs.deepmimic import ResetPool
from parc_torch.envs.parkour import ParkourResetPool, ParkourState
from parc_torch.learning import normalizer as norm_lib
from parc_torch.learning import ppo
from parc_torch.learning.networks import ActorCritic, _NET_REGISTRY
from parc_torch.physics import engine

_SIM_FIELDS = tuple(f for f in engine.SimState.__dataclass_fields__)
_LIB_FIELDS = tuple(f for f in ml.MotionLib.__dataclass_fields__)
_INDEX_FIELDS = ("motion_ids", "done", "start_idx", "num_frames",
                 "loop_modes")
_BUFFER_FIELDS = ("ref_frames34", "ref_contacts", "target_xy")


def _tensor(name: str, x, device) -> torch.Tensor:
    x = np.asarray(x)
    dtype = torch.int64 if name in _INDEX_FIELDS else torch.float32
    return torch.as_tensor(np.array(x), device=device).to(dtype)


def _get(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _net_name(widths) -> str:
    for name, layers in _NET_REGISTRY.items():
        if tuple(layers) == tuple(widths):
            return name
    raise ValueError(f"no registered net has widths {widths}")


def flax_state_dict(params) -> Dict[str, torch.Tensor]:
    """A flax ActorCritic param tree (or a tree of the same structure,
    such as optax's momentum ``trace``) as the port's ActorCritic
    ``state_dict``: a trunk's ``Dense_i`` is its Linear ``2*i`` (Linear and
    ReLU alternate), and each (in, out) kernel becomes an (out, in)
    weight. The tree may hold its top-level ``"params"`` key or not."""
    p = params.get("params", params)
    if "RayConvTokenizer_0" in p:
        return vision_state_dict(p)
    out = {}

    def dense(prefix, d):
        out[f"{prefix}.weight"] = torch.as_tensor(
            np.array(np.asarray(d["kernel"]).T, np.float32))
        out[f"{prefix}.bias"] = torch.as_tensor(
            np.array(d["bias"], np.float32))

    for name, sub in p.items():
        if name in ("actor_trunk", "critic_trunk"):
            for i in range(len(sub)):
                dense(f"{name}.{2 * i}", sub[f"Dense_{i}"])
        elif name == "logstd":
            out["logstd"] = torch.as_tensor(np.array(sub, np.float32))
        else:
            dense(name, sub)
    return out


def actor_critic_from_flax(params: dict, actor_std_type: str = "FIXED",
                           action_std: float = 0.05,
                           device="cpu") -> ActorCritic:
    """An :class:`ActorCritic` holding a flax ActorCritic param tree.

    ``params`` is the tree ``ActorCritic.init`` returned (with or without
    its top-level ``"params"`` key), as numpy arrays. Trunk widths are read
    from the kernels' shapes.
    """
    p = params.get("params", params)

    def widths(name):
        t = p[name]
        return [np.asarray(t[f"Dense_{i}"]["kernel"]).shape[1]
                for i in range(len(t))]

    net = ActorCritic(
        np.asarray(p["actor_trunk"]["Dense_0"]["kernel"]).shape[0],
        np.asarray(p["actor_head"]["kernel"]).shape[1],
        actor_net=_net_name(widths("actor_trunk")),
        critic_net=_net_name(widths("critic_trunk")),
        actor_std_type=actor_std_type, action_std=action_std)
    net.load_state_dict(flax_state_dict(p))
    return net.to(device)


def _momentum_trace(opt_state):
    """The ``trace`` tree of optax's TraceState inside an optax state (a
    chain's nested tuples of named tuples)."""
    if "trace" in getattr(opt_state, "_fields", ()):
        return opt_state.trace
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _momentum_trace(sub)
            if found is not None:
                return found
    return None


def persistent_from_numpy(tree) -> dict:
    """The port's ``ppo.persistent_state`` dict (CPU tensors) from the JAX
    package's ``ppo.persistent_state`` tree with numpy leaves: flax params,
    optax's momentum ``trace`` (the SGD momentum buffers), the normalizer,
    ``sample_count`` and ``fail_rates``."""
    trace = _momentum_trace(_get(tree, "opt_state"))
    if trace is None:
        raise ValueError("the optax state holds no momentum trace")
    norm = _get(tree, "obs_norm")
    return {
        "params": flax_state_dict(_get(tree, "params")),
        "opt_state": {"momentum": flax_state_dict(trace)},
        "obs_norm": {**{f: _tensor(f, _get(norm, f), "cpu")
                        for f in ("mean", "var", "count", "norm_mask")},
                     "clip": float(_get(norm, "clip")),
                     "sample_limit": float(_get(norm, "sample_limit"))},
        "sample_count": _tensor("sample_count", _get(tree, "sample_count"),
                                "cpu"),
        "fail_rates": _tensor("fail_rates", _get(tree, "fail_rates"), "cpu"),
    }


def agent_state_from_numpy(agent: ppo.PPOAgent, state: ppo.AgentState,
                           tree) -> ppo.AgentState:
    """``state`` (a fresh ``agent.init``) with the JAX ``persistent_state``
    tree ``tree`` merged in: the parameters and momentum buffers are copied
    into ``agent.net`` and ``state.optimizer``."""
    return ppo.merge_persistent(agent, state, persistent_from_numpy(tree))


class _StateDict(dict):
    """A state_dict under construction from flax layouts: a Dense (in,
    out) kernel becomes an (out, in) weight; a Conv HWIO kernel an OIHW
    weight; an attention q/k/v kernel (d, heads, head_dim) a (heads *
    head_dim, d) weight and its (heads, head_dim) bias a flat one; the
    attention output kernel (heads, head_dim, d) a (d, heads * head_dim)
    weight; a LayerNorm's scale its weight."""

    def put(self, name, x, fn=lambda a: a):
        self[name] = torch.as_tensor(np.array(fn(np.asarray(x)), np.float32))

    def dense(self, prefix, d):
        self.put(f"{prefix}.weight", d["kernel"], lambda k: k.T)
        self.put(f"{prefix}.bias", d["bias"])

    def conv(self, prefix, d):
        self.put(f"{prefix}.weight", d["kernel"],
                 lambda k: k.transpose(3, 2, 0, 1))
        self.put(f"{prefix}.bias", d["bias"])

    def encoder_layer(self, pre, attn, norms, denses):
        """An ``EncoderLayer`` from a flax MultiHeadDotProductAttention,
        its two LayerNorms and its FFN's two Denses."""
        for proj in ("query", "key", "value"):
            self.put(f"{pre}.{proj}.weight", attn[proj]["kernel"],
                     lambda a: a.reshape(a.shape[0], -1).T)
            self.put(f"{pre}.{proj}.bias", attn[proj]["bias"],
                     lambda a: a.reshape(-1))
        self.put(f"{pre}.out.weight", attn["out"]["kernel"],
                 lambda a: a.reshape(-1, a.shape[-1]).T)
        self.put(f"{pre}.out.bias", attn["out"]["bias"])
        for j in range(2):
            self.put(f"{pre}.norm_{j}.weight", norms[j]["scale"])
            self.put(f"{pre}.norm_{j}.bias", norms[j]["bias"])
            self.dense(f"{pre}.dense_{j}", denses[j])


def vision_state_dict(params) -> Dict[str, torch.Tensor]:
    """A flax ``DMCnnMlp`` or ``DMViT`` param tree (or a tree of the same
    structure, such as optax's momentum ``trace``) as the port's
    ``learning.vision_nets`` ``state_dict``. flax numbers each module type
    in creation order: the tokenizer, then (CNN-MLP) the trunk's Denses and
    the two heads, or (ViT) one Dense per non-hf segment, each layer's
    attention, LayerNorms and FFN Denses, and the two heads."""
    p = params.get("params", params)
    out = _StateDict()
    tok = p["RayConvTokenizer_0"]
    for i in range(3):
        out.conv(f"tokenizer.conv.{i}", tok[f"Conv_{i}"])
    out.dense("tokenizer.dense", tok["Dense_0"])
    n_dense = sum(k.startswith("Dense_") for k in p)
    if "cls" not in p:  # DMCnnMlp
        for i in range(n_dense - 2):
            out.dense(f"trunk.{i}", p[f"Dense_{i}"])
    else:
        n_layers = sum(k.startswith("MultiHeadDotProductAttention_")
                       for k in p)
        n_seg = n_dense - 2 * n_layers - 2
        for i in range(n_seg):
            out.dense(f"seg_dense.{i}", p[f"Dense_{i}"])
        out.put("cls", p["cls"])
        out.put("pos", p["pos"])
        for i in range(n_layers):
            out.encoder_layer(
                f"layers.{i}", p[f"MultiHeadDotProductAttention_{i}"],
                [p[f"LayerNorm_{2 * i + j}"] for j in range(2)],
                [p[f"Dense_{n_seg + 2 * i + j}"] for j in range(2)])
    out.dense("mean_head", p[f"Dense_{n_dense - 2}"])
    out.dense("value_head", p[f"Dense_{n_dense - 1}"])
    return dict(out)


def mdm_params_from_numpy(params) -> Dict[str, torch.Tensor]:
    """A flax ``MDMTransformer`` param tree (or a tree of the same
    structure, such as adam's ``mu`` and ``nu``) as the port's
    ``MDMTransformer`` ``state_dict`` (the layouts of ``_StateDict``). The
    tree may hold its top-level ``"params"`` key or not."""
    p = params.get("params", params)
    out = _StateDict()

    def mlp(prefix, tree):
        for i in range(len(tree)):
            out.dense(f"{prefix}.dense.{i}", tree[f"Dense_{i}"])

    for name in ("t_mlp", "target_mlp", "in_mlp", "out_mlp"):
        mlp(name, p[name])
    tok = p["hf_tokenizer"]
    for i in range(4):
        out.conv(f"hf_tokenizer.conv.{i}", tok[f"Conv_{i}"])
    out.dense("hf_tokenizer.dense", tok["Dense_0"])
    out.put("prev_noise_ind", p["prev_noise_ind"])
    out.put("pos_embed", p["pos_embed"])
    i = 0
    while f"layers_{i}" in p:
        layer = p[f"layers_{i}"]
        out.encoder_layer(f"layers.{i}",
                          layer["MultiHeadDotProductAttention_0"],
                          [layer[f"LayerNorm_{j}"] for j in range(2)],
                          [layer[f"Dense_{j}"] for j in range(2)])
        i += 1
    return dict(out)


def _adam_state(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) inside an optax state."""
    if {"mu", "nu", "count"} <= set(getattr(opt_state, "_fields", ())):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def mdm_state_from_numpy(tree) -> dict:
    """The port's ``MDM.persistent_state`` dict (CPU tensors) from a JAX
    ``MDMState`` with numpy leaves: params, EMA params, adam's ``mu``,
    ``nu`` and ``count`` (AdamW's ``exp_avg``, ``exp_avg_sq`` and
    ``step``: both bias-correct with count + 1 at the next step), mean,
    std and step. The JAX key is not carried over: restore it with
    ``MDM.merge_persistent`` into a state whose generator is seeded."""
    adam = _adam_state(_get(tree, "opt_state"))
    if adam is None:
        raise ValueError("the optax state holds no adam state")
    return {
        "params": mdm_params_from_numpy(_get(tree, "params")),
        "ema_params": mdm_params_from_numpy(_get(tree, "ema_params")),
        "opt_state": {"exp_avg": mdm_params_from_numpy(adam.mu),
                      "exp_avg_sq": mdm_params_from_numpy(adam.nu),
                      "step": int(np.asarray(adam.count))},
        "mean": _tensor("mean", _get(tree, "mean"), "cpu"),
        "std": _tensor("std", _get(tree, "std"), "cpu"),
        "step": int(np.asarray(_get(tree, "step"))),
    }


def normalizer_from_numpy(state, device="cpu") -> norm_lib.NormalizerState:
    """A NormalizerState from one with numpy leaves (mean, var, count,
    norm_mask, clip, sample_limit)."""
    def t(name):
        return _tensor(name, _get(state, name), device)
    return norm_lib.NormalizerState(
        mean=t("mean"), var=t("var"), count=t("count"),
        norm_mask=t("norm_mask"), clip=float(_get(state, "clip")),
        sample_limit=float(_get(state, "sample_limit")))


def sim_state_from_numpy(state, device="cpu") -> engine.SimState:
    """A SimState from a tree with the same field names."""
    return engine.SimState(**{f: _tensor(f, _get(state, f), device)
                              for f in _SIM_FIELDS})


def motion_lib_from_numpy(lib, device="cpu") -> ml.MotionLib:
    """A MotionLib from a tree with the same field names."""
    return ml.MotionLib(**{f: _tensor(f, _get(lib, f), device)
                           for f in _LIB_FIELDS})


def env_state_from_numpy(state, device="cpu") -> EnvState:
    """An EnvState from a tree with the same field names (a JAX EnvState's
    ``rng`` is ignored: the port draws from explicit generators)."""
    fields = [f for f in EnvState.__dataclass_fields__ if f != "sim"]
    return EnvState(sim=sim_state_from_numpy(_get(state, "sim"), device),
                    **{f: _tensor(f, _get(state, f), device) for f in fields})


def reset_pool_from_numpy(pool, device="cpu",
                          k: Optional[int] = None) -> ResetPool:
    """A ResetPool from a tree with the same field names."""
    return ResetPool(
        sim=sim_state_from_numpy(_get(pool, "sim"), device),
        motion_ids=_tensor("motion_ids", _get(pool, "motion_ids"), device),
        times=_tensor("times", _get(pool, "times"), device),
        obs=_tensor("obs", _get(pool, "obs"), device),
        k=int(_get(pool, "k") if k is None else k))


def parkour_state_from_numpy(state, device="cpu") -> ParkourState:
    """A ParkourState from a tree with the same field names (the replan
    timer becomes a Python int)."""
    base = env_state_from_numpy(state, device)
    return ParkourState(
        **vars(base),
        **{f: _tensor(f, _get(state, f), device)
           for f in _BUFFER_FIELDS + ("ref_synthetic",)},
        replan_timer=int(np.asarray(_get(state, "replan_timer"))))


def parkour_reset_pool_from_numpy(pool, device="cpu",
                                  k: Optional[int] = None
                                  ) -> ParkourResetPool:
    """A ParkourResetPool from a tree with the same field names."""
    base = reset_pool_from_numpy(pool, device, k)
    return ParkourResetPool(
        **vars(base),
        **{f: _tensor(f, _get(pool, f), device) for f in _BUFFER_FIELDS})


def local_env_state_from_numpy(env, state, rank: int, n_shards: int,
                               device="cpu"):
    """Rank ``rank``'s local env state of a global env state with numpy
    leaves, laid out shard-major as the JAX package's
    ``shard_major_env_state`` lays it out; ``env`` is the port's global env
    (``parallel.mesh.local_block``)."""
    from parc_torch.parallel import mesh
    conv = (parkour_state_from_numpy if hasattr(env, "shard_row_permutation")
            else env_state_from_numpy)
    return mesh.local_block(env, conv(state, device), rank, n_shards)
