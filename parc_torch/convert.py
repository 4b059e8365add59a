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
from parc_torch.learning import normalizer as norm_lib
from parc_torch.learning import ppo
from parc_torch.learning.networks import ActorCritic, _NET_REGISTRY
from parc_torch.physics import engine

_SIM_FIELDS = tuple(f for f in engine.SimState.__dataclass_fields__)
_LIB_FIELDS = tuple(f for f in ml.MotionLib.__dataclass_fields__)
_INDEX_FIELDS = ("motion_ids", "done", "start_idx", "num_frames",
                 "loop_modes")


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


def mdm_params_from_numpy(params) -> Dict[str, torch.Tensor]:
    """A flax ``MDMTransformer`` param tree (or a tree of the same
    structure, such as adam's ``mu`` and ``nu``) as the port's
    ``MDMTransformer`` ``state_dict``. Layouts: a Dense (in, out) kernel
    becomes an (out, in) weight; a Conv HWIO kernel an OIHW weight; an
    attention q/k/v kernel (d, heads, head_dim) a (heads * head_dim, d)
    weight and its (heads, head_dim) bias a flat one; the attention output
    kernel (heads, head_dim, d) a (d, heads * head_dim) weight; a
    LayerNorm's scale its weight. The tree may hold its top-level
    ``"params"`` key or not."""
    p = params.get("params", params)
    out = {}

    def put(name, x, fn=lambda a: a):
        out[name] = torch.as_tensor(np.array(fn(np.asarray(x)), np.float32))

    def dense(prefix, d):
        put(f"{prefix}.weight", d["kernel"], lambda k: k.T)
        put(f"{prefix}.bias", d["bias"])

    def mlp(prefix, tree):
        for i in range(len(tree)):
            dense(f"{prefix}.dense.{i}", tree[f"Dense_{i}"])

    for name in ("t_mlp", "target_mlp", "in_mlp", "out_mlp"):
        mlp(name, p[name])
    tok = p["hf_tokenizer"]
    for i in range(4):
        put(f"hf_tokenizer.conv.{i}.weight", tok[f"Conv_{i}"]["kernel"],
            lambda k: k.transpose(3, 2, 0, 1))
        put(f"hf_tokenizer.conv.{i}.bias", tok[f"Conv_{i}"]["bias"])
    dense("hf_tokenizer.dense", tok["Dense_0"])
    put("prev_noise_ind", p["prev_noise_ind"])
    put("pos_embed", p["pos_embed"])
    i = 0
    while f"layers_{i}" in p:
        layer, pre = p[f"layers_{i}"], f"layers.{i}"
        attn = layer["MultiHeadDotProductAttention_0"]
        for proj in ("query", "key", "value"):
            k = attn[proj]["kernel"]
            put(f"{pre}.{proj}.weight", k,
                lambda a: a.reshape(a.shape[0], -1).T)
            put(f"{pre}.{proj}.bias", attn[proj]["bias"],
                lambda a: a.reshape(-1))
        put(f"{pre}.out.weight", attn["out"]["kernel"],
            lambda a: a.reshape(-1, a.shape[-1]).T)
        put(f"{pre}.out.bias", attn["out"]["bias"])
        for j in range(2):
            put(f"{pre}.norm_{j}.weight", layer[f"LayerNorm_{j}"]["scale"])
            put(f"{pre}.norm_{j}.bias", layer[f"LayerNorm_{j}"]["bias"])
            dense(f"{pre}.dense_{j}", layer[f"Dense_{j}"])
        i += 1
    return out


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
