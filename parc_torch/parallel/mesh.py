"""Data parallelism over torch.distributed: one process per GPU.

The counterpart of ``parc_tpu/parallel/mesh.py``. The reference PARC trains
data-parallel with one process per GPU and NCCL (util/mp_util.py,
learning/mp_optimizer.py:83-90); the JAX package runs the same reductions
as one ``shard_map`` program over a 'data' mesh axis. The port goes back to
processes: ``torchrun`` (``python -m torch.distributed.run``) starts one
process (rank) per GPU, each rank owns a contiguous block of the env batch
(its local env, ``env.local_shard``), and what the JAX package reduces over
'data' is all-reduced over the process group:

* the normalizer's sums (``learning/normalizer.update``);
* the advantage moments, the gradients (one flat buffer a minibatch) and
  the sample count (``learning/ppo.PPOAgent.train_iter``);
* the metrics and the per-motion fail rates (:func:`make_sharded_train_iter`);
* the test rollout's stop test and statistics
  (``pipeline/train_tracker.make_test_fn``).

A ``group`` of None means one process everywhere: no collective runs. Only
``all_reduce``, ``broadcast`` and ``barrier`` are used, the collectives that
gloo also runs on CUDA tensors, so two ranks can share one card over gloo
(NCCL refuses two ranks on one GPU).

``shard_major_env_state`` and ``make_sharded_rollout`` keep the JAX
package's API: the trainer needs neither (each rank builds its own local
state, and the bench rollout is not ported), and the tests use them to
hold the port's shard-major layout and sharded rollout against the JAX
package's.

Not carried over, because they are GSPMD and TPU layout: the 'model' mesh
axis, ``_is_wide_kernel``, ``param_shardings``, ``batch_shardings``,
``shard_agent_state`` and the ``*_pspec`` / ``*_shardings`` helpers.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import os
from typing import Callable, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

# the leaves of an env state that are not env rows: per-motion statistics
# and the parkour env's per-mgdm-row window buffers
_MGDM_ROW_FIELDS = ("ref_frames34", "ref_contacts", "target_xy",
                    "ref_synthetic")
_NOT_ENV_ROWS = ("fail_rates",) + _MGDM_ROW_FIELDS
# rank r's generators start from seed + RANK_SEED_STRIDE * r: rank 0 draws
# what a one-process run with the same seed draws
RANK_SEED_STRIDE = 1_000_003


@dataclasses.dataclass(frozen=True)
class DistInfo:
    """This process's place in a torchrun launch."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: Optional[str]   # None in a single process


def launch_world_size() -> int:
    """WORLD_SIZE as torchrun sets it (1 outside a launch)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device`` if given (a bare ``cuda`` is
    ``cuda:0``), else ``cuda:{LOCAL_RANK}``, which must exist."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
    else:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if not torch.cuda.is_available() or torch.cuda.device_count() <= local:
            raise RuntimeError(
                f"rank with LOCAL_RANK {local} has no cuda:{local} "
                f"({torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                f" CUDA devices); name a device explicitly to share one")
        dev = torch.device("cuda", local)
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or dev.index >= torch.cuda.device_count()):
        raise RuntimeError(f"{dev} does not exist")
    return dev


def init_distributed(backend: Optional[str] = None, device=None,
                     timeout_s: float = 600.0) -> DistInfo:
    """Join the process group of a torchrun launch.

    Reads RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT as
    torchrun sets them. ``device`` defaults to ``cuda:{LOCAL_RANK}``;
    ``backend`` to NCCL on CUDA and gloo on the CPU (gloo on CUDA only when
    named). ``torch.cuda.set_device`` runs before anything touches the
    card, so a tensor made on a bare ``cuda`` lands on this rank's card. In
    a single process (WORLD_SIZE 1 or unset) no group is made. A failed
    init raises: nothing falls back to another backend."""
    world = launch_world_size()
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world <= 1:
        return DistInfo(0, 1, 0, dev, None)
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if not initialized():
        addr = os.environ["MASTER_ADDR"]
        port = os.environ["MASTER_PORT"]
        kwargs = {}
        if backend == "nccl":
            kwargs["device_id"] = dev  # NCCL binds (and fails) at init
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
            **kwargs)
    return DistInfo(rank, world, local, dev, dist.get_backend())


def initialized() -> bool:
    """True once this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if initialized():
        dist.destroy_process_group()


def default_group():
    """The world group of an initialized launch of more than one rank,
    else None."""
    if initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def world_size(group=None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group=None) -> int:
    return 0 if group is None else dist.get_rank(group)


def is_primary() -> bool:
    """True on the logging/checkpointing rank (reference pattern:
    root-proc-only save/log, util/mp_util.py + base_agent.py:127)."""
    return not initialized() or dist.get_rank() == 0


def rank_generator(seed: int, rank_: int, device) -> torch.Generator:
    """Rank ``rank_``'s generator of a run seeded ``seed`` (the counterpart
    of the JAX package's ``fold_in(key, axis_index)``): every rank draws its
    own stream, and rank 0 draws what a one-process run draws."""
    return torch.Generator(device=device).manual_seed(
        int(seed) + RANK_SEED_STRIDE * int(rank_))


# ---------------------------------------------------------------------------
# collectives (identity at group None)
# ---------------------------------------------------------------------------


def _reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if group is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _reduce(x, group, dist.ReduceOp.SUM)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else psum(x, group) / world_size(group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    return _reduce(x, group, dist.ReduceOp.MAX)


def psum_flat(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """``psum`` of several tensors of one dtype and device in one
    all-reduce over a flat buffer."""
    if group is None:
        return list(tensors)
    flat = psum(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def broadcast_(tensors: Sequence[torch.Tensor], group, src: int = 0) -> None:
    """Overwrite ``tensors`` on every rank with rank ``src``'s, in one
    broadcast over a flat buffer."""
    if group is None:
        return
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src=src, group=group)
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view_as(t))


def primary_first(group, fn: Callable[[], object]):
    """Run ``fn`` on rank 0, then on the other ranks after a barrier: a
    kernel library that ``fn`` builds is built once (the others load it)."""
    if group is None:
        return fn()
    out = fn() if rank(group) == 0 else None
    dist.barrier(group=group)
    return out if rank(group) == 0 else fn()


def check_param_sync(params: Iterable[torch.Tensor], group,
                     atol: float = 1e-6) -> float:
    """Largest deviation of any rank's parameters from their mean over the
    ranks, reduced with MAX (the reference's periodic desync assertion,
    learning/mp_optimizer.py:68-81). Raises above ``atol``. Ranks stay
    identical by construction (every rank applies the same all-reduced
    gradients), so this catches a collectives bug or a rank that drew
    different parameters."""
    flat = torch.cat([p.detach().float().reshape(-1) for p in params])
    worst = pmax((flat - pmean(flat, group)).abs().max(), group)
    dev = float(worst)
    if dev > atol:
        raise AssertionError(
            f"data-parallel param replicas out of sync: max|p - pmean(p)| "
            f"= {dev:.3e} > {atol:.3e}")
    return dev


# ---------------------------------------------------------------------------
# the env batch over ranks
# ---------------------------------------------------------------------------


def local_agent(agent, n_shards: int):
    """Shallow agent clone whose env is the per-rank local env
    (``env.local_shard``): every env method then sees the batch size and
    static row split (the parkour env's dm | mgdm) of its own rank. The
    net, action bounds and config are shared with ``agent``."""
    if n_shards <= 1 or not hasattr(agent.env, "local_shard"):
        return agent
    clone = copy.copy(agent)
    clone.env = agent.env.local_shard(n_shards)
    return clone


def _map_env_rows(state, n: int, fn):
    """``state`` with ``fn`` applied to every tensor whose leading dim is
    the env batch ``n`` (nested states included), the per-motion and
    per-mgdm-row leaves left as they are."""
    changes = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name in _NOT_ENV_ROWS:
            continue
        if dataclasses.is_dataclass(v):
            changes[f.name] = _map_env_rows(v, n, fn)
        elif isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == n:
            changes[f.name] = fn(v)
    return dataclasses.replace(state, **changes)


def shard_major_env_state(env, env_state, n_shards: int):
    """Permute env rows into shard-major blocks when the env has a static
    row split (``ParkourEnv.shard_row_permutation``); identity for row-iid
    envs (DeepMimic). The per-motion and per-mgdm-row leaves are not env
    rows and stay as they are (the mgdm buffers already split into
    contiguous blocks per rank)."""
    perm_fn = getattr(env, "shard_row_permutation", None)
    if perm_fn is None or n_shards <= 1:
        return env_state
    perm = torch.as_tensor(perm_fn(n_shards), dtype=torch.long,
                           device=env_state.done.device)
    return _map_env_rows(env_state, env.cfg.num_envs,
                         lambda x: x.index_select(0, perm))


def local_block(env, env_state, rank_: int, n_shards: int):
    """Rank ``rank_``'s contiguous block of a shard-major global env state
    of ``env`` (the global env): its env rows and, for the parkour env, its
    mgdm rows' window buffers; the fail rates and the replan timer are
    whole."""
    n = env.cfg.num_envs
    if n % n_shards:
        raise ValueError(f"num_envs {n} not divisible by {n_shards}")
    k = n // n_shards
    state = _map_env_rows(env_state, n,
                          lambda x: x[rank_ * k:(rank_ + 1) * k])
    if hasattr(state, "ref_frames34"):
        nm = env.pcfg.mgdm_num
        if nm % n_shards:
            raise ValueError(f"mgdm_num {nm} not divisible by {n_shards}")
        km = nm // n_shards
        state = state.replace(**{
            f: getattr(state, f)[rank_ * km:(rank_ + 1) * km]
            for f in _MGDM_ROW_FIELDS})
    return state


# ---------------------------------------------------------------------------
# data-parallel train_iter and rollout
# ---------------------------------------------------------------------------


def make_sharded_train_iter(agent, group):
    """Data-parallel PPO ``train_iter`` (the counterpart of the JAX
    package's ``make_sharded_train_iter``, parc_tpu/parallel/mesh.py:
    174-253): ``fn(lib, state, timer=None) -> (state, metrics)`` on this
    rank's local env (``agent.env.local_shard``) and local ``state``.

    Inside ``train_iter`` the normalizer sums, advantage moments, gradients
    and sample count reduce over ``group``; here the metrics are averaged
    over the ranks, except ``num_dones`` and ``num_fails``, which are
    summed, and the per-motion fail rates are averaged after every
    iteration. The local state carries this rank's own generator
    (:func:`rank_generator`), so the ranks simulate different envs.
    ``agent.net`` is the network every rank trains."""
    from parc_torch.learning.ppo import TrainMetrics

    local = local_agent(agent, world_size(group))
    counts = ("num_dones", "num_fails")
    means = tuple(f for f in TrainMetrics.__dataclass_fields__
                  if f not in counts)

    def train_iter(lib, state, timer=None):
        new_state, m = local.train_iter(lib, state, timer=timer, group=group)
        if group is None:
            return new_state, m
        summed = psum(torch.stack([getattr(m, f) for f in counts]), group)
        avg = psum_flat([getattr(m, f).float() for f in means], group)
        w = world_size(group)
        metrics = TrainMetrics(
            **{f: v / w for f, v in zip(means, avg)},
            **{f: summed[i] for i, f in enumerate(counts)})
        es = new_state.env_state
        new_state = new_state.replace(env_state=es.replace(
            fail_rates=pmean(es.fail_rates, group)))
        return new_state, metrics

    return train_iter


def make_sharded_rollout(agent, group, num_steps: int, pool_k: int = 4):
    """Deterministic-policy rollout on this rank's local env (bench / eval
    across ranks; the counterpart of parc_tpu/parallel/mesh.py:256-321):
    ``fn(lib, env_state, obs_norm, generator) -> (env_state, mean_reward)``,
    the mean reward averaged over the ranks. Done envs reset from a reset
    pool of ``pool_k`` batches built on the local batch."""
    from parc_torch.envs.base import DoneFlags
    from parc_torch.learning import normalizer as norm_lib

    env = local_agent(agent, world_size(group)).env

    @torch.no_grad()
    def rollout(lib, es, obs_norm, generator):
        n = es.done.shape[0]
        pool = (env.build_reset_pool(lib, generator, es.fail_rates, n,
                                     k=pool_k)
                if hasattr(env, "build_reset_pool") else None)
        counts = torch.zeros((n,), dtype=torch.long, device=es.done.device)
        rewards = []
        for _ in range(num_steps):
            mean, _ = agent.net.actor(norm_lib.normalize(obs_norm, es.obs))
            act = agent.a_mid + agent.a_scale * mean
            if pool is not None:
                es = env.step(lib, es, act, reset_pool=pool,
                              pool_slot=counts % pool_k, generator=generator)
                counts += (es.done != DoneFlags.NULL).long()
            else:
                es = env.step(lib, es, act, generator=generator)
            rewards.append(es.reward.mean())
        return es, pmean(torch.stack(rewards).mean(), group)

    return rollout
