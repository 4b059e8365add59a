"""Tracker training loop (parc_3 stage).

Host loop around PPO ``train_iter``: periodic deterministic test rollouts,
fail-rate logging, checkpoints. The reference spreads this over run.py +
BaseAgent.train_model (learning/base_agent.py:57-90,
learning/dm_ppo_agent.py:230-271). The host reads the device once per
iteration (the sample count and the NaN guard's two metrics), and once per
step of a test rollout (its stop test).

Launched by torchrun with more than one rank, training is data-parallel
(parallel/mesh.py): each rank trains its block of the env batch, the
reductions of the JAX package's shard_map path run as all-reduces, and only
rank 0 writes the log, the checkpoints, the NaN guard's dump and the
profiler trace.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from parc_torch.anim import motion_lib as ml
from parc_torch.envs.base import DoneFlags
from parc_torch.learning import ppo as ppo_lib
from parc_torch.learning.ppo import AgentState, PPOAgent
from parc_torch.parallel import mesh
from parc_torch.utils import checkpoint as ckpt_lib
from parc_torch.utils import profiling
from parc_torch.utils.logger import Logger

TRACKING_ERROR_NAMES = ("root_pos_err", "root_rot_err", "body_pos_err",
                        "pose_err", "dof_vel_err", "root_vel_err",
                        "root_ang_vel_err")


@dataclasses.dataclass
class TrainerConfig:
    max_samples: float = 1e10
    iters_per_output: int = 100
    iters_per_checkpoint: int = 200
    test_episodes: int = 16
    test_steps: int = 300
    output_dir: str = "output/tracker"
    use_wandb: bool = False
    # torch.profiler: capture iterations [profile_start, profile_start +
    # profile_iters) into <output_dir>/profile/trace.json (Perfetto), with
    # the program's parc.* spans (utils/profiling.py) inside each
    # "train_iter"
    profile_iters: int = 0
    profile_start: int = 10
    # data parallelism: periodic param-replica desync check (reference:
    # learning/mp_optimizer.py:68-81 checks every 1000 steps)
    iters_per_sync_check: int = 1000


REWARD_COMPONENT_NAMES = ("pose_r", "vel_r", "root_pose_r", "root_vel_r",
                          "key_pos_r", "contact_r")


def best_checkpoint_step(output_dir: str, steps=None) -> Optional[int]:
    """Checkpoint step with the highest logged ``Test_Reward``.

    The fail-rate curriculum concentrates sampling on the hardest clips as
    training progresses, so test reward oscillates late in a run; the final
    checkpoint can land in a dip (the reference records from its latest
    ``model.pt`` and relies on long stable runs). Downstream stages
    (record/eval) may instead pick the best-tested checkpoint from the
    retained history.

    Reads ``<output_dir>/log.tsv`` (Iteration / Test_Reward columns) and
    scores each retained checkpoint by the most recent test at or before
    its step. Returns None when no log or no checkpoints exist.
    """
    if steps is None:
        steps = ckpt_lib.all_steps(f"{output_dir}/checkpoints")
    if not steps:
        return None
    log_path = os.path.join(output_dir, "log.tsv")
    if not os.path.exists(log_path):
        return steps[-1]
    tests = []  # (iteration, test_reward), ascending
    with open(log_path) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            try:
                tests.append((float(row["Iteration"]),
                              float(row["Test_Reward"])))
            except (KeyError, ValueError, TypeError):
                continue
    if not tests:
        return steps[-1]
    best_step, best_r = None, -np.inf
    for s in sorted(steps):
        at_or_before = [r for it, r in tests if it <= s]
        if not at_or_before:
            continue
        r = at_or_before[-1]
        if r >= best_r:  # ties -> later (more-trained) checkpoint
            best_step, best_r = s, r
    return best_step if best_step is not None else steps[-1]


def make_test_fn(agent: PPOAgent, max_steps: int, test_episodes: int = 16,
                 group=None):
    """Deterministic-policy evaluation rollout:
    ``test_fn(lib, state, generator) -> dict``.

    Runs until every env has finished at least ceil(test_episodes /
    num_envs) episodes (reference: learning/base_agent.py:328-362; the
    min-episodes-per-env loop removes the bias toward short episodes that
    a fixed step count has), bounded by ``max_steps``; the stop test reads
    one bool per step. Returns per-episode return/length, fail fraction,
    per-reward-component episodic returns (reference:
    learning/return_tracker.py:5-60, dm_ppo_return_tracker.py), and the 7
    tracking-error components (reference:
    learning/dm_ppo_agent.py:162-219), as tensors.

    With a process ``group`` pass this rank's agent (its env the local
    env, ``mesh.local_agent``) and this rank's generator: each rank rolls
    out its own envs, the episode quota is over all ranks' envs, the stop
    test reduces every rank's "all done" each step (every rank stops on
    the same step), and every statistic is summed over the ranks.
    """
    env = agent.env
    n_shards = mesh.world_size(group)

    @torch.no_grad()
    def test_fn(lib, state: AgentState, generator: torch.Generator):
        es = env.reset(lib, generator, num_envs=env.cfg.num_envs)
        n = es.done.shape[0]
        min_eps = -(-int(test_episodes) // (n * n_shards))   # ceil
        dev = es.reward.device

        def zeros(*shape):
            return torch.zeros(shape, device=dev)

        eps_per_env = torch.zeros((n,), dtype=torch.long, device=dev)
        ret_buf = zeros(n)
        comp_buf = zeros(n, es.reward_components.shape[-1])
        reward_sum, ep_ret_sum, ep_len_sum = zeros(), zeros(), zeros()
        ep_cnt, fail_cnt = zeros(), zeros()
        comp_ret_sum = zeros(es.reward_components.shape[-1])
        terr_sum = zeros(es.tracking_error.shape[-1])
        step = 0
        while step < max_steps:
            action = agent.act(state, es.obs)
            es = env.step(lib, es, action, generator=generator)
            is_done = es.done != DoneFlags.NULL
            d = is_done.float()
            # per-env episodic accumulators (reset on done)
            ret_buf = ret_buf + es.reward
            comp_buf = comp_buf + es.reward_components
            eps_per_env = eps_per_env + is_done.long()
            reward_sum = reward_sum + torch.sum(es.reward)
            ep_ret_sum = ep_ret_sum + torch.sum(d * ret_buf)
            # terminal_times = pre-reset episode time (es.time is already
            # zeroed for done envs by the auto-reset)
            ep_len_sum = ep_len_sum + torch.sum(d * es.terminal_times)
            ep_cnt = ep_cnt + torch.sum(d)
            fail_cnt = fail_cnt + torch.sum(
                (es.done == DoneFlags.FAIL).float())
            comp_ret_sum = comp_ret_sum + torch.sum(d[:, None] * comp_buf,
                                                    dim=0)
            terr_sum = terr_sum + torch.sum(es.tracking_error, dim=0)
            ret_buf = torch.where(is_done, 0.0, ret_buf)
            comp_buf = torch.where(is_done[:, None], 0.0, comp_buf)
            step += 1
            local_done = torch.all(eps_per_env >= min_eps).int()
            if int(mesh.psum(local_done, group)) >= n_shards:
                break
        (reward_sum, ep_ret_sum, ep_len_sum, ep_cnt, fail_cnt, comp_ret_sum,
         terr_sum) = mesh.psum_flat([reward_sum, ep_ret_sum, ep_len_sum,
                                     ep_cnt, fail_cnt, comp_ret_sum,
                                     terr_sum], group)
        steps = float(max(step, 1))
        eps = torch.clamp(ep_cnt, min=1.0)
        n_total = n * n_shards
        return dict(
            mean_reward=reward_sum / (steps * n_total),
            mean_return=ep_ret_sum / eps,
            num_eps=ep_cnt,
            mean_ep_len=ep_len_sum / eps,
            fail_frac=fail_cnt / eps,
            component_returns=comp_ret_sum / eps,
            tracking_error=terr_sum / (steps * n_total),
            test_steps=torch.tensor(step, dtype=torch.int32),
        )

    return test_fn


def log_fail_rate_tables(logger: Logger, fail_rates: np.ndarray,
                         meta: Optional[dict], top_k: int = 40) -> None:
    """Per-motion top-K fail-rate table + per-class mean/max rates
    (reference: envs/ig_parkour/dm_env.py:786-845 get_extra_log_info)."""
    fr = np.asarray(fail_rates)
    names = list((meta or {}).get("names") or [])
    # envs can append extra slots (e.g. the parkour mgdm terrain slot):
    # pad names/classes to the fail-rate length
    names += [f"motion_{i}" for i in range(len(names), len(fr))]
    classes = (meta or {}).get("classes")
    if classes is not None:
        classes = list(classes) + ["_extra"] * (len(fr) - len(classes))
    k = min(top_k, len(fr))
    order = np.argsort(-fr)[:k]
    print(f"***** TOP {k} FAILURE RATES BY MOTION ID *****")
    for i in order:
        print(f"  {names[i]:<40s} id={i:<5d} fail rate (EMA): "
              f"{fr[i] * 100.0:.1f}%")
    if classes is not None:
        for cls in sorted(set(classes)):
            ids = [i for i, c in enumerate(classes) if c == cls]
            logger.log(f"{cls}_mean_fail_rate",
                       float(np.mean(fr[ids]) * 100.0), quiet=True)
            logger.log(f"{cls}_max_fail_rate",
                       float(np.max(fr[ids]) * 100.0), quiet=True)


def train(agent: PPOAgent, lib: ml.MotionLib,
          cfg: TrainerConfig = TrainerConfig(),
          state: Optional[AgentState] = None,
          seed: int = 0, max_iters: Optional[int] = None,
          meta: Optional[dict] = None) -> AgentState:
    """Train until ``cfg.max_samples`` samples or ``max_iters`` iterations
    in all (a resumed run counts the iterations of its checkpoint, so
    re-invoking a finished run with the same ``max_iters`` is a no-op).
    ``lib`` is whatever the agent's env takes: a MotionLib, or the parkour
    env's ``ParkourLib`` bundle.

    In a torchrun launch of more than one rank (``mesh.init_distributed``
    first) training is data-parallel: ``agent`` is the global agent (its
    env has every env), each rank trains its block (``mesh.local_agent``),
    and a ``state`` passed in is this rank's local state. A ``num_envs`` or
    ``mgdm_num`` that does not divide by the ranks raises ValueError."""
    dev = agent.device
    group = mesh.default_group()
    n_ranks = mesh.world_size(group)
    local = mesh.local_agent(agent, n_ranks)  # raises where it does not split
    num_envs = agent.env.cfg.num_envs
    mgdm_num = getattr(getattr(agent.env, "pcfg", None), "mgdm_num", 0)
    rank = mesh.rank(group)
    primary = mesh.is_primary()

    logger = (Logger(output_file=f"{cfg.output_dir}/log.tsv",
                     use_wandb=cfg.use_wandb) if primary else None)
    ckpt_dir = f"{cfg.output_dir}/checkpoints"
    it0 = 0
    if state is None:
        state = local.init(lib, mesh.rank_generator(seed, rank, dev))
        start_step = ckpt_lib.latest_step(ckpt_dir)
        if start_step is not None:
            restored = ckpt_lib.restore(ckpt_dir, map_location=dev)
            state = ppo_lib.merge_persistent(local, state, restored)
            it0 = start_step
            print(f"resumed from checkpoint step {start_step}")
    # every clone of the agent trains the same network
    agent.net = local.net

    if group is not None:
        if dev.type == "cuda":
            # rank 0 builds the kernel library, the others load it
            from parc_torch.physics import substep as sub
            mesh.primary_first(group, sub.library)
        # parameters start identical on every rank
        params = list(agent.net.parameters())
        mesh.broadcast_(params + [state.optimizer.state[p]["momentum_buffer"]
                                  for p in params], group)
        mesh.check_param_sync(params, group)
        train_iter = mesh.make_sharded_train_iter(agent, group)
        print(f"data parallel over {n_ranks} ranks ({num_envs // n_ranks} "
              f"envs a rank" + (f", {mgdm_num // n_ranks} mgdm rows"
                                if mgdm_num else "") + ")")
    else:
        def train_iter(lib_, state_, timer=None):
            return agent.train_iter(lib_, state_, timer=timer)
    test_fn = make_test_fn(local, cfg.test_steps, cfg.test_episodes,
                           group=group)
    it = it0
    t_start = time.time()
    timers = profiling.PhaseTimer()
    prof = None
    while float(state.sample_count) < cfg.max_samples:
        if max_iters is not None and it >= max_iters:
            break
        if primary and cfg.profile_iters and it == cfg.profile_start:
            prof = profiling.start_trace()
        # the update changes the parameters in place: keep the pre-update
        # state for the NaN guard's dump
        pre = ppo_lib.persistent_state(local, state) if primary else None
        t0 = time.time()
        with timers.phase("train_iter", sync_on=dev):
            with profiling.annotate("train_iter"):
                new_state, metrics = train_iter(lib, state, timer=timers)
        iter_time = time.time() - t0
        it += 1
        if prof is not None and it == cfg.profile_start + cfg.profile_iters:
            path = profiling.stop_trace(prof, f"{cfg.output_dir}/profile")
            prof = None
            print(f"profile trace written to {path}")

        # NaN guard + debug dump (reference: ppo_agent.py:242-252 dumps the
        # offending batch to output/debug_batch.pkl and exits); the metrics
        # are the same on every rank, so every rank stops
        critic_loss = float(metrics.critic_loss)
        if not np.isfinite(critic_loss) or not np.isfinite(
                float(metrics.mean_reward)):
            dump = f"{cfg.output_dir}/debug_state.pkl"
            if primary:
                with open(dump, "wb") as f:
                    pickle.dump(_to_numpy(pre), f)
            raise FloatingPointError(
                f"non-finite training metrics at iter {it} "
                f"(critic_loss={critic_loss}); pre-update state dumped to "
                f"{dump}")
        state = new_state

        if (group is not None and cfg.iters_per_sync_check
                and it % cfg.iters_per_sync_check == 0):
            mesh.check_param_sync(agent.net.parameters(), group)

        if it % cfg.iters_per_output == 0 or it == 1:
            with timers.phase("test", sync_on=dev):
                test = test_fn(lib, state, mesh.rank_generator(seed + it,
                                                               rank, dev))
            if primary:
                _log_iteration(logger, agent, state, metrics, test, it,
                               iter_time, t_start, meta)

        if primary and it % cfg.iters_per_checkpoint == 0:
            ckpt_lib.save(ckpt_dir, it, ppo_lib.persistent_state(local, state))

    if prof is not None:  # the run ended inside the profiled window
        print(f"profile trace written to "
              f"{profiling.stop_trace(prof, f'{cfg.output_dir}/profile')}")
    # final checkpoint so downstream stages (record) always find a model,
    # even when training stopped between checkpoint intervals
    if primary and it != it0 and it % cfg.iters_per_checkpoint != 0:
        ckpt_lib.save(ckpt_dir, it, ppo_lib.persistent_state(local, state))
    if timers.summary():
        print("phase timers:\n" + timers.report())
    return state


def _log_iteration(logger: Logger, agent: PPOAgent, state: AgentState,
                   metrics, test: dict, it: int, iter_time: float,
                   t_start: float, meta: Optional[dict]) -> None:
    """One row of the training log (the primary rank's)."""
    logger.log("Iteration", it)
    logger.log("Samples", float(state.sample_count))
    logger.log("Wall_Time", (time.time() - t_start) / 3600.0)
    logger.log("Train_Reward", metrics.mean_reward)
    logger.log("Test_Reward", test["mean_reward"])
    logger.log("Test_Return", test["mean_return"])
    logger.log("Test_Episodes", test["num_eps"], quiet=True)
    logger.log("Test_Episode_Length", test["mean_ep_len"])
    logger.log("Test_Fail_Frac", test["fail_frac"])
    comp = test["component_returns"].cpu().numpy()
    for name, v in zip(REWARD_COMPONENT_NAMES, comp):
        logger.log(f"Return_{name}", float(v), quiet=True)
    logger.log("Actor_Loss", metrics.actor_loss)
    logger.log("Critic_Loss", metrics.critic_loss)
    logger.log("Clip_Frac", metrics.clip_frac)
    logger.log("Samples_Per_Sec",
               agent.cfg.steps_per_iter * agent.env.cfg.num_envs / iter_time)
    terr = test["tracking_error"].cpu().numpy()
    for name, v in zip(TRACKING_ERROR_NAMES, terr):
        logger.log(name, v, quiet=True)
    fr = state.env_state.fail_rates.cpu().numpy()
    for q in (0.5, 0.9, 0.99):
        logger.log(f"Fail_Rate_q{q}", float(np.quantile(fr, q)), quiet=True)
    log_fail_rate_tables(logger, fr, meta, top_k=10)
    logger.end_iter()


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree
