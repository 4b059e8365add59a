"""PPO agent: configuration, network, state, rollout and the train iteration.

One :meth:`PPOAgent.train_iter` is a rollout (``steps_per_iter`` control
steps over all envs, a Python loop around the env step), TD(lambda) targets,
and ``update_epochs`` epochs of minibatch SGD. Nothing inside it reads a
value back to the host: the metrics stay tensors until the caller reads them.

The network's parameters live in ``PPOAgent.net``; the optimizer that holds
their momentum buffers, and the generator every random draw comes from, live
in :class:`AgentState`. The optimizer is SGD with momentum (optax's ``sgd`` +
``trace``), after a clip of the gradients' global norm.

Hyperparameter defaults follow PARC/tracker_config/dm_agent_default.yaml.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from parc_torch import resolve_device
from parc_torch.envs.base import DoneFlags, EnvState
from parc_torch.learning import distributions as dist
from parc_torch.learning import normalizer as norm_lib
from parc_torch.learning import rl_util
from parc_torch.learning.networks import ActorCritic
from parc_torch.parallel import mesh
from parc_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    steps_per_iter: int = 32
    # reset-pool depth: done envs pull pre-sampled reset states/obs from a
    # pool built once per iteration (k full batches) instead of paying a
    # second full obs pass every step (envs/deepmimic.py ResetPool).
    # 0 = inline resets.
    reset_pool_k: int = 4
    discount: float = 0.99
    td_lambda: float = 0.95
    ppo_clip_ratio: float = 0.2
    update_epochs: int = 5
    batch_size: int = 4               # minibatch = batch_size * num_envs
    critic_loss_weight: float = 10.0
    critic_loss_guard: float = 20.0  # actor grads cut above this
    action_bound_weight: float = 10.0
    action_entropy_weight: float = 0.0
    norm_adv_clip: float = 4.0
    norm_obs_clip: float = 10.0
    normalizer_samples: float = 3e8
    learning_rate: float = 5e-5
    momentum: float = 0.9
    clip_grad_norm: Optional[float] = 1000.0
    exp_prob_beg: float = 1.0
    exp_prob_end: float = 1.0
    exp_anneal_samples: float = float("inf")
    reward_succ: float = 1.0
    reward_fail: float = 0.0
    reward_min: float = 0.0
    reward_max: float = 1.0

    actor_net: str = "fc_3layers_2048units"
    critic_net: str = "fc_3layers_2048units"
    # bf16 trunk matmuls on CUDA (params/heads/losses stay f32, the CPU
    # stays full f32)
    bf16_compute: bool = True
    actor_std_type: str = "FIXED"
    action_std: float = 0.05
    actor_init_output_scale: float = 0.01


@dataclasses.dataclass
class AgentState:
    """Per-run agent state; the network's parameters live in
    ``PPOAgent.net``, their momentum buffers in ``optimizer``."""

    obs_norm: norm_lib.NormalizerState
    env_state: EnvState
    sample_count: torch.Tensor  # ()
    optimizer: Optional[torch.optim.SGD] = None
    generator: Optional[torch.Generator] = None

    def replace(self, **changes) -> "AgentState":
        return dataclasses.replace(self, **changes)


_NORM_FIELDS = ("mean", "var", "count", "norm_mask")


def persistent_state(agent: "PPOAgent", state: AgentState) -> dict:
    """Checkpointable snapshot (copies) of the parameters, their momentum
    buffers, the normalizer, the sample count and the per-motion fail
    rates. Per-env transients (sim state, obs buffers) are excluded, so a
    checkpoint restores into any ``num_envs``."""
    params = dict(agent.net.named_parameters())
    opt = state.optimizer
    return {
        "params": {k: p.detach().clone() for k, p in params.items()},
        "opt_state": {"momentum": {
            k: opt.state[p]["momentum_buffer"].clone()
            for k, p in params.items()}},
        "obs_norm": {**{f: getattr(state.obs_norm, f).clone()
                        for f in _NORM_FIELDS},
                     "clip": state.obs_norm.clip,
                     "sample_limit": state.obs_norm.sample_limit},
        "sample_count": state.sample_count.clone(),
        "fail_rates": state.env_state.fail_rates.clone(),
    }


def merge_persistent(agent: "PPOAgent", state: AgentState,
                     restored: dict) -> AgentState:
    """Inverse of :func:`persistent_state` against a fresh init: the
    parameters and momentum buffers are copied into ``agent.net`` and
    ``state.optimizer`` in place, the rest replaces ``state``'s fields."""
    dev = agent.device
    params = dict(agent.net.named_parameters())
    momentum = restored["opt_state"]["momentum"]
    if set(momentum) != set(params):
        raise KeyError(f"momentum buffers {sorted(momentum)} do not match "
                       f"the parameters {sorted(params)}")
    agent.net.load_state_dict(restored["params"])
    with torch.no_grad():
        for k, p in params.items():
            state.optimizer.state[p]["momentum_buffer"].copy_(momentum[k])
    norm = restored["obs_norm"]
    obs_norm = norm_lib.NormalizerState(
        **{f: norm[f].to(dev, torch.float32) for f in _NORM_FIELDS},
        clip=float(norm["clip"]), sample_limit=float(norm["sample_limit"]))
    return state.replace(
        obs_norm=obs_norm,
        sample_count=restored["sample_count"].to(dev, torch.float32),
        env_state=state.env_state.replace(
            fail_rates=restored["fail_rates"].to(dev, torch.float32)))


@dataclasses.dataclass
class TrainMetrics:
    mean_reward: torch.Tensor
    mean_return_done: torch.Tensor   # mean episodic proxy: reward over batch
    actor_loss: torch.Tensor
    critic_loss: torch.Tensor
    bound_loss: torch.Tensor
    clip_frac: torch.Tensor
    adv_mean: torch.Tensor
    adv_std: torch.Tensor
    num_dones: torch.Tensor
    num_fails: torch.Tensor
    mean_ep_time: torch.Tensor
    tracking_error: torch.Tensor     # (7,)


_FLAT_KEYS = ("norm_obs", "norm_a", "logp", "adv", "tar_val", "rand_mask")


class PPOAgent:
    """Holds the config, the network and the env's action scaling."""

    def __init__(self, env, cfg: PPOConfig = PPOConfig(), device="cuda"):
        self.env = env
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = (torch.bfloat16 if cfg.bf16_compute
                              and self.device.type == "cuda" else None)
        self.net = self._build_net(generator=None)
        lo, hi = env.action_bounds()
        lo = torch.as_tensor(lo, device=self.device)
        hi = torch.as_tensor(hi, device=self.device)
        self.a_mid = (hi + lo) / 2.0
        self.a_scale = (hi - lo) / 2.0

    def _build_net(self, generator) -> torch.nn.Module:
        """The actor-critic net of ``cfg.actor_net``: the vision policies
        (``dm_cnn_mlp``, ``dm_vit``: one trunk for both heads, fixed std)
        or an MLP ActorCritic."""
        cfg = self.cfg
        if cfg.actor_net in ("dm_cnn_mlp", "dm_vit"):
            from parc_torch.envs import perception
            from parc_torch.learning import vision_nets
            cls = (vision_nets.DMCnnMlp if cfg.actor_net == "dm_cnn_mlp"
                   else vision_nets.DMViT)
            return cls(self.env.action_dim, self.env.obs_layout,
                       perception.hf_shape(self.env.cfg),
                       action_std=cfg.action_std,
                       actor_init_output_scale=cfg.actor_init_output_scale,
                       generator=generator, device=self.device,
                       compute_dtype=self.compute_dtype)
        return ActorCritic(
            self.env.obs_dim, self.env.action_dim,
            actor_net=cfg.actor_net, critic_net=cfg.critic_net,
            actor_std_type=cfg.actor_std_type, action_std=cfg.action_std,
            actor_init_output_scale=cfg.actor_init_output_scale,
            generator=generator, device=self.device,
            compute_dtype=self.compute_dtype)

    def _make_optimizer(self) -> torch.optim.SGD:
        """SGD with momentum over ``net``'s parameters, its momentum
        buffers zero (optax's ``trace`` starts at zero; the first step is
        the same either way)."""
        opt = torch.optim.SGD(self.net.parameters(), lr=self.cfg.learning_rate,
                              momentum=self.cfg.momentum)
        for p in self.net.parameters():
            opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
        return opt

    def init(self, lib, generator: torch.Generator) -> AgentState:
        """Fresh network weights, optimizer and env state, drawn from
        ``generator`` (on the agent's device), which the state keeps."""
        self.net = self._build_net(generator)
        env_state = self.env.reset(lib, generator)
        obs_dim = self.env.obs_dim
        norm_mask = torch.as_tensor(~self.env.obs_layout.non_norm_mask(),
                                    dtype=torch.float32)
        obs_norm = norm_lib.create(
            obs_dim, norm_mask, clip=self.cfg.norm_obs_clip,
            sample_limit=self.cfg.normalizer_samples, device=self.device)
        return AgentState(obs_norm=obs_norm, env_state=env_state,
                          sample_count=torch.zeros((), device=self.device),
                          optimizer=self._make_optimizer(),
                          generator=generator)

    def _action_from_norm(self, norm_a: torch.Tensor) -> torch.Tensor:
        return self.a_mid + self.a_scale * norm_a

    @torch.no_grad()
    def act(self, agent: AgentState, obs: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = True) -> torch.Tensor:
        """Single-step policy evaluation: the action mean, or a Gaussian
        sample drawn with ``generator`` when ``deterministic`` is False."""
        norm_obs = norm_lib.normalize(agent.obs_norm, obs)
        mean, logstd = self.net.actor(norm_obs)
        if deterministic or generator is None:
            norm_a = mean
        else:
            norm_a = dist.sample(generator, mean, logstd)
        return self._action_from_norm(norm_a)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def rollout(self, lib, agent: AgentState, exp_prob: torch.Tensor
                ) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
        """Collect steps_per_iter transitions; returns the final env state
        and the batch dict of [T, B, ...] tensors."""
        cfg, g, dev = self.cfg, agent.generator, self.device
        es = agent.env_state
        n = es.done.shape[0]
        pool, pool_k = None, cfg.reset_pool_k
        if pool_k > 0 and hasattr(self.env, "build_reset_pool"):
            with annotate("parc.env.reset_pool"):
                pool = self.env.build_reset_pool(lib, g, es.fail_rates, n,
                                                 k=pool_k)
        reset_counts = torch.zeros((n,), dtype=torch.long, device=dev)
        steps = []
        for _ in range(cfg.steps_per_iter):
            obs = es.obs
            with annotate("parc.ppo.act"):
                norm_obs = norm_lib.normalize(agent.obs_norm, obs)
                mean, logstd = self.net.actor(norm_obs)
                a_rand = dist.sample(g, mean, logstd)
                rand_mask = (torch.rand(mean.shape[:-1], generator=g,
                                        device=dev) < exp_prob).float()
                norm_a = torch.where(rand_mask[..., None] > 0, a_rand, mean)
                logp = dist.log_prob(mean, logstd, norm_a)
                action = self._action_from_norm(norm_a)
            if pool is not None:
                es = self.env.step(lib, es, action, reset_pool=pool,
                                   pool_slot=reset_counts % pool_k,
                                   generator=g)
                reset_counts += (es.done != DoneFlags.NULL).long()
            else:
                es = self.env.step(lib, es, action, generator=g)
            steps.append({
                "obs": obs,
                "norm_a": norm_a,
                "logp": logp,
                "rand_mask": rand_mask,
                "reward": es.reward,
                "done": es.done,
                "next_obs": es.terminal_obs,
                "ep_time": es.terminal_times,
                "tracking_error": es.tracking_error,
            })
        batch = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        return es, batch

    # ------------------------------------------------------------------
    def _loss(self, norm_obs, norm_a, old_logp, adv, tar_val, rand_mask):
        cfg = self.cfg
        mean, logstd, pred_val = self.net(norm_obs)

        critic_loss = torch.mean((tar_val - pred_val) ** 2)

        logp = dist.log_prob(mean, logstd, norm_a)
        ratio = torch.exp(logp - old_logp)
        surr0 = adv * ratio
        surr1 = adv * torch.clamp(ratio, 1.0 - cfg.ppo_clip_ratio,
                                  1.0 + cfg.ppo_clip_ratio)
        per_sample = torch.minimum(surr0, surr1)
        mask_sum = torch.clamp(torch.sum(rand_mask), min=1.0)
        actor_loss = -torch.sum(per_sample * rand_mask) / mask_sum
        # exploding-critic guard: when the critic can't be trusted, stop
        # its advantages from driving the actor (reference:
        # ppo_agent.py:225-238 detaches actor_loss at critic_loss > 20);
        # a select, not a host branch, so the step does not sync
        actor_loss = torch.where(critic_loss > cfg.critic_loss_guard,
                                 actor_loss.detach(), actor_loss)

        # action bound loss on the (normalized) mode
        viol_lo = torch.clamp(mean + 1.0, max=0.0)
        viol_hi = torch.clamp(mean - 1.0, min=0.0)
        bound_loss = torch.mean(torch.sum(viol_lo**2 + viol_hi**2, dim=-1))

        loss = (actor_loss + cfg.critic_loss_weight * critic_loss
                + cfg.action_bound_weight * bound_loss)
        if cfg.action_entropy_weight != 0.0:
            loss = loss - cfg.action_entropy_weight * torch.mean(
                dist.entropy(logstd))

        clip_frac = torch.sum(
            (torch.abs(ratio - 1.0) > cfg.ppo_clip_ratio) * rand_mask
        ) / mask_sum
        aux = dict(actor_loss=actor_loss, critic_loss=critic_loss,
                   bound_loss=bound_loss, clip_frac=clip_frac)
        return loss, aux

    def _clip_grads(self) -> None:
        """optax.clip_by_global_norm: scale every gradient by max / norm
        where the global norm exceeds max (no epsilon, unlike
        torch.nn.utils.clip_grad_norm_), without a host sync."""
        max_norm = self.cfg.clip_grad_norm
        grads = [p.grad for p in self.net.parameters() if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < max_norm, torch.ones_like(norm),
                            max_norm / norm)
        for g in grads:
            g.mul_(scale)

    # ------------------------------------------------------------------
    def train_iter(self, lib, agent: AgentState, timer=None, group=None
                   ) -> Tuple[AgentState, TrainMetrics]:
        """One full PPO iteration. Updates ``net`` and ``agent.optimizer``
        in place and returns the new state and the iteration's metrics.
        ``timer`` (a profiling.PhaseTimer) times its "rollout" and
        "update" halves, synchronizing the device at the end of each.

        With a process ``group`` (data parallelism, parallel/mesh.py) this
        rank's env batch is its share, and the quantities the JAX package
        reduces over its 'data' axis are all-reduced over the ranks: the
        normalizer's sums, the advantage moments, every minibatch's
        gradients (averaged before the clip) and the sample count."""
        cfg, dev = self.cfg, self.device

        def phase(name):
            return (contextlib.nullcontext() if timer is None
                    else timer.phase(name, sync_on=dev))

        # annealed exploration probability
        if math.isfinite(cfg.exp_anneal_samples):
            frac = torch.clamp(agent.sample_count / cfg.exp_anneal_samples,
                               0.0, 1.0)
            exp_prob = (1 - frac) * cfg.exp_prob_beg + frac * cfg.exp_prob_end
        else:
            exp_prob = torch.tensor(cfg.exp_prob_beg, device=dev)

        with phase("rollout"):
            env_state, batch = self.rollout(lib, agent, exp_prob)

        with phase("update"):
            obs_norm = norm_lib.update(agent.obs_norm, batch["obs"],
                                       group=group)
            with torch.no_grad():
                tar_val, norm_adv, adv_mean, adv_std, norm_obs = (
                    self._targets(batch, obs_norm, group))
            t, b = batch["reward"].shape
            flat = {
                "norm_obs": norm_obs.reshape(t * b, -1),
                "norm_a": batch["norm_a"].reshape(t * b, -1),
                "logp": batch["logp"].reshape(t * b),
                "adv": norm_adv.reshape(t * b),
                "tar_val": tar_val.reshape(t * b),
                "rand_mask": batch["rand_mask"].reshape(t * b),
            }
            auxes = self._update(flat, agent.optimizer, agent.generator,
                                 mb_size=min(cfg.batch_size * b, t * b),
                                 group=group)

        dones = batch["done"] != DoneFlags.NULL
        metrics = TrainMetrics(
            mean_reward=torch.mean(batch["reward"]),
            mean_return_done=torch.mean(tar_val),
            actor_loss=torch.mean(auxes["actor_loss"]),
            critic_loss=torch.mean(auxes["critic_loss"]),
            bound_loss=torch.mean(auxes["bound_loss"]),
            clip_frac=torch.mean(auxes["clip_frac"]),
            adv_mean=adv_mean, adv_std=adv_std,
            num_dones=torch.sum(dones.int()),
            num_fails=torch.sum((batch["done"] == DoneFlags.FAIL).int()),
            mean_ep_time=torch.mean(batch["ep_time"]),
            tracking_error=torch.mean(batch["tracking_error"], dim=(0, 1)),
        )
        samples = mesh.psum(agent.sample_count.new_tensor(float(t * b)),
                            group)
        new_agent = agent.replace(obs_norm=obs_norm, env_state=env_state,
                                  sample_count=agent.sample_count + samples)
        return new_agent, metrics

    def _targets(self, batch, obs_norm, group=None):
        """TD(lambda) value targets and the normalized advantages; with a
        ``group``, the local advantage mean and the local variance (about
        the local mean) are averaged over the ranks, as the JAX package
        does (not the variance of the union)."""
        cfg = self.cfg
        norm_next = norm_lib.normalize(obs_norm, batch["next_obs"])
        next_vals = self.net.critic(norm_next)
        val_min = cfg.reward_min / (1.0 - cfg.discount)
        val_max = cfg.reward_max / (1.0 - cfg.discount)
        next_vals = torch.clamp(next_vals, val_min, val_max)
        # SUCC bootstrap kept for parity with the reference's value targets
        # (learning/base_agent.py:408-422); no shipped env emits SUCC
        done = batch["done"]
        next_vals = torch.where(done == DoneFlags.SUCC,
                                cfg.reward_succ / (1.0 - cfg.discount),
                                next_vals)
        next_vals = torch.where(done == DoneFlags.FAIL,
                                cfg.reward_fail / (1.0 - cfg.discount),
                                next_vals)
        tar_val = rl_util.compute_td_lambda_return(
            batch["reward"], next_vals, done, cfg.discount, cfg.td_lambda)

        norm_obs = norm_lib.normalize(obs_norm, batch["obs"])
        adv = tar_val - self.net.critic(norm_obs)
        mask = batch["rand_mask"]
        mask_sum = torch.clamp(torch.sum(mask), min=1.0)
        adv_mean = torch.sum(adv * mask) / mask_sum
        adv_var = torch.sum(((adv - adv_mean) ** 2) * mask) / mask_sum
        adv_mean, adv_var = mesh.pmean(torch.stack([adv_mean, adv_var]),
                                       group)
        adv_std = torch.sqrt(torch.clamp(adv_var, min=1e-10))
        norm_adv = torch.clamp((adv - adv_mean) / torch.clamp(adv_std,
                                                              min=1e-5),
                               -cfg.norm_adv_clip, cfg.norm_adv_clip)
        return tar_val, norm_adv, adv_mean, adv_std, norm_obs

    def _allreduce_grads(self, group) -> None:
        """Average the gradients over the ranks: one all-reduce over one
        flat buffer."""
        grads = [p.grad for p in self.net.parameters() if p.grad is not None]
        w = mesh.world_size(group)
        for g, v in zip(grads, mesh.psum_flat(grads, group)):
            g.copy_(v / w)

    def _update(self, flat, optimizer, generator, mb_size: int, group=None
                ) -> Dict[str, torch.Tensor]:
        """update_epochs epochs of minibatch SGD over the flat batch, each
        epoch in a fresh random order; returns the stacked loss terms. With
        a ``group``, each minibatch's gradients are averaged over the ranks
        before the clip."""
        n = flat["rand_mask"].shape[0]
        num_mb = max(n // mb_size, 1)
        auxes = []
        for _ in range(self.cfg.update_epochs):
            perm = torch.randperm(n, generator=generator, device=self.device)
            for i in range(num_mb):
                idx = perm[i * mb_size:(i + 1) * mb_size]
                loss, aux = self._loss(*(flat[k][idx] for k in _FLAT_KEYS))
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                if group is not None:
                    self._allreduce_grads(group)
                if self.cfg.clip_grad_norm:
                    self._clip_grads()
                optimizer.step()
                auxes.append({k: v.detach() for k, v in aux.items()})
        return {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}
