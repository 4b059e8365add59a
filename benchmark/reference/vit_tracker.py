"""The reference of the tracker with PARC's transformer policy: the frozen
copy's DeepMimic env, plain physics and PPO agent with the float32 ViT of
``reference/learning/vision_nets.py``, built from the inputs the benchmark
hands both sides, with TF32 off (``tracker.float32_exact``), or, as the
control, with every dense layer of the ViT's trunk (the tokenizer's
projection, the segment tokens', each encoder layer's q, k, v, output and
FFN) in fp8 (``fp8.use_fp8``).

At the cell's size one update minibatch (16,384 rows) does not fit the
card in float32 with the activations its backward pass keeps (some 5 MB a
row), and the targets' critic passes cover all 131,072 rows of the
iteration. So the agent here computes both in row blocks of ``rows``:

* the critic's values block by block (a row's value depends on its row
  alone);
* each minibatch's gradient as the sum of its blocks' gradients, each
  block's loss terms summed over its rows and divided by the minibatch's
  count (or by its exploration-mask sum, for the actor's term), so that the
  blocks' losses add up to the minibatch's loss. The guard that holds the
  actor still where the minibatch's critic loss exceeds its bound needs
  that loss before any block's backward pass: one pass without autograd
  over the whole minibatch reads its losses (what the recorders keep and
  the iteration's metrics average), then the blocks run forward and
  backward.

Only the order of the sums differs from the whole minibatch's.
"""

from __future__ import annotations

import torch

from reference import fp8
from reference.anim import motion_lib as ml
from reference.data.humanoid import humanoid_spec
from reference.envs.base import EnvConfig
from reference.envs.deepmimic import DeepMimicEnv
from reference.learning import distributions as dist
from reference.learning.ppo import _FLAT_KEYS, PPOAgent, PPOConfig
from reference.physics.engine import SimParams
from reference.tracker import clip_data


def trunk_modules(net) -> list:
    """The ViT's trunk, whose dense layers the control takes to fp8."""
    return [net.tokenizer, net.seg_dense, net.layers]


class BlockedPPOAgent(PPOAgent):
    """The frozen PPO agent with its critic passes and its minibatch
    gradients computed in blocks of ``rows`` rows."""

    def __init__(self, env, cfg: PPOConfig, device, rows: int):
        super().__init__(env, cfg, device)
        self.rows = rows

    def _targets(self, batch, obs_norm, group=None):
        net = self.net
        whole = net.critic

        def critic(obs):
            flat = obs.reshape(-1, obs.shape[-1])
            return torch.cat([whole(b) for b in flat.split(self.rows)]
                             ).reshape(obs.shape[:-1])

        net.critic = critic
        try:
            return super()._targets(batch, obs_norm, group)
        finally:
            del net.critic

    def _block_loss(self, norm_obs, norm_a, old_logp, adv, tar_val,
                    rand_mask, count: int, mask_sum: torch.Tensor,
                    held: bool) -> torch.Tensor:
        """A block's share of its minibatch's loss (``PPOAgent._loss``):
        each term's sum over the block over the minibatch's ``count`` rows
        (the actor's over its ``mask_sum``), the actor's term left out
        where the guard ``held`` it."""
        cfg = self.cfg
        mean, logstd, pred_val = self.net(norm_obs)
        critic = torch.sum((tar_val - pred_val) ** 2) / count
        ratio = torch.exp(dist.log_prob(mean, logstd, norm_a) - old_logp)
        per_sample = torch.minimum(
            adv * ratio, adv * torch.clamp(ratio, 1.0 - cfg.ppo_clip_ratio,
                                           1.0 + cfg.ppo_clip_ratio))
        viol_lo = torch.clamp(mean + 1.0, max=0.0)
        viol_hi = torch.clamp(mean - 1.0, min=0.0)
        bound = torch.sum(viol_lo ** 2 + viol_hi ** 2) / count
        loss = (cfg.critic_loss_weight * critic
                + cfg.action_bound_weight * bound)
        if not held:
            loss = loss - torch.sum(per_sample * rand_mask) / mask_sum
        if cfg.action_entropy_weight != 0.0:
            loss = loss - cfg.action_entropy_weight * torch.sum(
                dist.entropy(logstd)) / count
        return loss

    def _update(self, flat, optimizer, generator, mb_size: int, group=None):
        if group is not None:
            raise ValueError("the reference runs on one device")
        n = flat["rand_mask"].shape[0]
        num_mb = max(n // mb_size, 1)
        auxes = []
        for _ in range(self.cfg.update_epochs):
            perm = torch.randperm(n, generator=generator, device=self.device)
            for i in range(num_mb):
                idx = perm[i * mb_size:(i + 1) * mb_size]
                mb = [flat[k][idx] for k in _FLAT_KEYS]
                with torch.no_grad():
                    _, aux = self._loss(*mb)
                held = bool(aux["critic_loss"] > self.cfg.critic_loss_guard)
                mask_sum = torch.clamp(torch.sum(mb[-1]), min=1.0)
                optimizer.zero_grad(set_to_none=True)
                for block in zip(*(t.split(self.rows) for t in mb)):
                    self._block_loss(*block, count=len(idx),
                                     mask_sum=mask_sum, held=held).backward()
                if self.cfg.clip_grad_norm:
                    self._clip_grads()
                optimizer.step()
                auxes.append(aux)
        return {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}


def build(clips, env_cfg: dict, sim: dict, ppo: dict, num_envs: int,
          seed: int, device, rows: int, control: bool = False):
    """(agent, lib, state) of the reference, ready for ``train_iter``;
    ``ppo`` must name the ViT (``actor_net`` ``dm_vit``)."""
    from harness.cfg import build as from_json  # plain config reader
    model = humanoid_spec().build(device=device)
    lib = ml.build_motion_lib(model, clip_data(clips), device=device)
    env = DeepMimicEnv(model, from_json(SimParams, sim),
                       from_json(EnvConfig, env_cfg, num_envs=num_envs),
                       device=device)
    cfg = from_json(PPOConfig, ppo, bf16_compute=False)
    if cfg.actor_net != "dm_vit":
        raise ValueError(f"actor_net {cfg.actor_net!r} is not the ViT")
    agent = BlockedPPOAgent(env, cfg, device, rows)
    state = agent.init(lib, torch.Generator(device=device).manual_seed(seed))
    if control:
        fp8.use_fp8(trunk_modules(agent.net))
    return agent, lib, state
