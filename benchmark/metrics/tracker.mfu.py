"""The whole PPO iteration's share of the card's dense bf16 peak: the
networks' operations of an iteration (harness/counts.ppo_iteration_flops:
the actor in the rollout, the critic for the targets, the epochs of both
nets forward and backward), plus those of the in-step replans where the
cell counts them, over the mean wall time of an iteration of the measured
window."""

from harness import counts


def read(run):
    flops = run.work["iter_flops"] + run.work.get("replan_flops", 0.0)
    return counts.share(flops / counts.PEAK_FLOPS["bf16"], run.step_s)
