"""Idle ms an iteration in the rollout's policy: the measured idle of an
iteration apportioned to the traced gaps under ``parc.ppo.act`` (each
rollout step's normalization, actor forward, sample, exploration mask,
log-prob and action), harness/spans. None where the program opens no such
span."""

from harness import spans


def read(run):
    return spans.idle_ms(run, ("parc.ppo.act",))
