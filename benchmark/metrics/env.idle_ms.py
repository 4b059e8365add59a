"""Idle ms an iteration in the env step: the measured idle of an iteration
apportioned to the traced gaps under ``parc.env.step`` and its parts
(``.reference``, ``.reward``, ``.obs``, ``.reset``) and under the rollout's
reset pool (``parc.env.reset_pool``), harness/spans. None where the
program opens no such span."""

from harness import spans

NAMES = ("parc.env.step", "parc.env.reference", "parc.env.reward",
         "parc.env.obs", "parc.env.reset", "parc.env.reset_pool")


def read(run):
    return spans.idle_ms(run, NAMES)
