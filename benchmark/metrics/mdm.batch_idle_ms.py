"""Idle ms a training step in the batch's making: the measured idle of a
step apportioned to the traced gaps under ``parc.mdm.batch`` (the batch's
and the loss's draws, ``batch_from_draws``), harness/spans. None where the
program opens no such span."""

from harness import spans


def read(run):
    return spans.idle_ms(run, ("parc.mdm.batch",))
