"""Idle ms a training step in the update: the measured idle of a step
apportioned to the traced gaps under ``parc.mdm.update`` (the gradients'
clip, AdamW, the EMA) and PyTorch's ``Optimizer.step`` spans inside it,
harness/spans. None where the program opens no such span."""

from harness import spans


def read(run):
    return spans.idle_ms(run, ("parc.mdm.update",), inner=("Optimizer.step",))
