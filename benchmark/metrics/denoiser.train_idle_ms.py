"""Idle ms a training step in the denoiser's forward and backward: the
measured idle of a step apportioned to the traced gaps under
``parc.mdm.forward`` (the loss) and ``parc.mdm.backward`` (the gradients'
reset, PyTorch's ``Optimizer.zero_grad`` span, and the backward pass),
harness/spans. None where the program opens no such span."""

from harness import spans


def read(run):
    return spans.idle_ms(run, ("parc.mdm.forward", "parc.mdm.backward"),
                         inner=("Optimizer.zero_grad",))
