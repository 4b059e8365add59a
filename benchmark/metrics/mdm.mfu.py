"""The MDM training step's share of the card's dense bf16 peak: the
denoiser's full forward (condition tokens included) and its backward at
twice the forward (harness/counts.mdm_train_step_flops), over the mean wall
time of a step of the measured window."""

from harness import counts


def read(run):
    return counts.share(run.work["step_flops"] / counts.PEAK_FLOPS["bf16"],
                        run.step_s)
