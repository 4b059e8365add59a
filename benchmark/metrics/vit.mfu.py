"""The ViT policy's share of the card's dense bf16 peak in the tracker's
iteration: its operations of an iteration over the iteration's mean wall
time in the measured window. The operations are the trunk's rows of an
iteration times harness/vit_counts' forward operations a row, plus the
rows taken under autograd times its backward operations a row, the rows
counted by the program's own counters (``DMViT.rows``, ``.grad_rows``)
over the window. Of the work of an iteration it leaves out the physics and
the env step. None where the program counts no rows."""

from harness import counts


def read(run):
    w = run.work
    if "vit_rows" not in w:
        return None
    flops = (w["vit_rows"] * w["vit_forward_flops"]
             + w["vit_grad_rows"] * w["vit_backward_flops"])
    return counts.share(flops / counts.PEAK_FLOPS["bf16"], run.step_s)
