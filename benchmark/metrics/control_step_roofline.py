"""The control-step kernel's share of its roofline: the least time one
control step's work could take on the card (the larger of its operations
at the f32 peak and its bytes at the card's memory rate, counted from the
model and the env count by harness/counts) over the mean device time of a
launch of ``control_step_kernel`` in the traced window. None where no such
kernel ran."""

from harness import counts


def read(run):
    times = run.trace.kernel_times("control_step_kernel")
    if not times:
        return None
    least = max(run.work["control_step_ops"] / counts.PEAK_FLOPS["f32"],
                run.work["control_step_bytes"]
                / counts.mem_rate(run.device_name))
    return counts.share(least, sum(times) / len(times))
