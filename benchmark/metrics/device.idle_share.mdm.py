"""Share of the time (%) in which no operation ran on the device: 1 - the
union of the device operations' intervals over the traced steps, against
the wall time those steps take in the measured window (``Run.idle_share``;
the traced window itself runs slower under the profiler)."""


def read(run):
    return run.idle_share()
