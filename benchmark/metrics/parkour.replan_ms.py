"""Mean ms of one in-step replan (``ParkourEnv._replan``: the mgdm rows'
DDIM window), from CUDA events the benchmark records around each call in
the measured window of the traced run."""


def read(run):
    return run.span_ms("replan")
