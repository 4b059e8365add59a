"""Mean wall ms of ``train_iter``'s rollout half over the measured window,
from the program's PhaseTimer (which synchronizes at the half's end)."""


def read(run):
    return run.phase_ms("rollout")
