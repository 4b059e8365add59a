"""Mean wall ms of ``train_iter``'s update half (normalizer, targets, the
epochs of minibatch SGD) over the measured window, from the program's
PhaseTimer."""


def read(run):
    return run.phase_ms("update")
