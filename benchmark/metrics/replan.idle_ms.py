"""Idle ms a replan: the measured idle of an iteration apportioned to the
traced gaps under ``parc.env.replan`` and its DDIM timesteps'
``parc.ddim.denoise`` (harness/spans), over the replans a traced
iteration ran. None where the program opens no replan span."""

from harness import spans


def read(run):
    replans = spans.count(run, "parc.env.replan")
    idle = spans.idle_ms(run, ("parc.env.replan", "parc.ddim.denoise"))
    if idle is None or not replans:
        return None
    return idle * run.traced_steps / replans
