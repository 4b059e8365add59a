"""Idle ms an iteration in the physics driver: the measured idle of an
iteration apportioned to the traced gaps under
``parc.physics.control_step`` (``physics/engine.py`` ``control_step``: the
pack, the kernel's launch with its terrain view, the unpack),
harness/spans. None where the program opens no such span."""

from harness import spans


def read(run):
    return spans.idle_ms(run, ("parc.physics.control_step",))
