"""Device: milliseconds in which the card ran a kernel or a copy per
planning inner step of the traced call (its whole work, continue-learning
and the rest included, over its 250 steps): the call's device work,
steadier than its wall, which the host's speed moves.  Moves
``resynth_s``."""

from portbench.yardstick import readers


def read(cell):
    value = readers.device_s_per(cell, "resynth", "inner_steps")
    return None if value is None else 1e3 * value
