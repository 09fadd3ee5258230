"""Planning engine (``planning/engine.py`` through ``api.py``): ms of the
``plan_resynth.planning`` span per inner step.  Moves ``resynth_s``."""

from portbench.yardstick import readers


def read(cell):
    return readers.phase_ms_per(cell, "resynth", "planning", "inner_steps")
