"""Host synthesis (``synth/``): ms of the ``plan_resynth.synthesis`` span,
the part that planning did not overlap, per snapshot synthesised.  Moves
``resynth_s``."""

from portbench.yardstick import readers


def read(cell):
    return readers.phase_ms_per(cell, "resynth", "synthesis", "snapshots")
