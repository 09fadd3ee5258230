"""Continue-learning (``planning/trainer.py``): ms of the
``plan_resynth.continue_learning`` span per Adam step.  Moves
``resynth_s``."""

from portbench.yardstick import readers


def read(cell):
    return readers.phase_ms_per(cell, "resynth", "continue_learning",
                                "adam_steps")
