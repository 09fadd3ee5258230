"""Batched planning (``parallel/batched.py``): ms of the
``plan_batch_resynth.planning`` span per inner step of a batch.  Moves
``corpus_utt_per_s``."""

from portbench.yardstick import readers


def read(cell):
    return readers.phase_ms_per(cell, "corpus", "planning", "inner_steps")
