"""Whole step: the model FLOPs of the window's traffic over the window's
seconds x 67 TFLOP/s (float32, outside the tensor cores) x cards.  Moves
``corpus_utt_per_s``."""

from portbench.yardstick import readers


def read(cell):
    return readers.mfu(cell, "corpus")
