"""LSTM kernels B1 + B2 (``ops/lstm.py`` -> ``csrc/lstm.cu``): the least
time of the traced traffic's single-layer recurrences, forward and
backward, over the device time of the kernels named below.  Moves
``resynth_s``."""

from portbench.yardstick import readers

KERNELS = ("lstm_fwd_persistent", "lstm_bwd_persistent")


def read(cell):
    return readers.roofline(cell, "resynth", "single", KERNELS)
