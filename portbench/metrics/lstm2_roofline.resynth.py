"""LSTM kernels B3 + B4 (the fused two-layer pair, ``csrc/lstm.cu``):
the least time of the traced traffic's two-layer recurrences, forward and
backward, over the device time of the kernels named below.  Moves
``resynth_s``."""

from portbench.yardstick import readers

KERNELS = ("lstm_stack2_fwd_persistent", "lstm_stack2_bwd_persistent")


def read(cell):
    return readers.roofline(cell, "resynth", "pair", KERNELS)
