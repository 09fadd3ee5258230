"""LSTM kernels, one-layer recurrences (B1 + B2 today): the least time of
the single-layer ops that the profiled calls recorded at their own (T, B,
H), over those ops' device time from the CUDA events around each launch
(program spans; no kernel names).  Moves ``corpus_utt_per_s``."""

from portbench.yardstick import spans


def read(cell):
    return spans.roofline(cell, "corpus", "single")
