"""LSTM kernels, one-layer recurrences of the somatosensory model set
(the predictive and tube models, the tube embedder's layers one by one):
the least time of the single-layer ops that the profiled calls recorded
at their own (T, B, H), over those ops' device time from the CUDA events
around each launch (program spans; no kernel names).  Moves
``corpus_utt_per_s``."""

from portbench.yardstick import model_spans


def read(cell):
    return model_spans.op_roofline(cell, "corpus_soma", "single")
