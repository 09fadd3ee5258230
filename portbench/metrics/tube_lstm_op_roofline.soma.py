"""LSTM kernels, the tube models' ops: the least time of the LSTM ops that
the cp->tube and tube->mel models launched in the profiled calls, at
their own (T, B, H), over those ops' device time from the CUDA events
around each launch (program spans; no kernel names).  Moves
``corpus_utt_per_s``."""

from portbench.yardstick import model_spans


def read(cell):
    return model_spans.tube_op_roofline(cell, "corpus_soma")
