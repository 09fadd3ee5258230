"""Device: percent of the time in which no kernel or copy ran, averaged
over the cards: the traced units' device-busy seconds (trace) over the
host seconds of the same work without the profiler (host clock; the
untraced unit of the same shape nearest in the window).  Moves
``corpus_utt_per_s``."""

from portbench.yardstick import readers


def read(cell):
    return readers.idle(cell, "corpus")
