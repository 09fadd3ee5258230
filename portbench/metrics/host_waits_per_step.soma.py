"""Device, the somatosensory model set: the points where the calling
thread blocked on the device, counted in the profiled calls' records, per
inner planning step of the traced units.  Moves ``corpus_utt_per_s``."""

from portbench.yardstick import model_spans


def read(cell):
    return model_spans.host_waits_per_step(cell, "corpus_soma")
