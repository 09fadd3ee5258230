"""Device: the points where the calling thread blocked on the device
(device-to-host copies, synchronous host-to-device copies, event and
device synchronizes), counted in the profiled calls' records, per inner
planning step of the traced units.  Moves ``corpus_utt_per_s``."""

from portbench.yardstick import spans


def read(cell):
    return spans.host_waits_per_step(cell, "corpus")
