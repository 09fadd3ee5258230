"""Device: milliseconds in which the cards ran a kernel or a copy per
utterance of the traced batch (summed over the cards): the batch's device
work, steadier than its wall, which the host's speed moves.  Moves
``corpus_utt_per_s``."""

from portbench.yardstick import readers


def read(cell):
    value = readers.device_s_per(cell, "corpus", "utterances")
    return None if value is None else 1e3 * value
