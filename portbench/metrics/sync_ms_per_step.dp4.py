"""Device, the weight sync over the cards (``mesh.sync_replicas`` after
every sharded Adam step): device ms of the ``sync_replicas`` span on the
lead card's stream in the profiled calls per Adam step of the traced
units.  Moves ``corpus_utt_per_s``."""

from portbench.yardstick import model_spans


def read(cell):
    return model_spans.device_span_ms_per(cell, "corpus", "sync_replicas",
                                          "adam_steps")
