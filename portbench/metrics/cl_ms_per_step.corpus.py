"""Continue-learning (``batched.train_shared``): ms of the
``plan_batch_resynth.continue_learning`` span per Adam step.  Moves
``corpus_utt_per_s``."""

from portbench.yardstick import readers


def read(cell):
    return readers.phase_ms_per(cell, "corpus", "continue_learning",
                                "adam_steps")
