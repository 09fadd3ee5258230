"""Continue-learning of the tube models (``batched.train_shared`` for the
cp->tube and tube->mel models): ms of ``continue_learning_tube`` per tube
model's Adam step, over the units that ran without the profiler.  Moves
``corpus_utt_per_s``."""

from portbench.yardstick import model_spans


def read(cell):
    return model_spans.tube_cl_ms_per_step(cell, "corpus_soma")
