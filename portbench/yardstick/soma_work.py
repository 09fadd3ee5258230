"""The LSTM work of PAULE's somatosensory model set in a planned batch,
counted from the traffic with the per-model passes of :mod:`.work`.

Each inner step runs the criterion with the tube models: the cp->tube and
tube->mel models and the tube embedder, whose dropout runs its two layers
one by one, forward and backward.  Each outer iteration's produced-audio
metrics run the embedder on the produced mels, the cp->tube model on the
plans, the tube->mel model on the produced and on the predicted tubes,
and the tube embedder (no dropout: a pair) on the produced tubes; its
continue-learning trains the predictive model and, with
``continue_learning_tube``, the cp->tube and tube->mel models on the same
batches.
"""

from .work import _criterion, _dir


def corpus_batch(t, batch, *, n_outer, n_inner, n_epochs, batch_size,
                 continue_learning_tube=True, dp=1):
    """One batch of ``batch`` utterances of ``t`` frames through
    ``plan_batch_resynth`` under the somatosensory variant, split into
    ``dp`` shards for planning and for each training step that ``dp``
    divides."""
    f = t // 2
    shard = batch // dp
    plan = dp * (_dir("embedder", f, shard) + _dir("inverse", f, shard))
    outer = dp * n_inner * _criterion(t, shard, True, True)
    outer += (_dir("embedder", f, batch) + _dir("cp_tube", t, batch)
              + 2 * _dir("tube_mel", t, batch)
              + _dir("tube_embedder", t, batch))
    trained = ["predictive"] + (["cp_tube", "tube_mel"]
                                if continue_learning_tube else [])
    for start in range(0, batch, batch_size):
        b = min(batch_size, batch - start)
        split = dp if b % dp == 0 else 1
        for model in trained:
            outer += n_epochs * split * _dir(model, t, b // split, True)
    return plan + n_outer * outer
