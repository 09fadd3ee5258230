"""The LSTM work that a cell's traffic needs, counted from the traffic
itself: per ``plan_resynth`` call or per planned batch, every recurrence
pass of PAULE's models at its (T, B, H), whatever implements it.

A pass is single (one layer: the kernels B1 forward, B2 backward) or a
pair (two stacked layers of one width without dropout between them: B3,
B4).  Planning differentiates the trajectory, so each inner step runs
every model of the criterion forward and backward; continue-learning's
Adam steps run the predictive model forward and backward; initialisation,
the produced-audio metrics and the final results run forwards.
"""

from typing import NamedTuple

from . import bounds

#: each model's recurrence and output widths, PAULE's published sizes
MODELS = {
    "predictive": dict(n_in=30, hidden=720, layers=1, out=60),
    "inverse": dict(n_in=180, hidden=720, layers=1, out=30),
    "embedder": dict(n_in=60, hidden=720, layers=2, out=300),
    "cp_tube": dict(n_in=30, hidden=360, layers=1, out=10),
    "tube_mel": dict(n_in=10, hidden=360, layers=1, out=60),
    "tube_embedder": dict(n_in=10, hidden=720, layers=2, out=300),
}


class Pass(NamedTuple):
    model: str
    steps: int
    batch: int
    backward: bool
    #: dropout between layers (the tube embedder while planning): its
    #: layers run one by one
    dropout: bool = False


def _dir(model, steps, batch, backward=False, dropout=False):
    return [Pass(model, steps, batch, False, dropout)] + (
        [Pass(model, steps, batch, True, dropout)] if backward else [])


def _criterion(t, batch, somato, backward):
    out = _dir("predictive", t, batch, backward) + _dir(
        "embedder", t // 2, batch, backward)
    if somato:
        out += (_dir("cp_tube", t, batch, backward)
                + _dir("tube_mel", t, batch, backward)
                + _dir("tube_embedder", t, batch, backward, dropout=True))
    return out


def _somato_forwards(t, batch):
    """The tube models on a trajectory and on its produced tube."""
    return (_dir("cp_tube", t, batch) + 2 * _dir("tube_mel", t, batch)
            + 2 * _dir("tube_embedder", t, batch))


def resynth_call(t, *, n_outer, n_inner, n_epochs, n_batches, batch_size,
                 somato=False):
    """One ``plan_resynth`` call on a ``t``-frame trajectory."""
    f = t // 2
    once = (_dir("embedder", f, 1) + _dir("inverse", f, 1)
            + _dir("predictive", t, 1) + 2 * _dir("embedder", f, 1))
    final = _dir("predictive", t, 1) + 2 * _dir("embedder", f, 1)
    if somato:
        once += _somato_forwards(t, 1)
        final += _somato_forwards(t, 1)
    outer = n_inner * _criterion(t, 1, somato, True) + _dir(
        "embedder", f, n_inner)
    if somato:
        outer += (_dir("cp_tube", t, n_inner) + 2 * _dir("tube_mel", t,
                                                         n_inner)
                  + _dir("tube_embedder", t, n_inner))
    outer += n_epochs * n_batches * _dir("predictive", t, batch_size, True)
    return once + n_outer * outer + final


def corpus_batch(t, batch, *, n_outer, n_inner, n_epochs, batch_size, dp=1):
    """One batch of ``batch`` utterances of ``t`` frames through
    ``plan_batch_resynth``, split into ``dp`` shards for planning and for
    each training step that ``dp`` divides."""
    f = t // 2
    shard = batch // dp
    plan = dp * (_dir("embedder", f, shard) + _dir("inverse", f, shard))
    outer = dp * n_inner * _criterion(t, shard, False, True) + _dir(
        "embedder", f, batch)
    for start in range(0, batch, batch_size):
        b = min(batch_size, batch - start)
        split = dp if b % dp == 0 else 1
        outer += n_epochs * split * _dir("predictive", t, b // split, True)
    return plan + n_outer * outer


def kernel_passes(p):
    """-> ``[(family, steps, batch, hidden, backward)]``: the kernel calls
    of pass ``p``, ``family`` ``"single"`` (B1/B2) or ``"pair"`` (B3/B4)."""
    m = MODELS[p.model]
    if m["layers"] == 2 and not p.dropout:
        return [("pair", p.steps, p.batch, m["hidden"], p.backward)]
    return [("single", p.steps, p.batch, m["hidden"], p.backward)] * (
        m["layers"])


def least_s(passes, family):
    """The least time of ``family``'s kernel calls over ``passes``."""
    total = 0.0
    for p in passes:
        for fam, steps, batch, hidden, backward in kernel_passes(p):
            if fam != family:
                continue
            if fam == "single":
                fn = bounds.lstm_bwd_bound if backward else (
                    bounds.lstm_fwd_bound)
            else:
                fn = bounds.stack2_bwd_bound if backward else (
                    bounds.stack2_fwd_bound)
            total += fn(steps, batch, hidden)
    return total


def flops(passes):
    """Model FLOPs of ``passes``: each forward's recurrences and output
    map (:func:`bounds.lstm_flops`), each backward twice its forward, as
    ``profile_device.planning_step_flops`` counts a step."""
    total = 0
    for p in passes:
        m = MODELS[p.model]
        fwd = p.batch * (bounds.lstm_flops(p.steps, m["n_in"], m["hidden"],
                                           m["layers"])
                         + (1 if m["out"] == 300 else p.steps)
                         * 2 * m["hidden"] * m["out"])
        total += 2 * fwd if p.backward else fwd
    return total
