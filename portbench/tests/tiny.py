"""Cells cut to a size the CPU runs in seconds, for the harness's tests:
the published widths, a few frames, one or two outer iterations."""

import copy

from portbench import run as R


def workload(name, **extra):
    """Cell ``name``'s workload, cut to test size."""
    w = copy.deepcopy(R.load_json("workloads", name))
    if w["driver"] == "resynth":
        w.update(cp_frames=24, n_targets=2)
        w["budget"].update(n_outer=2, n_inner=3, n_epochs=2, n_batches=2,
                           batch_size=2)
        w["check"].update(plan_steps=3, train_steps=2)
    else:
        w.update(lengths=[20, 24], words_per_length=4, max_batch=4)
        w["budget"].update(n_outer=2, n_inner=3, n_epochs=2, batch_size=2)
        w["check"].update(plan_steps=2, train_steps=2)
    w.update(extra)
    return w


def run(name, seed=2 ** 31 + 11, devices=("cpu",), trace=0, seconds=0.05,
        **extra):
    """One run of the cut cell on the CPU, the harness's look for a chip
    skipped.  -> (cell, window numbers, checks)."""
    cell = R.Cell(name, seed, list(devices), workload=workload(name,
                                                               **extra))
    _setup, window, _peak, outputs, inputs = R.execute(cell, seconds, trace,
                                                       0.0)
    return cell, window, R.checks_of(cell, R.judge(cell, outputs, inputs))
