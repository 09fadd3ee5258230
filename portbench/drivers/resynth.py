"""Entry driver ``resynth``: ``Paule.plan_resynth``, one call at a time on
one instance, closed loop with one client.

Set-up reads the release once, synthesises the cell's targets (seeded
smooth cp trajectories of the cell's length, one per target, through the
benchmark's own synthesizer) and builds ``Paule`` with the release's
arrays injected; one short call (``warmup``) at the cell's length builds
the kernels and the synthesizer and loads every library before a trace
starts, and the release's predictive weights and a fresh Adam state are
put back after it.  The window plans target after target at the cell's
budget; online learning carries over from call to call.  Each call is
given its own seed (``plan_resynth(seed=...)``), which seeds the
instance's generators, and logs its trajectories, gradients and audio
(``log_cps``, ``log_gradients``, ``log_signals``: host copies of what
planning computes anyway).  The window's first call is the one judged:
it plans with the release's weights and trains from them, so the
reference starts from the release file and from nothing the program
made.

``resynth_s`` is the window's time from the start of its first call to
the end of its last (each ending in a device synchronize) over the calls
completed.  A call starts only while the window is open.
"""

import time

import numpy as np

from .. import program
from ..run import log, sync
from ..plain import synth, tables, weights
from ..yardstick import work


def _seed(cell, *parts):
    """A positive 31-bit seed drawn from the run's seed and ``parts``."""
    rng = np.random.default_rng([cell.seed, *parts])
    return int(rng.integers(1, 2 ** 31 - 1))


def setup(cell):
    w = cell.workload
    cell.weights = weights.load()
    t = w["cp_frames"]
    cell.targets = [
        (synth.speak(tables.seeded_cp(t - 2, [cell.seed, i])),
         synth.SAMPLE_RATE) for i in range(w["n_targets"])]
    cell.paule = program.make_paule(cell.config, cell.weights[1],
                                    seed=_seed(cell, 0),
                                    device=cell.devices[0])
    cell.paule.plan_resynth(**_kwargs(cell, 0, w["warmup"]["n_outer"]))
    program.restore(cell.paule.pred_trainer, "predictive", cell.weights[0])


def _kwargs(cell, i, n_outer=None):
    w = cell.workload
    kw = dict(w["budget"], target_acoustic=cell.targets[i % len(
        cell.targets)], seed=_seed(cell, 1, i), log_cps=True,
        log_gradients=True, log_signals=True, continue_learning=True,
        verbose=False)
    if n_outer is not None:
        kw["n_outer"] = n_outer
    return kw


def window(cell, seconds, tracer):
    """-> ``{"end_to_end": {"resynth_s": ...}, "attempted", "failed"}``."""
    w = cell.workload
    b = w["budget"]
    per_call = work.resynth_call(
        w["cp_frames"], n_outer=b["n_outer"], n_inner=b["n_inner"],
        n_epochs=b["n_epochs"], n_batches=b["n_batches"],
        batch_size=b["batch_size"], somato=cell.somato)
    p = cell.paule
    start = time.perf_counter()
    end = start
    i = 0
    while time.perf_counter() - start < seconds:
        tap = None
        if i == 0:
            tap = program.TrainTap(p.pred_trainer, "predictive", 0,
                                   w["check"]["train_steps"])
        kw = _kwargs(cell, i)
        with tracer.iteration(i) as traced:
            t0 = time.perf_counter()
            result = p.plan_resynth(**kw)
            sync(cell.devices)
            end = time.perf_counter()
        log(f"call {i} {end - t0:.3f} s " + " ".join(
            f"{k} {v:.3f}" for k, v in p.last_planning_timings.items()))
        # the profiler's stop is no part of the window
        start += tracer.stop_s if traced else 0.0
        if tap is not None:
            tap.close()
            cell.sampled = (i, kw, result, tap)
        cell.units.append({
            "work": per_call, "traced": bool(traced), "wall": end - t0,
            "key": w["cp_frames"],
            "timings": dict(p.last_planning_timings),
            "inner_steps": b["n_outer"] * b["n_inner"],
            "adam_steps": b["n_outer"] * b["n_epochs"] * b["n_batches"],
            "snapshots": b["n_outer"] * (b["n_inner"] // b["log_ii"])})
        i += 1
    cell.window_s = end - start
    return {"end_to_end": {"resynth_s": (end - start) / i},
            "attempted": i, "failed": 0}


def gather(cell):
    """The first call's ``outputs`` and ``inputs`` for the judge: its
    target mel and start; its first ``plan_steps`` planning steps'
    trajectories, losses and gradients, where the reference works each
    loss, gradient and update out again (its predictive model is the
    release's); every planning step's trajectory and gradient, for Adam's
    arithmetic over the program's own gradients; the first outer
    iteration's snapshots, their audio, losses and tubes; the first
    continue-learning steps, from the release's weights."""
    w = cell.workload
    _i, kw, r, tap = cell.sampled
    n = w["budget"]["n_inner"]
    k = w["check"]["plan_steps"]
    cps = np.stack([np.asarray(c) for outer in r.cp_steps for c in outer]
                   + [np.asarray(r.planned_cp)])[:, None]
    snaps = cps[:n, 0]
    grads = np.stack(r.grad_steps)
    outputs = {
        "target_mels": np.asarray(r.target_mel)[None],
        "init_cps": np.asarray(r.initial_cp)[None],
        "plan_cps": cps[:k + 1], "plan_updates": np.diff(cps[:k + 1],
                                                          axis=0),
        "plan_losses": np.asarray(r.planned_loss_steps)[:k, None],
        "plan_grads": grads[:k],
        "adam_cps": cps, "adam_grads": grads,
        "adam_updates": np.diff(cps, axis=0),
        "snap_cps": snaps, "snap_owner": np.zeros(n, dtype=int),
        "snap_audio": np.stack(r.sig_steps[:n]),
        "prod_loss": np.asarray(r.prod_loss_steps[:n]),
        "prod_semvec_loss": np.asarray(r.prod_semvec_loss_steps[:n]),
        "train": tap.gathered(snaps)}
    if cell.somato:
        outputs["snap_tubes"] = np.asarray(r.prod_tube_steps[0])
    inputs = {"target_sigs": [kw["target_acoustic"][0]],
              "checked": list(range(k)), "mask_seed": kw["seed"]}
    return outputs, inputs


def close(cell):
    cell.paule.close()
    del cell.paule, cell.sampled
