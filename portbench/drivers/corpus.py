"""Entry driver ``corpus``: ``experiments.plan_corpus_batched``, what
``python -m paule_tpu_torch corpus --batched <max_batch>`` runs, over one
seeded corpus again and again, closed loop with one client; with ``dp``
above 1, over a ``Mesh(dp, tp=1)`` of the cell's cards.

Set-up reads the release once, synthesises the corpus (seeded smooth cp
trajectories, ``words_per_length`` at each of ``lengths`` cp frames, in
the order ``lengths[i % len(lengths)]``) through the benchmark's own
synthesizer, builds ``Paule`` with the release's arrays injected, and
plans the corpus once with ``warmup["n_outer"]`` outer iterations, which
builds every shape the window uses, and puts the release's predictive
weights and a fresh Adam state back after it.  Every bucket fills whole
batches of ``max_batch``.

``corpus_utt_per_s`` is the utterances of the batches completed over the
time from the window's start to the last completion (each batch ending
in a device synchronize).  A corpus pass starts only while the window is
open.

Each batch is one ``parallel.batched.plan_batch_resynth`` call; the
driver wraps that function for the window to time (and, with
``--trace 1``, profile the first ``trace_iterations``) batches.  The
window's first batch is the one judged: it plans with the release's
weights and trains from them, so the reference starts from the release
file and from nothing the program made.  For it the driver copies the
inputs, the first training steps, and, through wraps of
``parallel.batched.plan_shards`` and ``Paule._synthesize``, the first
outer iteration's trajectories before each step and its synthesised
trajectories and audio (which the batched planner computes and drops).
"""

import time

import numpy as np

from .. import program
from ..run import log, sync
from ..plain import synth, tables, weights
from ..yardstick import work


def setup(cell):
    from paule_tpu_torch import experiments
    from paule_tpu_torch.parallel.mesh import make_mesh

    w = cell.workload
    cell.weights = weights.load()
    cps = tables.corpus_cps(w["words_per_length"] * len(w["lengths"]),
                            w["lengths"], seed=[cell.seed, 3])
    cell.targets = [(synth.speak(c), synth.SAMPLE_RATE) for c in cps]
    cell.batches = _batches([len(c) for c in cps], w["max_batch"])
    cell.paule = program.make_paule(
        cell.config, cell.weights[1],
        seed=int(np.random.default_rng([cell.seed, 0]).integers(1, 2 ** 31)),
        device=cell.devices[0])
    cell.mesh = (make_mesh(devices=cell.devices, dp=w["dp"], tp=1)
                 if w["dp"] > 1 else None)
    experiments.plan_corpus_batched(
        cell.paule, cell.targets, mesh=cell.mesh, max_batch=w["max_batch"],
        plan_kwargs=dict(w["budget"], n_outer=w["warmup"]["n_outer"]),
        verbose=False)
    program.restore(cell.paule.pred_trainer, "predictive", cell.weights[0])


def _batches(frames, max_batch):
    """The utterances of each batch, in the order ``plan_corpus_batched``
    plans them: buckets of one length in ascending length, each cut into
    batches of ``max_batch``."""
    out = []
    for length in sorted(set(frames)):
        idx = [i for i, f in enumerate(frames) if f == length]
        out += [idx[s:s + max_batch] for s in range(0, len(idx), max_batch)]
    return out


def window(cell, seconds, tracer):
    """-> ``{"end_to_end": {"corpus_utt_per_s": ...}, "attempted",
    "failed"}``."""
    from paule_tpu_torch import experiments
    from paule_tpu_torch.parallel import batched

    w = cell.workload
    b = w["budget"]
    p = cell.paule
    plan_batch = batched.plan_batch_resynth
    plan_shards = batched.plan_shards
    state = {"batch": 0, "t": 0.0, "start": 0.0}

    def timed_batch(paule_obj, target_mels, target_semvecs=None, **kw):
        j = state["batch"]
        state["batch"] += 1
        tap = None
        if j == 0:
            tap = program.TrainTap(p.pred_trainer, "predictive", 0,
                                   w["check"]["train_steps"])
            kept, synthesised = [], []

            def shards_kept(*a, **k):
                logs = plan_shards(*a, **k)
                kept.append(logs["xx_pre"])
                return logs

            def synthesis_kept(cps, *a, **k):
                out = synthesize(cps, *a, **k)
                synthesised.append((np.array(cps), out[0]))
                return out

            batched.plan_shards = shards_kept
            synthesize = p._synthesize
            p._synthesize = synthesis_kept
        try:
            with tracer.iteration(j) as traced:
                out = plan_batch(paule_obj, target_mels, target_semvecs,
                                 **kw)
                sync(cell.devices)
                done = time.perf_counter()
        finally:
            if tap is not None:
                tap.close()
                batched.plan_shards = plan_shards
                del p._synthesize
        if tap is not None:
            cell.sampled = {"batch": j, "tap": tap,
                            "target_mels": np.asarray(target_mels),
                            "out": out, "xx_pre": kept[0],
                            "snaps": synthesised[0]}
        batch = len(target_mels)
        log(f"batch {j} of {batch} {done - state['t']:.3f} s")
        cell.units.append({
            "work": work.corpus_batch(
                2 * np.asarray(target_mels).shape[1], batch,
                n_outer=b["n_outer"], n_inner=b["n_inner"],
                n_epochs=b["n_epochs"], batch_size=b["batch_size"],
                dp=w["dp"] if batch % w["dp"] == 0 else 1),
            "traced": bool(traced), "wall": done - state["t"],
            "key": np.asarray(target_mels).shape[1],
            "timings": dict(p.last_planning_timings),
            "inner_steps": b["n_outer"] * b["n_inner"],
            "adam_steps": b["n_outer"] * b["n_epochs"] * -(
                -batch // b["batch_size"]),
            "utterances": batch, "done": done})
        # the profiler's stop is no part of the window
        state["start"] += tracer.stop_s if traced else 0.0
        state["t"] = time.perf_counter() if traced else done
        return out

    state["start"] = time.perf_counter()
    batched.plan_batch_resynth = timed_batch
    try:
        while time.perf_counter() - state["start"] < seconds:
            state["t"] = time.perf_counter()
            experiments.plan_corpus_batched(
                p, cell.targets, mesh=cell.mesh, max_batch=w["max_batch"],
                plan_kwargs=w["budget"], verbose=False)
    finally:
        batched.plan_batch_resynth = plan_batch
    start = state["start"]
    end = cell.units[-1]["done"]
    cell.window_s = end - start
    done = sum(u["utterances"] for u in cell.units)
    return {"end_to_end": {"corpus_utt_per_s": done / (end - start)},
            "attempted": done, "failed": 0}


def gather(cell):
    """The first batch's ``outputs`` and ``inputs`` for the judge: its
    target mels and starts; the trajectories and losses of its first
    ``plan_steps`` planning steps, where the reference works each loss,
    gradient and update out again; the first outer iteration's
    trajectories, their audio and produced-audio losses; the first steps
    of the first continue-learning round, from the release's weights."""
    s = cell.sampled
    out = s["out"]
    k = cell.workload["check"]["plan_steps"]
    plan_cps = s["xx_pre"][:k + 1].double().cpu().numpy()
    if len(plan_cps) != k + 1:
        raise ValueError("plan_steps must be less than n_inner")
    cps, audio = s["snaps"]
    outputs = {
        "target_mels": s["target_mels"], "init_cps": plan_cps[0],
        "plan_cps": plan_cps, "plan_updates": np.diff(plan_cps, axis=0),
        "plan_losses": np.asarray(out["sub_losses"][0].total[:k]),
        "plan_grads": None,
        "snap_cps": cps, "snap_owner": np.arange(len(cps)),
        "snap_audio": np.stack(audio),
        "prod_loss": np.asarray(out["prod_loss_curve"][0]),
        "prod_semvec_loss": np.asarray(out["prod_semvec_loss_curve"][0]),
        "train": s["tap"].gathered(cps)}
    inputs = {"target_sigs": [cell.targets[i][0]
                              for i in cell.batches[s["batch"]]],
              "checked": list(range(k))}
    return outputs, inputs


def close(cell):
    cell.paule.close()
    del cell.paule, cell.sampled
