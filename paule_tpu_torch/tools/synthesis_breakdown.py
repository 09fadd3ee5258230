"""Where the synthesis phase's time goes, per snapshot, and three host
synthesis strategies against each other, on the card (the port's
counterpart of ``tools/synthesis_breakdown.py``).

* ``standalone_cpp``: the C++ synthesizer alone,
  ``SynthPool(size=1).speak_batch`` of one outer iteration's snapshots
  (``n_inner`` copies of the seeded 402-frame trajectory), best of
  ``reps``: the floor per snapshot;
* ``per_snapshot``: ``Paule(seed=1, plan_overlap=False)`` with its batch
  entry hidden (``_NoBatchPlant``), so that it synthesises snapshot by
  snapshot;
* ``batch``: ``Paule(seed=1, plan_overlap=False)``, one batch call per
  outer iteration;
* ``batch_overlap``: ``Paule(seed=1, plan_overlap=2)``, one batch call per
  planning chunk, run on a host thread while the next chunk plans.

Each strategy differs from the next in one thing, as the JAX tool's
docstring describes them.  The JAX tool's own calls no longer do: since
``plan_overlap=True`` became the JAX package's default, its
``per_snapshot`` and ``batch`` (``Paule(seed=1)``) overlap in two chunks
as its ``batch_overlap`` does; here the first two are built with
``plan_overlap=False``.

Each strategy is warmed with one outer iteration, then measured in
``reps`` interleaved hot rounds of ``outers_per_rep`` outer iterations;
the result gives medians, and the plant calls each strategy made (counted
by the tool's wrapper around the plant; each ``plan_resynth`` call also
synthesises its initial trajectory with one ``speak``).

Run on the card::

    python -m paule_tpu_torch.tools.synthesis_breakdown [--reps 5]
        [--out FILE]

Prints one JSON line (with the card's name and power limit); without a
card it raises.
"""

import argparse
import collections
import sys
import threading
import time

import numpy as np

from .. import synth
from ..api import Paule
from ..ops.normalize import inv_normalize_cp
from . import timing
from .hot_timing import seeded_cp, seeded_target

T_CP = 402
REPS = 5
OUTERS_PER_REP = 2


class _NoBatchPlant:
    """A plant without its batch entry, which forces synthesis snapshot by
    snapshot; counts the calls planning makes (``calls``)."""

    def __init__(self, plant):
        self._plant = plant
        self._lock = threading.Lock()
        self.calls = collections.Counter(speak=0, speak_batch=0)

    def _count(self, name):
        with self._lock:
            self.calls[name] += 1

    def speak(self, cp):
        self._count("speak")
        return self._plant.speak(cp)


class _CountingPlant(_NoBatchPlant):
    """The plant with its batch entry, counting the calls."""

    def speak_batch(self, cps):
        self._count("speak_batch")
        return self._plant.speak_batch(cps)


#: each strategy's ``plan_overlap`` and plant wrapper
STRATEGIES = {
    "per_snapshot": (False, _NoBatchPlant),
    "batch": (False, _CountingPlant),
    "batch_overlap": (2, _CountingPlant),
}


def build_strategies(make_paule):
    """-> ``{name: paule}``, each ``make_paule(plan_overlap)`` with its
    plant wrapped as :data:`STRATEGIES` says."""
    out = {}
    for name, (overlap, wrapper) in STRATEGIES.items():
        model = out[name] = make_paule(overlap)
        model.plant = wrapper(model.plant)
    return out


def cpp_floor_s(cp, n_snapshots, reps):
    """Best wall in seconds of one ``speak_batch`` of ``n_snapshots``
    copies of the denormalised trajectory ``cp[:-1]`` on a one-instance
    pool, after a warm-up call."""
    pool = synth.SynthPool(size=1)
    try:
        snaps = np.tile(inv_normalize_cp(
            np.asarray(cp[:-1], dtype=np.float64))[None],
            (n_snapshots, 1, 1))
        pool.speak_batch(snaps)
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            pool.speak_batch(snaps)
            best = min(best, time.perf_counter() - t0)
    finally:
        pool.close()
    return best


def summarize(walls, splits, floor_s, n_snapshots, reps, outers_per_rep,
              budget):
    """The JAX tool's result (``tools/synthesis_breakdown.py:116-138``,
    its rounding included) from the strategies' walls and splits per outer
    iteration and the C++ floor's best wall of ``n_snapshots``."""
    standalone_ms = floor_s / n_snapshots * 1e3
    out = {"budget": budget,
           "method": f"{reps} interleaved hot rounds x {outers_per_rep} "
                     "outers; medians",
           "standalone_cpp_ms_per_snapshot": round(standalone_ms, 2)}
    for name in walls:
        res = out[name] = timing.rounds_summary(walls[name], splits[name])
        synth_ms = (res["phase_split_s_median"]["synthesis"] / n_snapshots
                    * 1e3)
        res["synthesis_ms_per_snapshot"] = round(synth_ms, 2)
        res["overhead_vs_cpp_floor_ms"] = round(synth_ms - standalone_ms, 2)
    return out


def run(*, device="cuda", make_paule=None, reps=REPS,
        outers_per_rep=OUTERS_PER_REP, t=T_CP, n_inner=25, n_epochs=10,
        n_batches=3, batch_size=8):
    """The floor and the strategies' rounds at the budget given (default:
    the JAX tool's).  ``make_paule(plan_overlap)``: a fresh instance per
    strategy (default ``Paule(seed=1, plan_overlap=..., device=device)``),
    each closed at the end.  -> the result as a JSON-able dict."""
    device = timing.open_device(device)
    if make_paule is None:
        def make_paule(plan_overlap):
            return Paule(seed=1, plan_overlap=plan_overlap, device=device)
    budget = dict(n_inner=n_inner, n_epochs=n_epochs, n_batches=n_batches,
                  batch_size=batch_size)
    cp = seeded_cp(t)
    # one snapshot per inner step (log_ii=1)
    floor_s = cpp_floor_s(cp, n_inner, reps)
    print(f"[breakdown] C++ floor: {floor_s / n_inner * 1e3:.2f} "
          "ms/snapshot", file=sys.stderr, flush=True)
    kw = timing.plan_kwargs(seeded_target(t), **budget)
    strategies = {}
    try:
        strategies.update(build_strategies(make_paule))
        walls, splits = timing.interleaved_rounds(
            {name: (model, kw) for name, model in strategies.items()}, reps,
            outers_per_rep, device, "breakdown")
    finally:
        for model in strategies.values():
            model.close()
    out = summarize(walls, splits, floor_s, n_inner, reps, outers_per_rep,
                    f"{timing.budget_line(**budget)}, T={t}")
    for name, model in strategies.items():
        out[name].update(native_calls=dict(model.plant.calls),
                         plan_resynth_calls=1 + reps,
                         outers_run=1 + reps * outers_per_rep)
    out["notes"] = (
        "the synthesis phase holds the snapshots' denormalisation, the "
        "native calls, the per-snapshot finiteness checks and the "
        "stacking; the snapshots reach the host in the planning phase and "
        "the produced audio reaches the card in the metrics phase; with "
        "batch_overlap the phase shows only the part of the synthesis "
        "that the later chunk's planning did not hide; native_calls "
        "counts the plant calls over the warm-up and the rounds: in every "
        "strategy one speak per plan_resynth call synthesises the initial "
        "trajectory, the rest synthesise the snapshots of outers_run "
        "outer iterations")
    return {**out, "t_frames": t, **timing.labels(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=REPS,
                    help="interleaved rounds and floor repeats (the JAX "
                         "tool's BREAKDOWN_REPS)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    timing.emit(run(device="cuda", reps=args.reps), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
