"""Wall-clock of the model variants against the plain ``acoustic_semvec``
path, on the card (the port's counterpart of ``tools/bench_variants.py``).

The somatosensory variant adds three tube models to the criterion (cp ->
tube and tube -> mel at H=360, the tube embedder at H=720) and tube
extraction to the synthesis; the speech-classifier variant adds the
classifier to the criterion and the produced metrics.  Their cost is
measured against the same budget without them.

The three variants (``Paule(seed=1, ...)``) are warmed with one outer
iteration each, then measured in ``reps`` interleaved rounds (one hot run
of ``outers_per_rep`` outer iterations per variant and round), so that a
change in the host's speed meets every variant of a round alike.  Ratios
are taken within each round (paired); the result gives the median and
IQR over the rounds of the per-outer wall and of the ratios.  The target
is :func:`~paule_tpu_torch.tools.hot_timing.seeded_target` of 402 frames.

Run on the card::

    python -m paule_tpu_torch.tools.bench_variants [--reps 5] [--out FILE]

Prints one JSON line (with the card's name and power limit); without a
card it raises.
"""

import argparse
import sys

from ..api import Paule
from . import timing
from .hot_timing import seeded_target

T_CP = 402
REPS = 5
OUTERS_PER_REP = 2

VARIANTS = [
    ("acoustic_semvec", {}),
    ("speech_classifier", {"use_speech_classifier": True}),
    ("somatosensory", {"use_somatosensory_feedback": True}),
]


def build(paule_kwargs, target, make_paule, **budget):
    """-> ``(make_paule(**paule_kwargs), plan keywords)``
    (``tools/bench_variants.py:41-49``)."""
    return make_paule(**paule_kwargs), timing.plan_kwargs(target, **budget)


def summarize(walls, splits, reps, outers_per_rep, budget):
    """The JAX tool's result (``tools/bench_variants.py:86-116``) from
    :func:`~paule_tpu_torch.tools.timing.interleaved_rounds`' walls and
    splits, the ratios paired by round."""
    out = {"budget": budget,
           "method": f"{reps} interleaved rounds x {outers_per_rep} hot "
                     "outers per variant; paired per-round ratios; "
                     "median [IQR]"}
    for name in walls:
        out[name] = timing.rounds_summary(walls[name], splits[name])
    base = walls["acoustic_semvec"]
    for name in ("speech_classifier", "somatosensory"):
        ratios = timing.spread([w / b for w, b in zip(walls[name], base)])
        out[name].update(vs_acoustic_semvec_median=ratios["median"],
                         vs_acoustic_semvec_iqr=ratios["iqr"],
                         vs_acoustic_semvec_all=ratios["all"])
    return out


def run(*, device="cuda", make_paule=None, reps=REPS,
        outers_per_rep=OUTERS_PER_REP, t=T_CP, n_inner=25, n_epochs=10,
        n_batches=3, batch_size=8):
    """The variants' rounds at the budget given (default: the JAX tool's).
    ``make_paule(**variant keywords)``: a fresh instance per variant
    (default ``Paule(seed=1, device=device, ...)``), each closed at the
    end.  -> the result as a JSON-able dict."""
    device = timing.open_device(device)
    if make_paule is None:
        def make_paule(**kw):
            return Paule(seed=1, device=device, **kw)
    budget = dict(n_inner=n_inner, n_epochs=n_epochs, n_batches=n_batches,
                  batch_size=batch_size)
    target = seeded_target(t)
    runs = {}
    try:
        for name, kwargs in VARIANTS:
            runs[name] = build(kwargs, target, make_paule, **budget)
        walls, splits = timing.interleaved_rounds(
            runs, reps, outers_per_rep, device, "variants")
    finally:
        for model, _kw in runs.values():
            model.close()
    return {**summarize(walls, splits, reps, outers_per_rep,
                        timing.budget_line(**budget)),
            "t_frames": t, **timing.labels(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=REPS,
                    help="interleaved rounds (the JAX tool's VARIANTS_REPS)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    timing.emit(run(device="cuda", reps=args.reps), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
