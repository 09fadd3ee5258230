"""The release weights' corpus quality and the corpus wall against
``max_batch``, on the card (the port's counterpart of
``tools/release_quality_run.py``).

Plans the evaluation corpus of
:mod:`paule_tpu_torch.tools.corpus_quality_run` (the same seed, 64
utterances by default) with ``experiments.plan_corpus_batched``:

* with the in-repo release weights (``Paule(seed=2)``, fresh for each
  row) at ``max_batch`` in {8, 16, 32}: the corpus wall says which batch
  size corpus planning should use;
* with the seeded random initialisation (``pretrained_dir="random"``) at
  the ``max_batch`` whose corpus wall was shortest: the from-nothing row.

Reports per row the corpus wall (host clock ending in a synchronize) and
the final produced-loss median, p10 and p90.

Settings, as the JAX tool reads them from the environment: ``CORPUS_N``
(64), ``CORPUS_OUTER`` (10), ``CORPUS_INNER`` (25),
``CORPUS_MAX_BATCHES`` ("8,16,32").

Run on the card::

    python -m paule_tpu_torch.tools.release_quality_run [--out FILE]

Prints one JSON line (with the card's name and power limit); without a
card, or without the release file, it raises.
"""

import argparse
import os
import sys
import time

import numpy as np

from .. import release, synth
from ..api import Paule
from ..experiments import plan_corpus_batched
from ..ops.normalize import inv_normalize_cp
from . import timing
from .corpus_quality_run import LENGTHS, corpus_cps, log


def settings(env=os.environ):
    """The JAX tool's environment settings (``tools/release_quality_run.py:
    38-42``) as :func:`run`'s keywords."""
    return {"n_utt": int(env.get("CORPUS_N", "64")),
            "n_outer": int(env.get("CORPUS_OUTER", "10")),
            "n_inner": int(env.get("CORPUS_INNER", "25")),
            "max_batches": tuple(int(x) for x in env.get(
                "CORPUS_MAX_BATCHES", "8,16,32").split(","))}


def run(*, device="cuda", make_paule=None, n_utt=64, n_outer=10, n_inner=25,
        max_batches=(8, 16, 32)):
    """The rows above.  ``make_paule(pretrained_dir)``: a fresh instance
    for each row, ``None`` for the release and ``"random"`` (default:
    ``Paule(seed=2, pretrained_dir=..., device=device)``); each is closed
    after its row.  -> the result as a JSON-able dict."""
    device = timing.open_device(device)
    if not release.release_available():
        raise FileNotFoundError(f"no release file at {release.RELEASE_PATH}")
    if make_paule is None:
        def make_paule(pretrained_dir):
            return Paule(seed=2, pretrained_dir=pretrained_dir,
                         device=device)
    t_start = time.perf_counter()
    pool = synth.SynthPool(size=4)
    try:
        cps, _rng = corpus_cps(n_utt)
        targets = [pool.speak(inv_normalize_cp(cp)) for cp in cps]
    finally:
        pool.close()
    log(f"corpus ready: {n_utt} utterances, lengths {LENGTHS}")
    plan_kwargs = dict(objective="acoustic", n_outer=n_outer,
                       n_inner=n_inner, continue_learning=True,
                       batch_size=8, n_epochs=5)

    def plan_row(name, pretrained_dir, mb):
        model = make_paule(pretrained_dir)
        try:
            wall, results = timing.wall_s(
                lambda: plan_corpus_batched(model, targets, max_batch=mb,
                                            plan_kwargs=plan_kwargs,
                                            verbose=False), device)
        finally:
            model.close()
        final = np.array([float(r["prod_loss_curve"][-1]) for r in results])
        log(f"{name}: wall {wall:.1f} s, median final loss "
            f"{np.median(final):.3f}")
        return {"weights": "random" if pretrained_dir else "release",
                "max_batch": mb, "corpus_wall_s": wall,
                "utt_per_s": n_utt / wall,
                "median_final_prod_loss": float(np.median(final)),
                "p10": float(np.percentile(final, 10)),
                "p90": float(np.percentile(final, 90)),
                "final_prod_loss": final.tolist()}

    rows = {f"release_mb{mb}": plan_row(f"release max_batch={mb}", None, mb)
            for mb in max_batches}
    best_mb = min(max_batches,
                  key=lambda mb: rows[f"release_mb{mb}"]["corpus_wall_s"])
    rows["random_init"] = plan_row("random init", "random", best_mb)
    meta = release.load_release_metadata()
    return {
        "n_utterances": n_utt,
        "budget": plan_kwargs,
        "release_version": meta["version"],
        "release_sha256": release.sha256(release.RELEASE_PATH),
        "rows": rows,
        "winning_max_batch_by_corpus_wall": best_mb,
        "total_wall_s": time.perf_counter() - t_start,
        **timing.labels(device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    timing.emit(run(device="cuda", **settings()), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
