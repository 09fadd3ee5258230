"""Hot full-budget timing of ``plan_resynth`` with its phase split, on the
card (the port's counterpart of ``tools/hot_timing.py``).

Runs the reference's full default budget (10 outer x 25 inner,
``log_ii=1``, continue-learning 10 epochs x 3 batches of 8) on a seeded
402-frame synthesised target with ``Paule(seed=7)`` twice: the first call
pays every set-up (the kernels' build, cuBLAS, the synthesizer pool), the
second is the hot number.  Reports the hot wall (host clock ending in
``torch.cuda.synchronize()``), ``Paule.last_planning_timings`` and the
final produced loss.

Run on the card::

    python -m paule_tpu_torch.tools.hot_timing [--n-outer 10] [--t 402]
        [--out FILE]

Prints one JSON line (with the card's name and power limit); without a
card it raises.
"""

import argparse
import sys

import numpy as np

from .. import synth
from ..api import Paule
from ..ops.normalize import inv_normalize_cp
from . import timing


def seeded_cp(n_frames, seed=0):
    """A seeded smooth normalised cp trajectory of ``n_frames + 1`` frames
    (``tools/hot_timing.py:36-38``)."""
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(0, 0.05, (n_frames + 1, 30)).cumsum(0) * 0.2,
                   -1, 1)


def seeded_target(n_frames, seed=0):
    """``(sig, sr)`` synthesised from :func:`seeded_cp`
    (``tools/hot_timing.py:36-39``)."""
    return synth.speak(inv_normalize_cp(seeded_cp(n_frames, seed)))


def run(*, device="cuda", paule=None, n_outer=10, t=402, n_inner=25,
        n_epochs=10, n_batches=3, batch_size=8):
    """A cold and a hot ``plan_resynth`` at the budget given (default: the
    reference's).  ``paule``: the instance to plan with (default
    ``Paule(seed=7)`` on ``device``, closed afterwards).  -> the result as
    a JSON-able dict."""
    device = timing.open_device(device)
    kw = dict(target_acoustic=seeded_target(t), objective="acoustic_semvec",
              initialize_from="acoustic", n_outer=n_outer, n_inner=n_inner,
              log_ii=1, continue_learning=True, n_epochs=n_epochs,
              n_batches=n_batches, batch_size=batch_size, verbose=False)
    model = paule if paule is not None else Paule(seed=7, device=device)
    try:
        cold, _r = timing.wall_s(lambda: model.plan_resynth(**kw), device)
        wall, r = timing.wall_s(lambda: model.plan_resynth(**kw), device)
        timings = dict(model.last_planning_timings)
    finally:
        if paule is None:
            model.close()
    return {"hot_wall_s": wall, "cold_wall_s": cold, "timings": timings,
            "final_prod_loss": float(r.prod_loss_steps[-1]),
            "n_outer": n_outer, "t_frames": t, **timing.labels(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-outer", type=int, default=10)
    ap.add_argument("--t", type=int, default=402,
                    help="cp frames of the synthetic target (402 ~ 1 s)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    timing.emit(run(device="cuda", n_outer=args.n_outer, t=args.t),
                args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
