"""Batched planning's cost per inner step against the batch size, on the
card (the port's counterpart of ``tools/batch_scaling.py``).

For B in {1, 2, 4, 8, 16, 32} at the bench shape (402 cp frames, H=720,
``acoustic_semvec``, semantics logged), the per-inner-step wall is the
slope of wall(n_steps) over n_steps in {5, 25, 50}
(:func:`paule_tpu_torch.tools.roofline.measure_planning_step`: B=1
through ``planning.engine.plan_segment``, B > 1 through
``parallel.batched.plan_segment_batched``), and the throughput is B over
it, in utterance-steps per second.  The knee of the curve is the batch
size for corpus planning on one card.  At B=32 the LSTM kernels run their
rows in several passes (``ops/lstm_kernels.py`` ``_chunk_and_rows``).

Run on the card::

    python -m paule_tpu_torch.tools.batch_scaling [--out FILE]

Prints one JSON line (with the card's name and power limit); without a
card it raises.
"""

import argparse
import sys

from . import timing
from .roofline import (HIDDEN, STEP_COUNTS, STEP_REPS, T_CP,
                       measure_planning_step)

BATCHES = (1, 2, 4, 8, 16, 32)


def run(*, device="cuda", batches=BATCHES, hidden=HIDDEN, t_cp=T_CP,
        step_counts=STEP_COUNTS, reps=STEP_REPS):
    """ms per inner step and utterance-steps per second at each batch
    size.  -> the result as a JSON-able dict."""
    device = timing.open_device(device)
    rows = {}
    base = None
    for b in batches:
        slope, walls = measure_planning_step(
            b, device=device, hidden=hidden, t_cp=t_cp,
            step_counts=step_counts, reps=reps)
        if base is None:
            base = slope
        rows[f"B{b}"] = {
            "per_inner_step_ms": slope * 1e3,
            "wall_vs_B1": slope / base,
            "utterance_steps_per_s": b / slope,
            "throughput_vs_B1": (b / slope) / (1 / base),
            "walls_ms": {str(n): w * 1e3 for n, w in walls.items()},
        }
        print(f"B={b}: {slope * 1e3:.2f} ms/step, {b / slope:.0f} "
              f"utt-steps/s ({(b / slope) / (1 / base):.1f}x B=1)",
              file=sys.stderr, flush=True)
    return {
        "backend": device.type, **timing.labels(device),
        "shape": (f"T={t_cp} cp frames, H={hidden}, acoustic_semvec, "
                  "log_ii=1"),
        "method": (f"per-inner-step wall = slope of hot wall(n_steps) over "
                   f"n_steps in {list(step_counts)} (least of {reps} host "
                   "walls, each ending in a synchronize); B=1 runs "
                   "engine.plan_segment, B>1 "
                   "parallel.batched.plan_segment_batched"),
        "batches": rows,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    timing.emit(run(device="cuda"), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
