"""B2, the single-layer LSTM backward, at the shapes of its two layouts on
the card: microseconds per time step beside its float32 bound, the error
against its plain version, whether two launches agree bit for bit, and the
layout each launch took (``lstm_bwd.tiled``: the tiled layout from B=8 on,
the owner layout below).

With ``--against PATH``, another copy of the kernel source (for example an
earlier commit's ``paule_tpu_torch/csrc/lstm.cu``) is built beside this
one, and its ``paule_lstm_bwd`` (the owner layout) runs at the same shapes
with the owner layout's plan; the two are timed in turn (other, this,
this, other) on the same inputs, so that one card compares them.

    python -m paule_tpu_torch.tools.bwd_layouts [--against PATH] [--out FILE]

``chip_smoke.py`` runs :func:`measure` at :data:`SMOKE_SHAPES`.  Exits 1
without a card, or where an error exceeds :data:`REL_TOL` or two launches
differ.
"""

import argparse
import json
import os
import sys

import torch

from ..ops import lstm_kernels as K
from ..ops.cuda_build import BUILD_DIR, CudaLibrary
from . import timing

#: B2 against its plain version in float32, as the relative Frobenius error
#: of dgates, dh0 and dc0: both layouts read 1.7-2.6e-7 at these shapes on
#: an H100, and a product that lost precision (TF32, half-precision sums)
#: would read ~5e-4
REL_TOL = 1e-5
#: (T, B, H): the paths' B2 shapes (planning at B=1, training batches of 8,
#: the somatosensory planning batches of 16 at H=720 and H=360, a dp=2 or
#: dp=4 shard's rows, the tube models' batches of 24, the zoo's H=200)
SHAPES = ((402, 1, 720), (201, 1, 720), (402, 1, 360), (201, 2, 720),
          (402, 4, 720), (402, 8, 720), (201, 8, 720), (200, 16, 720),
          (160, 16, 720), (402, 8, 360), (200, 16, 360), (160, 16, 360),
          (402, 24, 360), (200, 16, 200))
#: the shapes chip_smoke.py holds B2 at: both layouts at H=720 and H=360
SMOKE_SHAPES = ((200, 16, 720), (402, 8, 720), (200, 16, 360),
                (402, 8, 360), (402, 4, 720), (201, 2, 720), (402, 1, 720))
REPS = 20


def inputs(seq, batch, hidden, dev, seed=0):
    """acts (activated gates), cs_prev, ghs and W_hh of B2, drawn on the
    CPU from ``seed`` and moved to ``dev``."""
    gen = torch.Generator().manual_seed(seed)
    f32 = dict(generator=gen, dtype=torch.float32)
    acts = K.activate(torch.randn((seq, batch, 4 * hidden), **f32), hidden)
    cs_prev = torch.randn((seq, batch, hidden), **f32) * 0.5
    ghs = torch.randn((seq, batch, hidden), **f32)
    w_hh = (torch.rand((hidden, 4 * hidden), **f32) * 2 - 1) * hidden ** -0.5
    return tuple(t.to(dev).contiguous() for t in (acts, cs_prev, ghs, w_hh))


def other_library(path):
    """The ``paule_lstm_bwd`` of the kernel source at ``path``, built into
    its own file beside this package's libraries."""
    lib = CudaLibrary(os.path.abspath(path), {"paule_lstm_bwd": (7, 9)})
    lib.lib_path = os.path.join(BUILD_DIR, "liblstm_against.so")
    return lib


def other_bwd(lib, acts, cs_prev, ghs, w_hh):
    """B2 by ``lib`` (:func:`other_library`) with the owner layout's plan."""
    seq, batch, four_h = acts.shape
    hidden = four_h // 4
    dev = acts.device
    plan = K._one_layer_plan("B2", hidden, batch,
                             *K.device_limits(dev.index), 4 * hidden,
                             K.IN_FLOATS, 4 * hidden)
    outs = (torch.empty_like(acts),
            torch.empty((batch, hidden), device=dev),
            torch.empty((batch, hidden), device=dev))
    lib.launch("paule_lstm_bwd", dev, (acts, cs_prev, ghs, w_hh, *outs),
               (seq, batch, hidden, *plan))
    return outs


def _rel(outs, want):
    return max(float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
               for a, b in zip(outs, want))


def measure(seq, batch, hidden, dev, against=None, reps=REPS):
    """B2 at (T, B, H) on ``dev``: a dict of the shape, the layout taken,
    the plan, ``rel_err`` against the plain version, ``same`` (two
    launches bit-identical), ``us_per_step`` and ``bound_us_per_step``;
    with ``against`` (:func:`other_library`) also its ``against_rel_err``
    and ``against_us_per_step``, timed in turn with this library's."""
    args = inputs(seq, batch, hidden, dev, seed=seq * 1000 + batch * 10
                  + hidden)
    before = K.lstm_bwd.tiled
    outs = K.lstm_bwd(*args)
    tiled = K.lstm_bwd.tiled - before
    same = all(torch.equal(a, b) for a, b in zip(outs, K.lstm_bwd(*args)))
    want = K.lstm_bwd_plain(*args)
    row = {"shape": [seq, batch, hidden],
           "layout": "tiled" if tiled else "owner",
           "plan": list(K.bwd_plan(hidden, batch, *K.device_limits(
               args[0].device.index))),
           "rel_err": _rel(outs, want), "same": same,
           "bound_us_per_step": timing.lstm_bwd_bound(seq, batch, hidden)[0]
           * 1e3 / seq}

    def this():
        return K.lstm_bwd(*args)

    if against is None:
        row["us_per_step"] = timing.cuda_ms(this, reps) * 1e3 / seq
        return row

    def other():
        return other_bwd(against, *args)

    row["against_rel_err"] = _rel(other(), want)
    ms = [timing.cuda_ms(f, reps) for f in (other, this, this, other)]
    row["us_per_step"] = (ms[1] + ms[2]) / 2 * 1e3 / seq
    row["against_us_per_step"] = (ms[0] + ms[3]) / 2 * 1e3 / seq
    row["ms"] = ms
    return row


def row_ok(row):
    return (row["rel_err"] <= REL_TOL and row["same"]
            and row.get("against_rel_err", 0.0) <= REL_TOL)


def line(row):
    seq, batch, hidden = row["shape"]
    text = (f"B2 T={seq} B={batch} H={hidden}: {row['layout']} layout; "
            f"dgates/dh0/dc0 rel err {row['rel_err']:.3e} (tol {REL_TOL}); "
            f"two launches bit-identical: {row['same']}; "
            f"{row['us_per_step']:.3f} us per step (bound "
            f"{row['bound_us_per_step']:.3f})")
    if "against_us_per_step" in row:
        text += (f"; against {row['against_us_per_step']:.3f} us per step "
                 f"(rel err {row['against_rel_err']:.3e})")
    return text


def main(argv=None):
    ap = argparse.ArgumentParser(description="B2's layouts on the card")
    ap.add_argument("--against", help="another lstm.cu whose owner-layout "
                    "B2 is timed beside this one")
    ap.add_argument("--out", help="write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_layouts: no CUDA device", file=sys.stderr)
        return 1
    dev = timing.open_device("cuda")
    card = timing.card_line()
    print(card)
    against = other_library(args.against) if args.against else None
    rows = []
    for shape in SHAPES:
        rows.append(measure(*shape, dev, against=against))
        print(line(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "rows": rows}, fh, indent=1)
    ok = all(row_ok(r) for r in rows)
    print(json.dumps({"ok": ok, "card": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
