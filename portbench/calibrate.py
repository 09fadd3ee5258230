"""Readings that the limits of ``correct`` are set from, on the card.

    python -m portbench.calibrate --workload <name> --seeds 1,2,3 \
        [--seconds 1] [--controls N] [--faults a,b --fault-seeds 4,5,6] \
        [--look] [--out FILE]

For each seed, in one process: the cell's set-up and a short window (its
first call or corpus pass, which holds what the check judges), then the
numbers that :mod:`portbench.judge` compares, for the program and for the
control (on the first ``--controls`` seeds, default all): the reference
put in the program's place, its matrix products in TF32 and its Adam in
bfloat16.  Then, for each of ``--faults`` (names
in :data:`portbench.faults.FAULTS`) and each of ``--fault-seeds``, the
program's numbers with that fault planted.  One JSON line per run, also
appended to ``--out``.  The benchmark's own runs never run the control
or a fault.  ``--look`` adds, for the sound runs, where the program's
gaps lie: per checked planning step and row the gradient's gap and the
reference's norm, per training step the loss's gap, per leaf the gap of
its change, and the elements whose first Adam step parts from the
reference's.
"""

import argparse
import json
import sys
import time


def look(cell, outputs, inputs):
    """Where the program's planning-gradient and training gaps lie."""
    import numpy as np

    from . import judge as J
    from .plain import plan

    ref = J.Reference(cell.weights[0], cell.somato, cell.devices[0])
    mels, semvecs = J._targets(ref, inputs)
    out = {}
    if outputs["plan_grads"] is not None:
        _l, grads = J._at_checked(ref, outputs, inputs, mels, semvecs)
        g_r = J._np(grads)
        g_p = np.asarray(outputs["plan_grads"])[inputs["checked"]]
        norm = np.sqrt((g_r ** 2).reshape(g_r.shape[:2] + (-1,)).sum(-1))
        diff = np.sqrt(((g_p - g_r) ** 2).reshape(g_r.shape[:2]
                                                  + (-1,)).sum(-1))
        out["plan_grad_norm"] = norm.tolist()
        out["plan_grad_gap"] = (diff / norm).tolist()
    train = outputs["train"]
    prod_mels = ref.run(ref.mel, outputs["snap_audio"])
    cps = [np.asarray(outputs["snap_cps"])[rows] for rows in train["rows"]]
    ys = [prod_mels[list(rows)] for rows in train["rows"]]
    losses, first, change = J._training(train)
    r_losses, r_first, r_change = ref.train(cps, ys)
    out["train_loss_steps"] = [abs(a - b) / abs(b)
                               for a, b in zip(losses, r_losses)]
    out["train_change_leaves"] = J._leaf_gaps(change, r_change)
    out["train_grad_leaves"] = J._leaf_gaps(first, r_first)
    lr = 0.001
    w0, _ = train["state"]
    w1, _ = train["after_first"]
    steps = {}
    for k, g in r_first.items():
        d_p = J._np(w1[k]) - J._np(w0[k])
        d_r = -lr * g / (np.abs(g) + plan.EPS)
        gap = np.abs(d_p - d_r) / lr
        i = int(np.argmax(gap))
        steps[k] = {"max": float(gap.flat[i]),
                    "over_0.1": int((gap > 0.1).sum()),
                    "grad_there": float(np.abs(g).flat[i]),
                    "n": int(gap.size)}
    out["first_step"] = steps
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--controls", type=int)
    ap.add_argument("--look", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from . import faults
    from . import run as R

    entry = next(w for w in R.benchmark()["workloads"]
                 if w["name"] == args.workload)
    if torch.cuda.device_count() < entry["chips"]:
        print("portbench.calibrate: not enough CUDA devices",
              file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(entry["chips"])]
    runs = [(None, int(s)) for s in args.seeds.split(",") if s]
    runs += [(f, int(s)) for f in args.faults.split(",") if f
             for s in args.fault_seeds.split(",") if s]
    controls = len(runs) if args.controls is None else args.controls
    for i, (fault, seed) in enumerate(runs):
        patch = faults.Patch()
        if fault:
            faults.FAULTS[fault](patch)
        t0 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, "fault": fault}
        try:
            cell = R.Cell(args.workload, seed, devices)
            _setup, window, _peak, outputs, inputs = R.execute(
                cell, args.seconds, 0, t0)
            line["attempted"] = window["attempted"]
            line["program"] = R.judge(cell, outputs, inputs)
        except Exception as exc:  # a fault may crash the run: no number
            line["error"] = repr(exc)
            outputs = None
        finally:
            patch.undo()
        if outputs is not None and not fault and i < controls:
            line["control"] = R.judge(cell, outputs, inputs, control=True)
            if args.look:
                line["look"] = look(cell, outputs, inputs)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
        cell = outputs = inputs = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
