"""Device timing and roofline bounds for the kernels, and the device
checks of the measurement tools.

Measurement helpers shared by ``chip_smoke.py``, the ceiling probes and the
tools of this package; the port itself never calls them.
``torch.nn.LSTM`` (cuDNN) appears here only as the yardstick beside a
kernel's time.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

#: published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s
#: and float32 FLOP/s outside the tensor cores (the kernels use FMA units)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
F32 = 4


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls, after one
    warm-up call (CUDA events around the whole run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_flops):
    """-> (least time in ms, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the FLOPs over the f32 rate."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lstm_fwd_bound(seq, batch, hidden):
    """B1's function: read gates_x, W_hh, h0, c0; write hs, cs."""
    return bound_ms(
        F32 * (seq * batch * 6 * hidden + 4 * hidden * hidden
               + 2 * batch * hidden),
        seq * batch * (8 * hidden * hidden + 13 * hidden))


def lstm_bwd_bound(seq, batch, hidden):
    """B2's function: read acts, cs_prev, ghs, W_hh; write dgates, dh0,
    dc0."""
    return bound_ms(
        F32 * (seq * batch * 10 * hidden + 4 * hidden * hidden
               + 2 * batch * hidden),
        seq * batch * (8 * hidden * hidden + 20 * hidden))


def cudnn_lstm_ms(n_in, hidden, n_layers, seq, batch, device, backward,
                  reps=20):
    """``torch.nn.LSTM`` (cuDNN) at a kernel's shape: the forward, or the
    backward of a retained graph."""
    lstm = torch.nn.LSTM(n_in, hidden, num_layers=n_layers).to(device)
    x = torch.randn(seq, batch, n_in, device=device, requires_grad=True)
    if not backward:
        with torch.no_grad():
            return cuda_ms(lambda: lstm(x), reps)
    out, _ = lstm(x)
    g = torch.randn_like(out)
    params = [x, *lstm.parameters()]
    return cuda_ms(lambda: torch.autograd.grad(out, params, g,
                                               retain_graph=True), reps)


def card_line():
    """``name, power limit`` of the card as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip()


def open_device(device):
    """``device`` as a ``torch.device``.  A CUDA device raises
    ``RuntimeError`` when there is no card, so that a measurement never
    falls back to the CPU, and gets full-f32 math (no TF32), as
    ``Paule`` sets it; only a caller that names the CPU runs there."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the measurement tools run on the card "
                "(run(device='cpu') rehearses one on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def labels(device):
    """What a result was measured on: ``{"device": "cuda" | "cpu",
    "card": nvidia-smi's name and power limit, or None on the CPU}``."""
    on_card = device.type == "cuda"
    return {"device": device.type, "card": card_line() if on_card else None}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_s(fn, device):
    """Host seconds of ``fn()`` up to ``torch.cuda.synchronize()`` on the
    card.  -> (seconds, what ``fn`` returned)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def plan_kwargs(target, *, n_inner=25, n_epochs=10, n_batches=3,
                batch_size=8):
    """The ``plan_resynth`` keywords of the JAX tools' budget
    (``tools/bench_variants.py:45-48``, ``tools/synthesis_breakdown.py:
    77-80``) but ``n_outer``; the budget keywords cut it."""
    return dict(target_acoustic=target, objective="acoustic_semvec",
                initialize_from="acoustic", log_ii=1, log_semantics=True,
                n_inner=n_inner, n_batches=n_batches, batch_size=batch_size,
                n_epochs=n_epochs, continue_learning=True, verbose=False)


def budget_line(n_inner, n_epochs, n_batches, batch_size):
    """-> the budget as the JAX tools' results state it."""
    return (f"per outer: {n_inner} inner steps, log_ii=1, continue-learning "
            f"({n_batches}x{batch_size}x{n_epochs})")


def interleaved_rounds(runs, reps, outers, device, tag):
    """Warm each ``plan_resynth`` of ``runs`` (``{name: (paule, plan
    keywords)}``) with one outer iteration, then plan ``outers`` hot outer
    iterations with each in turn, ``reps`` rounds, so that a change in the
    host's speed meets every entry of a round alike.  -> ``(walls,
    splits)``: per name, each round's host seconds per outer iteration
    (ending in a synchronize) and ``last_planning_timings`` per outer
    iteration."""
    for name, (model, kw) in runs.items():
        print(f"[{tag}] warm {name}...", file=sys.stderr, flush=True)
        model.plan_resynth(n_outer=1, **kw)
    walls = {name: [] for name in runs}
    splits = {name: [] for name in runs}
    for rep in range(reps):
        for name, (model, kw) in runs.items():
            wall, _r = wall_s(
                lambda: model.plan_resynth(n_outer=outers, **kw), device)
            walls[name].append(wall / outers)
            splits[name].append({k: v / outers for k, v in
                                 model.last_planning_timings.items()})
        print(f"[{tag}] round {rep + 1}/{reps}: " + " ".join(
            f"{n}={w[-1]:.2f}s" for n, w in walls.items()),
            file=sys.stderr, flush=True)
    return walls, splits


def spread(xs, ndigits=3):
    """-> ``{"median", "iqr": [p25, p75], "all"}`` of ``xs``, each rounded
    to ``ndigits`` as the JAX tools report them
    (``tools/bench_variants.py:86-116``)."""
    def q(p):
        return round(float(np.percentile(np.asarray(xs), p)), ndigits)
    return {"median": round(float(np.median(xs)), ndigits),
            "iqr": [q(25), q(75)], "all": [round(x, ndigits) for x in xs]}


def rounds_summary(walls, splits):
    """The JAX tools' summary of one entry's rounds
    (:func:`interleaved_rounds`): the per-outer wall's median, IQR and
    values, and the median of each phase per outer iteration."""
    s = spread(walls)
    return {"s_per_outer_median": s["median"], "s_per_outer_iqr": s["iqr"],
            "s_per_outer_all": s["all"],
            "phase_split_s_median": {
                k: round(float(np.median([x[k] for x in splits])), 3)
                for k in splits[0]}}


def leaf_numbers(obj, key=None):
    """-> [(key, value)] of every leaf number or ``None`` of a tool's
    result, each with the key it stands under."""
    if isinstance(obj, dict):
        return [kv for k, v in obj.items() for kv in leaf_numbers(v, k)]
    if isinstance(obj, (list, tuple)):
        return [kv for v in obj for kv in leaf_numbers(v, key)]
    if obj is None or (isinstance(obj, (int, float))
                       and not isinstance(obj, bool)):
        return [(key, obj)]
    return []


def emit(result, out_path=None):
    """Print a tool's ``result`` as one JSON line, and write it to
    ``out_path`` when given."""
    line = json.dumps(result)
    print(line)
    if out_path:
        with open(out_path, "w") as fh:
            fh.write(line + "\n")
