"""Roofline of the planning inner step on the card (the port's counterpart
of ``tools/roofline.py``): the measured cost of a real planning step
against the floor that its LSTM recurrences set.

Each recurrence step at B=1 is a ``(B, 720) x (720, 2880)`` product plus
elementwise work, far too small to fill the card, so the bound is the
chain of dependent steps, not the FLOPs::

    derived floor (inner step) = sum over the recurrences of
        T_rec x per-step cost of its kernel

The per-step cost of each kernel is measured: B1-B4
(:mod:`paule_tpu_torch.ops.lstm_kernels`) are timed with CUDA events at
H=720 over T in {51, 201, 402, 804}, and the slope ``b`` of ``wall = a +
b T`` is the kernel's cost per time step (``a`` is its launch and
set-up).  One inner step runs the forward model's layer forward and
backward (B1 and B2 over T=402) and the embedder's two layers forward and
backward (B3 and B4 over T=201), so

    floor = 402 x (B1 + B2 per step) + 201 x (B3 + B4 per step).

The JAX tool builds the embedder's part from its one-layer kernel, two
layers of 201 steps each; the port's embedder runs the two layers as one
wavefront (B3, B4), so its floor is timed from those kernels.

The measured cost is the slope of wall(n_steps) over n_steps in {5, 25,
50} of the real planning segment (``planning.engine.plan_segment`` at
B=1, ``parallel.batched.plan_segment_batched`` at B > 1; H=720 models,
``acoustic_semvec``, ``log_semantics``), each wall the least of 8 host
clocks that end in ``torch.cuda.synchronize()`` after a warm-up.  A ratio
near 1 means the step is as fast as its recurrence chain; the rest is the
criterion's other work, Adam and the constraints.

Run on the card::

    python -m paule_tpu_torch.tools.roofline [--out FILE]

Prints one JSON line (with the card's name and power limit); writes it to
``FILE`` too when given.  Without a card it raises.
"""

import argparse
import sys
import time

import numpy as np
import torch

from ..models.blocks import init_random
from ..models.embedder import EmbeddingModel
from ..models.forward import ForwardModel
from ..ops import lstm_kernels as K
from ..parallel import batched
from ..planning import engine
from . import timing

HIDDEN = 720
T_CP = 402  # 1 s utterance (the bench shape)
REPS = 12
#: recurrence lengths of the kernels' per-step fit
T_LENS = (51, 201, 402, 804)
#: planning segment lengths of the per-inner-step fit
STEP_COUNTS = (5, 25, 50)
STEP_REPS = 8
BATCHES = (1, 8)


def _fit_slope(ts, walls):
    """Least-squares slope+intercept of wall(T)."""
    ts = np.asarray(ts, dtype=np.float64)
    walls = np.asarray(walls, dtype=np.float64)
    b, a = np.polyfit(ts, walls, 1)
    return float(b), float(a)


def time_fn(fn, device, reps=REPS):
    """Least host wall in seconds of ``fn()`` over ``reps`` calls, each up
    to ``torch.cuda.synchronize()``, after one warm-up call."""
    timing.wall_s(fn, device)
    return min(timing.wall_s(fn, device)[0] for _ in range(reps))


def kernel_ms(fn, device, reps=REPS):
    """Mean ms per call of ``fn`` after a warm-up: CUDA events on the card,
    the host clock on the CPU (the plain versions)."""
    if device.type == "cuda":
        return timing.cuda_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def kernel_inputs(seq, batch, hidden, device, seed=0):
    """Seeded float32 inputs of B1-B4 at ``(seq, batch, hidden)``: gate
    pre-activations and weights at scale 0.02 (the JAX tool's), states
    and cotangents at 0.5."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    four = 4 * hidden
    zeros = torch.zeros((batch, hidden), device=device)
    return {
        "gates": normal((seq, batch, four), 0.02),
        "w_hh": normal((hidden, four), 0.02),
        "w2": normal((2 * hidden, four), 0.02),
        "b2": normal((four,), 0.02),
        "zeros": zeros,
        "acts": [K.activate(normal((seq, batch, four), 1.0), hidden)
                 for _ in range(2)],
        "cs": [normal((seq, batch, hidden), 0.5) for _ in range(2)],
        "ghs": normal((seq, batch, hidden), 0.5),
    }


#: each kernel's call on :func:`kernel_inputs`
KERNEL_CALLS = {
    "lstm_fwd": lambda i: K.lstm_fwd(i["gates"], i["w_hh"], i["zeros"],
                                     i["zeros"]),
    "lstm_bwd": lambda i: K.lstm_bwd(i["acts"][0], i["cs"][0], i["ghs"],
                                     i["w_hh"]),
    "lstm_stack2_fwd": lambda i: K.lstm_stack2_fwd(
        i["gates"], i["w_hh"], i["w2"], i["b2"], *[i["zeros"]] * 4),
    "lstm_stack2_bwd": lambda i: K.lstm_stack2_bwd(
        *i["acts"], *i["cs"], i["ghs"], i["w_hh"], i["w2"]),
}


def measure_kernels(batch, hidden, t_lens, device, reps=REPS):
    """Each of B1-B4 at every T of ``t_lens``.  -> ``{kernel name:
    {"slope_us", "intercept_us", "walls_ms": {T: ms}}}``, the slope the
    cost per time step."""
    walls = {name: {} for name in KERNEL_CALLS}
    for t in t_lens:
        inp = kernel_inputs(t, batch, hidden, device, seed=t)
        for name, call in KERNEL_CALLS.items():
            walls[name][t] = kernel_ms(lambda: call(inp), device, reps)
        del inp
    out = {}
    for name, w in walls.items():
        slope, icept = _fit_slope(list(w), list(w.values()))
        out[name] = {"slope_us": slope * 1e3, "intercept_us": icept * 1e3,
                     "walls_ms": {str(t): ms for t, ms in w.items()}}
    return out


def planning_models(hidden, device):
    """The planning step's models in float32, seeded and frozen: the
    forward model (one layer) and the embedder (two layers) at width
    ``hidden``."""
    gen = torch.Generator().manual_seed(0)
    models = []
    for module in (ForwardModel(num_lstm_layers=1, hidden_size=hidden),
                   EmbeddingModel(num_lstm_layers=2, hidden_size=hidden)):
        module.to(device=device, dtype=torch.float32)
        init_random(module, gen)
        models.append(module.eval().requires_grad_(False))
    return engine.Models(*models)


def planning_targets(batch, t_cp, device, dtype=torch.float32):
    """Zero trajectory, target mel and target semvec of a batch."""
    return tuple(torch.zeros(shape, device=device, dtype=dtype) for shape in (
        (batch, t_cp, 30), (batch, t_cp // 2, 60), (batch, 300)))


def planning_run(models, batch, n_steps, t_cp, device, dtype=torch.float32):
    """-> a call that plans ``n_steps`` real inner steps of ``batch``
    trajectories of ``t_cp`` frames from zeros (``acoustic_semvec``,
    semantics logged, every step logged) and returns the trajectories."""
    xx0, tmel, tsem = planning_targets(batch, t_cp, device, dtype)
    kw = dict(n_steps=n_steps, objective="acoustic_semvec",
              log_semantics=True, constraints=engine.Constraints())

    def run():
        xx = xx0.clone().requires_grad_(True)
        opt = engine.make_optimizer(xx, 0.01)
        if batch == 1:
            engine.plan_segment(models, xx, opt, tmel, tsem, log_every=1,
                                **kw)
        else:
            batched.plan_segment_batched(models, xx, opt, tmel, tsem, **kw)
        return xx
    return run


def measure_planning_step(batch, *, device, hidden=HIDDEN, t_cp=T_CP,
                          step_counts=STEP_COUNTS, reps=STEP_REPS):
    """Per-inner-step cost in seconds of the real planning step at
    ``batch``: the slope of wall(n_steps) over ``step_counts``, each wall
    the least of ``reps``.  -> ``(slope, {n_steps: wall s})``."""
    models = planning_models(hidden, device)
    walls = {n: time_fn(planning_run(models, batch, n, t_cp, device),
                        device, reps) for n in step_counts}
    slope, _icept = _fit_slope(list(walls), list(walls.values()))
    return slope, walls


def run(*, device="cuda", batches=BATCHES, hidden=HIDDEN, t_cp=T_CP,
        t_lens=T_LENS, step_counts=STEP_COUNTS, reps=REPS,
        step_reps=STEP_REPS):
    """The kernels' per-step costs, the derived floor and the measured
    planning step at each batch size of ``batches``.  -> the result as a
    JSON-able dict."""
    device = timing.open_device(device)
    out = {"backend": device.type, **timing.labels(device),
           "hidden": hidden, "t_cp": t_cp, "per_step_us": {},
           "derived_vs_measured": {}}
    for batch in batches:
        kern = measure_kernels(batch, hidden, t_lens, device, reps)
        b1, b2, b3, b4 = (kern[name] for name in KERNEL_CALLS)
        out["per_step_us"][f"B{batch}"] = {
            "fwd_slope_us": b1["slope_us"],
            "fwd_intercept_us": b1["intercept_us"],
            "fwd_walls_ms": b1["walls_ms"],
            "fwdbwd_slope_us": b1["slope_us"] + b2["slope_us"],
            "fwdbwd_intercept_us": b1["intercept_us"] + b2["intercept_us"],
            "fwdbwd_walls_ms": {t: b1["walls_ms"][t] + b2["walls_ms"][t]
                                for t in b1["walls_ms"]},
            "stack2_fwdbwd_slope_us": b3["slope_us"] + b4["slope_us"],
            "kernels": kern,
        }
        derived = (t_cp * (b1["slope_us"] + b2["slope_us"])
                   + (t_cp // 2) * (b3["slope_us"] + b4["slope_us"])) * 1e-6
        measured, walls = measure_planning_step(
            batch, device=device, hidden=hidden, t_cp=t_cp,
            step_counts=step_counts, reps=step_reps)
        ratio = measured / derived if derived > 0 else float("inf")
        out["derived_vs_measured"][f"B{batch}"] = {
            "chain_steps_per_inner_step": t_cp + t_cp // 2,
            "derived_floor_ms": derived * 1e3,
            "measured_ms_per_inner_step": measured * 1e3,
            "ratio": ratio,
            "verdict": ("latency-bound (measured within ~30% of own "
                        "recurrence chain)" if ratio <= 1.3 else
                        f"headroom: {round((ratio - 1) * 100)}% above the "
                        "recurrence floor"),
            "walls_ms": {str(n): w * 1e3 for n, w in walls.items()},
        }
        print(f"[roofline] B={batch}: derived {derived * 1e3:.3f} ms, "
              f"measured {measured * 1e3:.3f} ms (x{ratio:.2f})",
              file=sys.stderr, flush=True)
    clock = "CUDA events" if device.type == "cuda" else "the host clock"
    out["method"] = (
        f"per-step cost = slope of wall(T) of each of B1-B4 at H={hidden}, "
        f"T in {list(t_lens)}, mean of {reps} calls ({clock}); derived "
        f"floor per planning inner step = {t_cp} x (B1 + B2 per step) + "
        f"{t_cp // 2} x (B3 + B4 per step); measured = slope of "
        f"wall(n_steps) of the real plan_segment (B > 1: "
        f"plan_segment_batched) at n_steps in {list(step_counts)}, least "
        f"of {step_reps} host walls ending in a synchronize")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    timing.emit(run(device="cuda"), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
