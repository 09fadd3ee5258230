"""Where the planning inner step's time goes above its recurrence floor, on
the card (the port's counterpart of ``tools/step_decomposition.py``).

A ladder of five loops, each a faithful subset of the real inner step at
the bench shape (402 cp frames, H=720 models, ``acoustic_semvec``):

    full            the real plan_segment (criterion, Adam, constraints,
                    logs)
    vg_criterion    value and gradient of engine.criterion, then
                    x -= 1e-4 * g
    vg_models       the forward model and the embedder with the two RMSEs
                    (the criterion without the velocity, jerk and
                    local-linear terms)
    vg_models_sum   the same models with plain sums in place of the RMSEs
    vg_pred_only    the forward model's input projection and its
                    recurrence (B1 forward, B2 backward) alone

Each rung's per-step cost is the slope of wall(n_steps) over n_steps in
{5, 25, 50}, each wall the median of 9 host clocks that end in
``torch.cuda.synchronize()`` after a warm-up, so a per-call set-up
cancels.  Consecutive differences split the step into the kernels, the
rest of the criterion, and Adam with its projections.

Run on the card::

    python -m paule_tpu_torch.tools.step_decomposition [--out FILE]

Prints one JSON line (with the card's name and power limit); without a
card it raises.
"""

import argparse
import statistics
import sys

import torch

from ..ops import losses as L
from ..ops.lstm_kernels import LSTMCore
from ..planning import engine
from . import timing
from .roofline import (HIDDEN, T_CP, _fit_slope, planning_models,
                       planning_run, planning_targets)

REPS = 9
STEP_COUNTS = (5, 25, 50)
#: the descent step of the ``vg_*`` rungs
STEP = 1e-4


def ladder_losses(models, target_mel, target_semvec):
    """The ``vg_*`` rungs' losses, each a function of the trajectory ``x
    (B, T, 30)`` -> a scalar (``tools/step_decomposition.py:118-147``)."""
    layer = models.pred_model.lstm[0]

    def criterion(x):
        total, _aux = engine.criterion(models, x, target_mel, target_semvec,
                                       objective="acoustic_semvec")
        return total

    def both(x):
        pred_mel = models.pred_model(x)
        return pred_mel, models.embedder(pred_mel)

    def models_rmse(x):
        pred_mel, semvec = both(x)
        return (engine.MEL_WEIGHT * L.rmse(pred_mel, target_mel)
                + engine.SEMANTIC_WEIGHT * L.rmse(semvec, target_semvec))

    def models_sum(x):
        pred_mel, semvec = both(x)
        return pred_mel.sum() + semvec.sum()

    def pred_only(x):
        gates = (x.transpose(0, 1) @ layer.w_ih + layer.b).contiguous()
        h0 = x.new_zeros((x.shape[0], layer.w_hh.shape[0]))
        hs, _cs = LSTMCore.apply(gates, layer.w_hh, h0, h0)
        return hs.sum()

    return {"vg_criterion": criterion, "vg_models": models_rmse,
            "vg_models_sum": models_sum, "vg_pred_only": pred_only}


def value_and_grad(loss_fn, x):
    """-> (``loss_fn(x)``, its gradient with respect to ``x``)."""
    x = x.detach().requires_grad_(True)
    value = loss_fn(x)
    grad, = torch.autograd.grad(value, x)
    return value.detach(), grad


def descend(loss_fn, x0, n_steps):
    """``n_steps`` of ``x -= 1e-4 * grad loss_fn(x)`` from ``x0``."""
    x = x0
    for _ in range(n_steps):
        _value, grad = value_and_grad(loss_fn, x)
        x = x.detach() - STEP * grad
    return x


def ladder(models, t_cp, device):
    """-> ``{rung: factory}``, ``factory(n_steps)`` a call that runs the
    rung's loop of ``n_steps`` from the zero trajectory and returns the
    trajectory."""
    xx0, tmel, tsem = planning_targets(1, t_cp, device)
    rungs = {"full": lambda n: planning_run(models, 1, n, t_cp, device)}
    for name, loss_fn in ladder_losses(models, tmel, tsem).items():
        rungs[name] = _descent(loss_fn, xx0)
    return rungs


def _descent(loss_fn, xx0):
    def factory(n_steps):
        return lambda: descend(loss_fn, xx0, n_steps)
    return factory


def median_wall(fn, device, reps=REPS):
    """Median host seconds of ``fn()`` over ``reps`` calls after a
    warm-up, each up to a synchronize."""
    timing.wall_s(fn, device)
    return statistics.median(timing.wall_s(fn, device)[0]
                             for _ in range(reps))


def run(*, device="cuda", hidden=HIDDEN, t_cp=T_CP, step_counts=STEP_COUNTS,
        reps=REPS):
    """Per-inner-step ms of each rung.  -> the result as a JSON-able
    dict."""
    device = timing.open_device(device)
    models = planning_models(hidden, device)
    out = {"backend": device.type, **timing.labels(device), "hidden": hidden,
           "t_cp": t_cp,
           "method": ("per-step cost = slope of wall(n_steps) at n_steps in "
                      f"{list(step_counts)}; walls are medians of {reps} "
                      "host walls, each ending in a synchronize, after a "
                      "warm-up"),
           "per_inner_step_ms": {}, "walls_ms": {}}
    for name, factory in ladder(models, t_cp, device).items():
        walls = {n: median_wall(factory(n), device, reps)
                 for n in step_counts}
        slope, _icept = _fit_slope(list(walls), list(walls.values()))
        out["per_inner_step_ms"][name] = slope * 1e3
        out["walls_ms"][name] = {str(n): w * 1e3 for n, w in walls.items()}
        print(f"[decomp] {name}: {slope * 1e3:.3f} ms/step (walls "
              f"{out['walls_ms'][name]})", file=sys.stderr, flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    timing.emit(run(device="cuda"), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
