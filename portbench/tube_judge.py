"""The tube models' continue-learning in the comparison that decides
``correct``: the first steps of the cp->tube and tube->mel models in the
judged batch, held to the plain reference (:mod:`.plain.train`) as
:mod:`.judge` holds the predictive model's.  Each training number
(``start_state``, ``train_loss``, ``train_grad``, ``train_change``) is
then the largest over the three trained models; each model's own is kept
beside it as ``<number>.<model>`` (``predictive``, ``cp_tube``,
``tube_mel``), printed but not compared.

A driver hands them over as ``outputs["tube_train"]``: ``{model: the
"train" entry of a TrainTap}``, the rows of the cp->tube model indexing
``snap_cps`` and those of the tube->mel model ``snap_tubes``.  The
reference trains each model from its own copy of the release on the
program's trajectories and tubes (``tube`` holds those to the plain
synthesizer's) and on the mels of the program's audio.

:mod:`.judge` compares the predictive model alone, and the harness calls
its ``numbers`` and ``control``; :func:`install` wraps both so that
``outputs`` holding ``tube_train`` are compared over all three models
(and the control gets its readings).  Other outputs pass through
unchanged."""

import numpy as np

from . import judge as J
from .plain import train as plain_train

#: the trained tube models by release prefix, and whether each halves
#: the sequence (tube->mel predicts at the mel's frame rate)
HALF = {"cp_tube": False, "tube_mel": True}
#: the numbers that compare a model's training
TRAINING = ("start_state", "train_loss", "train_grad", "train_change")


def _reference(ref, outputs, model, rows, prod_mels):
    """``ref``'s steps of ``model`` on the program's rows, from the
    release and a fresh Adam: ``(losses, {leaf: first gradient}, {leaf:
    change})``, the last two as float64 arrays."""
    cps = ref.tensor(outputs["snap_cps"])
    tubes = ref.tensor(outputs["snap_tubes"])
    x, y = (cps, tubes) if model == "cp_tube" else (tubes, prod_mels)
    batches = [(x[list(r)], y[list(r)]) for r in rows]
    with J.tf32(ref.tf32):
        losses, first, weights = plain_train.train_steps(
            ref.p, batches, prefix=model, half=HALF[model])
    return (losses, {k: J._np(g) for k, g in first.items()},
            {k: J._np(weights[-1][k] - ref.p[k]) for k in first})


def _start_gap(ref, model, state):
    """:func:`.judge._start_gap` for ``model``'s leaves."""
    weights, adam = state
    keys = {k for k in ref.p if k.startswith(model + ".")}
    if set(weights) != keys or set(adam) != keys:
        return float("inf")
    gaps = [float(np.max(np.abs(J._np(w) - J._np(ref.p[k]))))
            for k, w in weights.items()]
    gaps += [max(float(t), float(np.max(np.abs(J._np(m)))),
                 float(np.max(np.abs(J._np(v))))) for m, v, t in adam.values()]
    return max(gaps)


def numbers(outputs, ref):
    """The tube models' training gaps: ``{name.model: value}``, each
    measured as :func:`.judge.numbers` measures the predictive model's."""
    out = {}
    prod_mels = ref.run(ref.mel, outputs["snap_audio"])
    for model, train in outputs["tube_train"].items():
        out[f"start_state.{model}"] = _start_gap(ref, model, train["state"])
        losses, first, change = J._training(train)
        r_losses, r_first, r_change = _reference(ref, outputs, model,
                                                 train["rows"], prod_mels)
        out[f"train_loss.{model}"] = J._rel(losses[:1], r_losses[:1])
        gaps = J._leaf_gaps(first, r_first)
        out[f"train_grad.{model}"] = (float("inf") if gaps is None
                                      else max(gaps.values()))
        g = J._norms(r_first)
        floor = 1e-3 * float(np.median(list(g.values())))
        gaps = J._leaf_gaps(change, r_change, [k for k in g if g[k] >= floor])
        out[f"train_change.{model}"] = (
            float("inf") if gaps is None
            else float(np.median(list(gaps.values()))))
    return out


def control(outputs, ctrl):
    """``outputs["tube_train"]`` with the readings of the control ``ctrl``
    in the program's place, on the control's own audio and tubes
    (``outputs`` as :func:`.judge.control` returns them)."""
    prod_mels = ctrl.run(ctrl.mel, outputs["snap_audio"])
    return {model: dict(train, readings=_reference(
        ctrl, outputs, model, train["rows"], prod_mels))
        for model, train in outputs["tube_train"].items()}


def install():
    """Wrap :func:`.judge.numbers` and :func:`.judge.control` (once per
    process) so that outputs with ``tube_train`` are compared over all
    three trained models."""
    if getattr(J.numbers, "tube_train", False):
        return
    base_numbers, base_control = J.numbers, J.control

    def numbers_with_tubes(outputs, inputs, ref):
        out = base_numbers(outputs, inputs, ref)
        if "tube_train" in outputs:
            for name in TRAINING:
                out[name + ".predictive"] = out[name]
            out.update(numbers(outputs, ref))
            for name in TRAINING:
                each = [out[f"{name}.{model}"] for model in
                        ("predictive", *outputs["tube_train"])]
                out[name] = (float("nan") if any(v != v for v in each)
                             else max(each))
        return out

    def control_with_tubes(outputs, inputs, ctrl):
        out = base_control(outputs, inputs, ctrl)
        if "tube_train" in outputs:
            out["tube_train"] = control(out, ctrl)
        return out

    numbers_with_tubes.tube_train = True
    J.numbers, J.control = numbers_with_tubes, control_with_tubes
