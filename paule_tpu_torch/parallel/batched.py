"""Planning of several same-length utterances as one batch on one device
(counterpart of ``paule_tpu/parallel/batched.py``).

The trajectories of B utterances form one ``(B, T, 30)`` leaf: each inner
step runs the models once at batch B (the LSTM kernels at batch B) through
:func:`~paule_tpu_torch.planning.engine.criterion_batched`, whose
per-utterance losses sum to the loss differentiated.  No term couples two
utterances and torch's Adam is elementwise, so one Adam over the batch
plans each utterance as B separate planners would.

:func:`plan_batch_resynth` is the batched counterpart of
``Paule.plan_resynth``: per outer iteration ``n_inner`` planning steps, then
one synthesis of each utterance's trajectory (not one per inner step), the
produced-audio metrics against each utterance's targets, and, with
``continue_learning``, training of the shared predictive model (and, with
``continue_learning_tube``, the cp->tube and tube->mel models) on the B
produced pairs.

Only ``mesh=None`` is ported: data parallelism over a device mesh
(``paule_tpu/parallel/mesh.py``) raises ``NotImplementedError``.
"""

import numpy as np
import torch

from ..api import _np, _phase
from ..planning import engine

#: the produced-audio metrics logged per outer iteration, as ``<key>_curve``
CURVES = ("prod_loss", "prod_semvec_loss", "prod_sc_loss", "prod_tube_loss",
          "prod_tube_mel_loss", "prod_tube_semvec_loss")


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "planning over a device mesh (paule_tpu/parallel/mesh.py) is not "
            "ported yet (ROADMAP.md, 'Modules to port', item 11, its "
            "data-parallel bullet); pass mesh=None")


def plan_segment_batched(models, xx, optimizer, target_mels, target_semvecs,
                         *, n_steps, objective, log_semantics, constraints):
    """Run ``n_steps`` planning updates of the leaf ``xx (B, T, 30)`` in
    place towards ``target_mels (B, F, 60)`` and ``target_semvecs (B,
    300)`` (``paule_tpu/parallel/batched.py:23-66``).  -> the logs of every
    step on the device: ``sub_losses``, a :class:`SubLosses` of ``(n_steps,
    B)`` tensors, and ``xx_pre`` ``(n_steps, B, T, 30)``, each step's
    trajectories before its update."""
    xx_init = xx.detach().clone()
    subs, xx_pre = [], []
    for _ in range(n_steps):
        optimizer.zero_grad(set_to_none=True)
        total, (sub, _mel, _semvec) = engine.criterion_batched(
            models, xx, target_mels, target_semvecs, objective=objective,
            log_semantics=log_semantics)
        total.sum().backward()
        subs.append(torch.stack([s.detach() for s in sub]))
        xx_pre.append(xx.detach().clone())
        optimizer.step()
        engine.apply_constraints(xx, xx_init, constraints)
    return {"sub_losses": engine.SubLosses(*torch.stack(subs, dim=1)),
            "xx_pre": torch.stack(xx_pre)}


def _prepare_batch(paule_obj, target_mels, target_semvecs,
                   learning_rate_planning):
    """The targets on the device, the target semvecs (the embedder's of
    the target mels when not given), the inverse model's trajectories
    clipped to +-1 as the planning leaf, and one Adam over the whole batch,
    which equals one per utterance (``paule_tpu/parallel/batched.py:69-101``,
    ``init_batched_opt_state``).  -> ``(xx, optimizer, target_mels,
    target_semvecs)``."""
    target_mels = paule_obj._tensor(target_mels)
    if target_semvecs is None:
        target_semvecs = paule_obj._embed(target_mels)
    else:
        target_semvecs = paule_obj._tensor(target_semvecs)
    with torch.no_grad():
        xx = paule_obj.inv_model(target_mels).clamp(-1.0, 1.0)
    xx.requires_grad_(True)
    return (xx, engine.make_optimizer(xx, learning_rate_planning),
            target_mels, target_semvecs)


def _sub_losses_np(logs):
    return engine.SubLosses(*(_np(s) for s in logs["sub_losses"]))


def plan_batch(paule_obj, target_mels, target_semvecs=None, *, mesh=None,
               n_steps=25, learning_rate_planning=0.01, objective="acoustic",
               log_semantics=False, synthesize=True):
    """Plan the same-length utterances ``target_mels (B, F, 60)``
    (normalised log-mels) together for ``n_steps`` steps.  -> ``{
    "planned_cp" (B, 2F, 30), "sub_losses"`` (a :class:`SubLosses` of
    ``(n_steps, B)`` arrays) ``}``, and with ``synthesize`` ``"prod_sigs"``,
    the audio of each planned trajectory through ``paule_obj``'s plant."""
    _no_mesh(mesh)
    xx, optimizer, target_mels, target_semvecs = _prepare_batch(
        paule_obj, target_mels, target_semvecs, learning_rate_planning)
    logs = plan_segment_batched(
        paule_obj._models(), xx, optimizer, target_mels, target_semvecs,
        n_steps=n_steps, objective=objective, log_semantics=log_semantics,
        constraints=engine.Constraints(smiling=paule_obj.smiling))
    out = {"planned_cp": _np(xx), "sub_losses": _sub_losses_np(logs)}
    if synthesize:
        out["prod_sigs"] = list(paule_obj._synthesize(out["planned_cp"])[0])
    return out


def plan_batch_resynth(paule_obj, target_mels, target_semvecs=None, *,
                       mesh=None, n_outer=5, n_inner=25,
                       learning_rate_planning=0.01, objective="acoustic",
                       log_semantics=False, continue_learning=True,
                       continue_learning_tube=False, n_epochs=2, batch_size=8,
                       verbose=False):
    """The batched counterpart of ``Paule.plan_resynth`` for the
    same-length utterances ``target_mels (B, F, 60)``
    (``paule_tpu/parallel/batched.py:170-334``; module docstring).  The
    phases' wall times go to ``paule_obj.last_planning_timings`` and are
    marked ``plan_batch_resynth.<phase>`` in a ``torch.profiler`` trace.

    -> a dict: ``planned_cp`` (B, 2F, 30); ``prod_sigs`` and ``prod_mels``
    of the last outer iteration; ``prod_loss_curve`` (n_outer, B) and, as
    the variant and objective log them, ``prod_semvec_loss_curve``,
    ``prod_sc_loss_curve``, ``prod_tube_loss_curve``,
    ``prod_tube_mel_loss_curve``, ``prod_tube_semvec_loss_curve``;
    ``sub_losses``, one :class:`SubLosses` of (n_inner, B) arrays per outer
    iteration; ``pred_model_loss``, one loss per training step; under the
    somatosensory variant ``prod_tubes`` and, with
    ``continue_learning_tube``, ``tube_model_loss`` and
    ``tube_mel_model_loss``."""
    _no_mesh(mesh)
    if n_outer < 1:
        raise ValueError("n_outer must be >= 1")
    xx, optimizer, target_mels, target_semvecs = _prepare_batch(
        paule_obj, target_mels, target_semvecs, learning_rate_planning)
    b = xx.shape[0]
    models = paule_obj._models()
    cons = engine.Constraints(smiling=paule_obj.smiling)
    somato = paule_obj.use_somatosensory_feedback
    want_semvec = log_semantics or objective != "acoustic"
    timings = {"planning": 0.0, "synthesis": 0.0, "metrics": 0.0,
               "continue_learning": 0.0}
    curves = {}
    losses = {"pred": [], "tube": [], "tube_mel": []}
    sub_losses = []

    def phase(name):
        return _phase(timings, name, "plan_batch_resynth")

    def train_shared(trainer, all_in, all_out, log):
        """``n_epochs`` epochs over all B pairs, reshuffled each epoch and
        cut into batches of ``batch_size``, the last one smaller
        (``paule_tpu/parallel/batched.py:230-251``); the orders are drawn
        first, as JAX draws them, and copied to the device at once."""
        orders = torch.as_tensor(
            [paule_obj._py_rng.sample(range(b), b) for _ in range(n_epochs)],
            device=all_in.device)
        for order in orders:
            for start in range(0, b, batch_size):
                idx = order[start:start + batch_size]
                log.append(trainer.train_batch(all_in[idx], all_out[idx]))

    for ii_outer in range(n_outer):
        with phase("planning"):
            logs = plan_segment_batched(
                models, xx, optimizer, target_mels, target_semvecs,
                n_steps=n_inner, objective=objective,
                log_semantics=log_semantics, constraints=cons)
            sub_losses.append(_sub_losses_np(logs))
            cps = _np(xx)
        with phase("synthesis"):
            sigs, _sr, prod_tubes = paule_obj._synthesize(cps)
        with phase("metrics"):
            pm, pm_dev = paule_obj._prod_metrics(
                sigs, xx.detach(), prod_tubes, target_mels, target_semvecs,
                want_semvec)
            for key in CURVES:
                if key in pm:
                    curves.setdefault(key, []).append(pm[key])
            if verbose:
                prod = pm["prod_loss"]
                print(f"outer {ii_outer}: prod loss mean {prod.mean():.4f} "
                      f"max {prod.max():.4f}")
        if continue_learning:
            with phase("continue_learning"):
                cps_dev = xx.detach()
                train_shared(paule_obj.pred_trainer, cps_dev,
                             pm_dev["prod_mel"], losses["pred"])
                if continue_learning_tube and somato:
                    train_shared(paule_obj.tube_trainer, cps_dev,
                                 pm_dev["prod_tube"], losses["tube"])
                    train_shared(paule_obj.tube_mel_trainer,
                                 pm_dev["prod_tube"], pm_dev["prod_mel"],
                                 losses["tube_mel"])
    paule_obj.last_planning_timings = timings

    def floats(log):
        return torch.stack(log).tolist() if log else []

    out = {"planned_cp": _np(xx), "prod_sigs": list(sigs),
           "prod_mels": pm["prod_mel"],
           "prod_loss_curve": np.stack(curves.pop("prod_loss")),
           "sub_losses": sub_losses, "pred_model_loss": floats(losses["pred"])}
    out.update({f"{key}_curve": np.stack(v) for key, v in curves.items()})
    if somato:
        out["prod_tubes"] = prod_tubes
        if continue_learning_tube:
            out["tube_model_loss"] = floats(losses["tube"])
            out["tube_mel_model_loss"] = floats(losses["tube_mel"])
    return out
