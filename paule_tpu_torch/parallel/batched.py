"""Planning of several same-length utterances as one batch (counterpart
of ``paule_tpu/parallel/batched.py``), on one device or, with ``mesh=``,
data parallel over the devices of a :class:`~paule_tpu_torch.parallel.
mesh.Mesh`.

The trajectories of B utterances form one ``(B, T, 30)`` leaf: each inner
step runs the models once at batch B (the LSTM kernels at batch B) through
:func:`~paule_tpu_torch.planning.engine.criterion_batched`, whose
per-utterance losses sum to the loss differentiated.  No term couples two
utterances and torch's Adam is elementwise, so one Adam over the batch
plans each utterance as B separate planners would.

With a mesh, the batch axis is split into ``dp`` shards
(``paule_tpu/parallel/batched.py:95-98``): each shard is its own leaf with
its own Adam, initialised and planned on its device against a replica of
the models (:func:`~paule_tpu_torch.parallel.mesh.replicate`), each step
queued on every device in turn; for the same reason as above this plans
as the unsharded batch does.  The tube embedder's dropout masks are drawn
for the whole batch, as one device draws them, and split.

:func:`plan_batch_resynth` is the batched counterpart of
``Paule.plan_resynth``: per outer iteration ``n_inner`` planning steps, then
one synthesis of each utterance's trajectory (not one per inner step), the
produced-audio metrics against each utterance's targets, and, with
``continue_learning``, training of the shared predictive model (and, with
``continue_learning_tube``, the cp->tube and tube->mel models) on the B
produced pairs.  With a mesh, a training batch that ``dp`` divides is
sharded (``paule_tpu/parallel/batched.py:248-250``): each replica predicts
its shard, the whole batch's loss is taken on the primary device, the
gradients that reach the replicas are summed into the primary copy, one
Adam step runs there, and the replicas take its weights.  Synthesis and
the metrics run on the primary device (``Paule.device``).
"""

from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from ..api import _np
from ..ops import lstm as LS
from ..planning import engine
from . import mesh as mesh_mod

#: the produced-audio metrics logged per outer iteration, as ``<key>_curve``
CURVES = ("prod_loss", "prod_semvec_loss", "prod_sc_loss", "prod_tube_loss",
          "prod_tube_mel_loss", "prod_tube_semvec_loss")


class Shard(NamedTuple):
    """One shard of a batch: its planning models (replicas on its device),
    its leaf ``xx (b, T, 30)`` and Adam, and its targets."""
    models: engine.Models
    xx: torch.Tensor
    optimizer: torch.optim.Optimizer
    target_mels: torch.Tensor
    target_semvecs: torch.Tensor


def _keep_masks(models, batch, seq):
    """One step's dropout keep masks of the tube embedder for ``batch``
    trajectories of ``seq`` frames, drawn from ``models.tube_generator``
    as the embedder draws them, or ``None`` without dropout."""
    emb = models.tube_embedder
    if emb is None or emb.dropout <= 0.0:
        return None
    return LS.draw_keep_masks([layer.params() for layer in emb.lstm], batch,
                              seq, emb.dropout, models.tube_generator)


def plan_shards(shards, *, n_steps, objective, log_semantics, constraints,
                device):
    """Run ``n_steps`` planning updates of every shard's leaf in place,
    each step queued on every shard's device in turn; with more than one
    shard, the tube embedder's masks of the whole batch are drawn from the
    first shard's generator and split.  -> the logs of every step on
    ``device``, the shards joined in order: ``sub_losses``, a
    :class:`SubLosses` of ``(n_steps, B)`` tensors, and ``xx_pre``
    ``(n_steps, B, T, 30)``, each step's trajectories before its update."""
    inits = [s.xx.detach().clone() for s in shards]
    subs = [[] for _ in shards]
    xx_pre = [[] for _ in shards]
    batch = sum(s.xx.shape[0] for s in shards)
    for _ in range(n_steps):
        masks = (_keep_masks(shards[0].models, batch, shards[0].xx.shape[1])
                 if len(shards) > 1 else None)
        row = 0
        for s, init, sub_log, pre_log in zip(shards, inits, subs, xx_pre):
            b = s.xx.shape[0]
            keep = (None if masks is None else
                    [m[row:row + b].to(s.xx.device) for m in masks])
            row += b
            s.optimizer.zero_grad(set_to_none=True)
            total, (sub, _mel, _semvec) = engine.criterion_batched(
                s.models, s.xx, s.target_mels, s.target_semvecs,
                objective=objective, log_semantics=log_semantics,
                tube_keep_masks=keep)
            total.sum().backward()
            sub_log.append(torch.stack([x.detach() for x in sub]))
            pre_log.append(s.xx.detach().clone())
            s.optimizer.step()
            engine.apply_constraints(s.xx, init, constraints)
    return {"sub_losses": engine.SubLosses(*torch.cat(
                [torch.stack(sub, dim=1).to(device) for sub in subs], dim=2)),
            "xx_pre": torch.cat([torch.stack(pre).to(device)
                                 for pre in xx_pre], dim=1)}


def plan_segment_batched(models, xx, optimizer, target_mels, target_semvecs,
                         *, n_steps, objective, log_semantics, constraints):
    """Run ``n_steps`` planning updates of the leaf ``xx (B, T, 30)`` in
    place towards ``target_mels (B, F, 60)`` and ``target_semvecs (B,
    300)`` (``paule_tpu/parallel/batched.py:23-66``): :func:`plan_shards`
    of one shard.  -> the logs of every step on the device:
    ``sub_losses``, a :class:`SubLosses` of ``(n_steps, B)`` tensors, and
    ``xx_pre`` ``(n_steps, B, T, 30)``, each step's trajectories before its
    update."""
    return plan_shards(
        [Shard(models, xx, optimizer, target_mels, target_semvecs)],
        n_steps=n_steps, objective=objective, log_semantics=log_semantics,
        constraints=constraints, device=xx.device)


def _prepare_batch(paule_obj, target_mels, target_semvecs,
                   learning_rate_planning, mesh):
    """The targets on the device, the target semvecs (the embedder's of
    the target mels when not given), the inverse model's trajectories
    clipped to +-1 as the planning leaf, and one Adam over the leaf, which
    equals one per utterance (``paule_tpu/parallel/batched.py:69-101``,
    ``init_batched_opt_state``); with a mesh, all of it per shard on its
    device, against replicas of the models.  -> ``([Shard], target_mels,
    target_semvecs)``, the last two of the whole batch on the device."""
    mesh_mod.check_mesh(mesh)
    target_mels = paule_obj._tensor(target_mels)
    if target_semvecs is not None:
        target_semvecs = paule_obj._tensor(target_semvecs)
    models = paule_obj._models()
    if mesh is None:
        parts = [(models, paule_obj.inv_model, target_mels, target_semvecs)]
    else:
        reps = {f: mesh_mod.replicate(mesh, getattr(models, f))
                for f in engine.Models._fields if f != "tube_generator"}
        dp = mesh.shape["dp"]
        parts = zip(
            [engine.Models(**{f: r[i] for f, r in reps.items()},
                           tube_generator=models.tube_generator)
             for i in range(dp)],
            mesh_mod.replicate(mesh, paule_obj.inv_model),
            mesh_mod.shard_batch(mesh, target_mels),
            ([None] * dp if target_semvecs is None
             else mesh_mod.shard_batch(mesh, target_semvecs)))
    shards = []
    for models_i, inv_model, mels, semvecs in parts:
        with torch.no_grad():
            if semvecs is None:
                semvecs = models_i.embedder(mels)
            xx = inv_model(mels).clamp(-1.0, 1.0)
        xx.requires_grad_(True)
        shards.append(Shard(models_i, xx, engine.make_optimizer(
            xx, learning_rate_planning), mels, semvecs))
    if target_semvecs is None:
        target_semvecs = torch.cat([s.target_semvecs.to(paule_obj.device)
                                    for s in shards])
    return shards, target_mels, target_semvecs


def _joined(shards, device):
    """The shards' trajectories, detached, as one batch on ``device``."""
    return torch.cat([s.xx.detach().to(device) for s in shards])


def _sub_losses_np(logs):
    return engine.SubLosses(*(_np(s) for s in logs["sub_losses"]))


def plan_batch(paule_obj, target_mels, target_semvecs=None, *, mesh=None,
               n_steps=25, learning_rate_planning=0.01, objective="acoustic",
               log_semantics=False, synthesize=True):
    """Plan the same-length utterances ``target_mels (B, F, 60)``
    (normalised log-mels) together for ``n_steps`` steps.  -> ``{
    "planned_cp" (B, 2F, 30), "sub_losses"`` (a :class:`SubLosses` of
    ``(n_steps, B)`` arrays) ``}``, and with ``synthesize`` ``"prod_sigs"``,
    the audio of each planned trajectory through ``paule_obj``'s plant.
    ``mesh``: a :class:`~paule_tpu_torch.parallel.mesh.Mesh` whose ``dp``
    divides B (module docstring), or ``None``."""
    shards, _mels, _semvecs = _prepare_batch(
        paule_obj, target_mels, target_semvecs, learning_rate_planning, mesh)
    logs = plan_shards(
        shards, n_steps=n_steps, objective=objective,
        log_semantics=log_semantics,
        constraints=engine.Constraints(smiling=paule_obj.smiling),
        device=paule_obj.device)
    out = {"planned_cp": _np(_joined(shards, paule_obj.device)),
           "sub_losses": _sub_losses_np(logs)}
    if synthesize:
        out["prod_sigs"] = list(paule_obj._synthesize(out["planned_cp"])[0])
    return out


@tracing.entry("plan_batch_resynth")
def plan_batch_resynth(paule_obj, target_mels, target_semvecs=None, *,
                       mesh=None, n_outer=5, n_inner=25,
                       learning_rate_planning=0.01, objective="acoustic",
                       log_semantics=False, continue_learning=True,
                       continue_learning_tube=False, n_epochs=2, batch_size=8,
                       verbose=False):
    """The batched counterpart of ``Paule.plan_resynth`` for the
    same-length utterances ``target_mels (B, F, 60)``
    (``paule_tpu/parallel/batched.py:170-334``; module docstring).  The
    phases' wall times go to ``paule_obj.last_planning_timings``; a traced
    call (:mod:`paule_tpu_torch.tracing`) records the leaves of each phase:
    ``prelude`` (``shards``), ``planning`` (``shards``, ``to_host``),
    ``synthesis`` (``run``), ``metrics`` (``prod``, ``log``),
    ``continue_learning`` (``batch``, ``step``, ``sync_replicas``) and
    ``final`` (``to_host``).

    -> a dict: ``planned_cp`` (B, 2F, 30); ``prod_sigs`` and ``prod_mels``
    of the last outer iteration; ``prod_loss_curve`` (n_outer, B) and, as
    the variant and objective log them, ``prod_semvec_loss_curve``,
    ``prod_sc_loss_curve``, ``prod_tube_loss_curve``,
    ``prod_tube_mel_loss_curve``, ``prod_tube_semvec_loss_curve``;
    ``sub_losses``, one :class:`SubLosses` of (n_inner, B) arrays per outer
    iteration; ``pred_model_loss``, one loss per training step; under the
    somatosensory variant ``prod_tubes`` and, with
    ``continue_learning_tube``, ``tube_model_loss`` and
    ``tube_mel_model_loss``.  ``mesh``: a
    :class:`~paule_tpu_torch.parallel.mesh.Mesh` whose ``dp`` divides B
    (module docstring), or ``None``."""
    if tracing.ON:
        tracing.leaf("shards", phase="prelude")
    if n_outer < 1:
        raise ValueError("n_outer must be >= 1")
    shards, target_mels, target_semvecs = _prepare_batch(
        paule_obj, target_mels, target_semvecs, learning_rate_planning, mesh)
    device = paule_obj.device
    b = target_mels.shape[0]
    cons = engine.Constraints(smiling=paule_obj.smiling)
    somato = paule_obj.use_somatosensory_feedback
    want_semvec = log_semantics or objective != "acoustic"
    timings = {"planning": 0.0, "synthesis": 0.0, "metrics": 0.0,
               "continue_learning": 0.0}
    curves = {}
    losses = {"pred": [], "tube": [], "tube_mel": []}
    sub_losses = []

    def train_shared(trainer, name, all_in, all_out, log):
        """``n_epochs`` epochs over all B pairs, reshuffled each epoch and
        cut into batches of ``batch_size``, the last one smaller
        (``paule_tpu/parallel/batched.py:230-251``); the orders are drawn
        first, as JAX draws them, and copied to the device at once.  With a
        mesh, a batch that ``dp`` divides trains sharded over the shards'
        replicas of the model ``name``, which take the weights after every
        step."""
        if tracing.ON:
            tracing.leaf("batch")
        replicas = [getattr(s.models, name) for s in shards]
        orders = torch.as_tensor(
            [paule_obj._py_rng.sample(range(b), b) for _ in range(n_epochs)],
            device=all_in.device)
        if tracing.ON:
            tracing.sent(orders)
        for order in orders:
            for start in range(0, b, batch_size):
                if tracing.ON:
                    tracing.leaf("batch")
                idx = order[start:start + batch_size]
                if tracing.ON:
                    tracing.leaf("step")
                if mesh is not None and len(idx) % mesh.shape["dp"] == 0:
                    log.append(trainer.train_batch(
                        mesh_mod.shard_batch(mesh, all_in[idx]),
                        mesh_mod.shard_batch(mesh, all_out[idx]),
                        replicas=replicas))
                else:
                    log.append(trainer.train_batch(all_in[idx],
                                                   all_out[idx]))
                if tracing.ON:
                    tracing.leaf("sync_replicas")
                mesh_mod.sync_replicas(trainer.model, replicas)

    for ii_outer in range(n_outer):
        with tracing.phase(timings, "planning"):
            if tracing.ON:
                tracing.leaf("shards")
            logs = plan_shards(
                shards, n_steps=n_inner, objective=objective,
                log_semantics=log_semantics, constraints=cons, device=device)
            if tracing.ON:
                tracing.leaf("to_host")
            sub_losses.append(_sub_losses_np(logs))
            cps_dev = _joined(shards, device)
            cps = _np(cps_dev)
        with tracing.phase(timings, "synthesis"):
            if tracing.ON:
                tracing.leaf("run")
            sigs, _sr, prod_tubes = paule_obj._synthesize(cps)
        with tracing.phase(timings, "metrics"):
            if tracing.ON:
                tracing.leaf("prod")
            pm, pm_dev = paule_obj._prod_metrics(
                sigs, cps_dev, prod_tubes, target_mels, target_semvecs,
                want_semvec)
            if tracing.ON:
                tracing.leaf("log")
            for key in CURVES:
                if key in pm:
                    curves.setdefault(key, []).append(pm[key])
            if verbose:
                prod = pm["prod_loss"]
                print(f"outer {ii_outer}: prod loss mean {prod.mean():.4f} "
                      f"max {prod.max():.4f}")
        if continue_learning:
            with tracing.phase(timings, "continue_learning"):
                train_shared(paule_obj.pred_trainer, "pred_model", cps_dev,
                             pm_dev["prod_mel"], losses["pred"])
                if continue_learning_tube and somato:
                    train_shared(paule_obj.tube_trainer, "cp_tube_model",
                                 cps_dev, pm_dev["prod_tube"],
                                 losses["tube"])
                    train_shared(paule_obj.tube_mel_trainer,
                                 "tube_mel_model", pm_dev["prod_tube"],
                                 pm_dev["prod_mel"], losses["tube_mel"])
    if tracing.ON:
        tracing.leaf("to_host", phase="final")
    paule_obj.last_planning_timings = timings

    def floats(log):
        if not log:
            return []
        losses = torch.stack(log)
        if tracing.ON:
            tracing.fetched(losses)
        return losses.tolist()

    out = {"planned_cp": cps, "prod_sigs": list(sigs),
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
