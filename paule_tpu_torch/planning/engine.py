"""The planning engine: gradient descent on a cp trajectory through the
learned forward model and embedder (counterpart of
``paule_tpu/planning/engine.py``).

A segment of ``n_steps`` runs eagerly: forward, backward, Adam, then the
constraint projections.  The speech-classifier and somatosensory variants
add their terms to the criterion when their models are in :class:`Models`
(``paule_tpu/planning/engine.py:116-161``).  One criterion serves a batch of
utterances (:func:`criterion_batched`, the batched planners of
:mod:`paule_tpu_torch.parallel.batched`) and the one trajectory of
``plan_resynth`` (:func:`criterion`).  Per-step logs stay on the
device until the caller fetches them once per segment.  As in the JAX
package, the snapshot logged at a step is the trajectory before that step's
update, and logs are kept for the last step of every ``log_every`` steps.
"""

from typing import NamedTuple

import torch

from ..ops import losses as L
from ..ops.derivatives import local_linear, vel_acc_jerk

# loss weights (paule_tpu/planning/engine.py:43-50)
MEL_WEIGHT = 5.0
VELOCITY_WEIGHT = 80.0
JERK_WEIGHT = 400.0
SEMANTIC_WEIGHT = 10.0
SPEECH_CLASSIFIER_WEIGHT = 0.1
LOCAL_LINEAR_WEIGHT = 100_000.0
TUBE_MEL_WEIGHT = MEL_WEIGHT
TUBE_SEMANTIC_WEIGHT = SEMANTIC_WEIGHT

OBJECTIVES = ("acoustic", "semvec", "acoustic_semvec")


class SubLosses(NamedTuple):
    """Weighted sub-losses of one step; inactive terms are zero."""
    total: torch.Tensor
    mel_loss: torch.Tensor
    semvec_loss: torch.Tensor
    velocity_loss: torch.Tensor
    jerk_loss: torch.Tensor
    local_linear_loss: torch.Tensor
    speech_classifier_loss: torch.Tensor
    tube_mel_loss: torch.Tensor
    tube_semvec_loss: torch.Tensor


class Models(NamedTuple):
    """The planning models; a variant's models are ``None`` when it is
    off.  ``tube_generator`` draws the tube embedder's dropout masks (on
    the trajectory's device)."""
    pred_model: torch.nn.Module
    embedder: torch.nn.Module
    speech_classifier: torch.nn.Module = None
    cp_tube_model: torch.nn.Module = None
    tube_mel_model: torch.nn.Module = None
    tube_embedder: torch.nn.Module = None
    tube_generator: torch.Generator = None


class Constraints(NamedTuple):
    """Post-update trajectory projections."""
    clamp: float = 1.05
    smiling: bool = False
    past_len: int = 0  # leading frames pinned to their initial value


def _bmean(x):
    """Mean over every axis but the leading batch axis -> ``(B,)``."""
    return x.flatten(1).mean(dim=1)


def rmse_rows(a, b):
    """RMSE of each row of ``a`` against ``b`` (broadcast) -> ``(B,)``."""
    return torch.sqrt(_bmean((a - b) ** 2))


def criterion_batched(models, xx, target_mel, target_semvec, *, objective,
                      log_semantics=False, tube_keep_masks=None):
    """Weighted planning loss of each utterance of the batch ``xx (B, T,
    30)`` against ``target_mel (B, F, 60)`` and ``target_semvec (B, 300)``
    (``paule_tpu/planning/engine.py:165-247``).  Each model runs once at
    batch B, and every reduction is per utterance, so row b is the loss of
    utterance b alone and the gradient of ``total.sum()`` holds B
    independent gradients.  -> ``(total (B,), (SubLosses of (B,) tensors,
    pred_mel, pred_semvec or None))``.

    The mel loss is always computed and logged, but enters the total only
    for ``"acoustic"`` and ``"acoustic_semvec"``; the embedder runs for
    ``"semvec"`` and ``"acoustic_semvec"``, whose totals take its loss, or
    with ``log_semantics``.  With a speech classifier, its BCE against the
    "speech" label enters the total.  With the somatosensory models, the
    tube->mel loss of the predicted tube and the tube embedder's semvec
    loss enter the total under every objective (the JAX package's repair
    of the reference, ``paule_tpu/planning/engine.py:27-30``); the tube
    embedder runs in train mode, its dropout masks drawn from
    ``models.tube_generator`` or given as ``tube_keep_masks``."""
    if objective not in OBJECTIVES:
        raise ValueError(f"objective must be one of {OBJECTIVES}, got "
                         f"{objective!r}")
    pred_mel = models.pred_model(xx)
    mel_w = MEL_WEIGHT * rmse_rows(pred_mel, target_mel)
    vel, _acc, jerk = vel_acc_jerk(xx)
    vel_w = VELOCITY_WEIGHT * _bmean(vel ** 2)
    jerk_w = JERK_WEIGHT * _bmean(jerk ** 2)
    ll_w = LOCAL_LINEAR_WEIGHT * _bmean(local_linear(xx) ** 2)
    total = vel_w + jerk_w + ll_w
    if objective != "semvec":
        total = total + mel_w
    zero = torch.zeros_like(total)
    sem_w = sc_w = tmel_w = tsem_w = zero
    pred_semvec = None
    if objective != "acoustic" or log_semantics:
        pred_semvec = models.embedder(pred_mel)
        sem_w = SEMANTIC_WEIGHT * rmse_rows(pred_semvec, target_semvec)
        if objective != "acoustic":
            total = total + sem_w
    if models.speech_classifier is not None:
        logits = models.speech_classifier(pred_mel)[:, None]
        sc_w = SPEECH_CLASSIFIER_WEIGHT * L.bce_with_logits(
            logits, torch.zeros_like(logits), dim=1)
        total = total + sc_w
    if models.cp_tube_model is not None:
        pred_tube = models.cp_tube_model(xx)
        pred_tube_mel = models.tube_mel_model(pred_tube)
        tmel_w = TUBE_MEL_WEIGHT * rmse_rows(pred_tube_mel, target_mel)
        models.tube_embedder.train()
        try:
            pred_tube_semvec = models.tube_embedder(
                pred_tube, generator=models.tube_generator,
                keep_masks=tube_keep_masks)
        finally:
            models.tube_embedder.eval()
        tsem_w = TUBE_SEMANTIC_WEIGHT * rmse_rows(pred_tube_semvec,
                                               target_semvec)
        total = total + tsem_w + tmel_w
    subs = SubLosses(total, mel_w, sem_w, vel_w, jerk_w, ll_w, sc_w, tmel_w,
                     tsem_w)
    return total, (subs, pred_mel, pred_semvec)


def criterion(models, xx, target_mel, target_semvec, *, objective,
              tube_keep_masks=None):
    """:func:`criterion_batched` of the one trajectory ``xx (1, T, 30)``,
    the embedder run only when the objective needs it (the semantics are
    logged after the segment).  -> ``(total, (SubLosses, pred_mel,
    pred_semvec or None))``, the losses scalars."""
    total, (subs, pred_mel, pred_semvec) = criterion_batched(
        models, xx, target_mel, target_semvec, objective=objective,
        tube_keep_masks=tube_keep_masks)
    return total[0], (SubLosses(*(s[0] for s in subs)), pred_mel,
                      pred_semvec)


def apply_constraints(xx, xx_init, cons: Constraints):
    """Clamp to +-``cons.clamp``, pin LP=-1 and HY=1 when smiling, and
    restore the first ``past_len`` frames; in place, without grad."""
    with torch.no_grad():
        xx.clamp_(-cons.clamp, cons.clamp)
        if cons.smiling:
            xx[..., 4] = -1.0
            xx[..., 1] = 1.0
        if cons.past_len > 0:
            xx[:, :cons.past_len, :] = xx_init[:, :cons.past_len, :]


def make_optimizer(xx, lr):
    """Adam on the trajectory leaf, with ``optax.adam(lr)``'s settings."""
    return torch.optim.Adam([xx], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def embed_logged(models, pred_mel):
    """The embedder's semvecs ``(L, 1, 300)`` of logged mels ``(L, 1, F,
    60)``, in one batch, for semantics that are only logged."""
    with torch.no_grad():
        flat = pred_mel.reshape((-1,) + pred_mel.shape[2:])
        return models.embedder(flat).reshape(pred_mel.shape[:2] + (-1,))


def plan_segment(models, xx, optimizer, target_mel, target_semvec, *,
                 n_steps, objective, log_semantics, constraints,
                 log_every=None, xx_start=None):
    """Run ``n_steps`` planning updates on the leaf ``xx`` in place.

    The constraints restore the ``past_len`` leading frames of ``xx_start``
    (default: ``xx`` at the segment's start); a segment that continues an
    outer iteration passes the trajectory at the iteration's start, as
    ``paule_tpu/planning/engine.py`` ``plan_segment_keys`` does.

    Returns the logs of the logged steps (indices ``k-1, 2k-1, ...`` for
    ``log_every=k``; every step for ``None``) as device tensors:
    ``sub_losses`` (a :class:`SubLosses` of ``(L,)`` tensors), ``xx_pre``
    ``(L, 1, T, 30)``, ``pred_mel``, ``pred_semvec`` (``None`` when no
    semantics are logged), ``grads``, ``grad_max`` and ``grad_min``."""
    log_every = log_every or 1
    n_logged = n_steps // log_every
    xx_init = xx.detach().clone() if xx_start is None else xx_start
    rec = {k: [] for k in ("subs", "xx_pre", "pred_mel", "pred_semvec",
                           "grads")}
    for step in range(n_steps):
        optimizer.zero_grad(set_to_none=True)
        total, (subs, pred_mel, pred_semvec) = criterion(
            models, xx, target_mel, target_semvec, objective=objective)
        total.backward()
        if (step + 1) % log_every == 0 and step < n_logged * log_every:
            rec["subs"].append(torch.stack([s.detach() for s in subs]))
            rec["xx_pre"].append(xx.detach().clone())
            rec["pred_mel"].append(pred_mel.detach())
            if pred_semvec is not None:
                rec["pred_semvec"].append(pred_semvec.detach())
            rec["grads"].append(xx.grad.detach().clone())
        optimizer.step()
        apply_constraints(xx, xx_init, constraints)

    subs = torch.stack(rec["subs"], dim=1)  # (n_fields, L)
    grads = torch.stack(rec["grads"])
    pred_mel = torch.stack(rec["pred_mel"])  # (L, 1, T_mel, 60)
    if rec["pred_semvec"]:
        pred_semvec = torch.stack(rec["pred_semvec"])
    elif log_semantics:
        # the embedder only logs here: run it once on the logged mels
        pred_semvec = embed_logged(models, pred_mel)
    else:
        pred_semvec = None
    return {"sub_losses": SubLosses(*subs), "xx_pre": torch.stack(
                rec["xx_pre"]), "pred_mel": pred_mel,
            "pred_semvec": pred_semvec, "grads": grads,
            "grad_max": grads.flatten(1).amax(dim=1),
            "grad_min": grads.flatten(1).amin(dim=1)}
