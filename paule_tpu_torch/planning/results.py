"""Result containers, field-compatible with
``paule_tpu/planning/results.py``."""

from collections import namedtuple

PlanningResults = namedtuple(
    "PlanningResults",
    "planned_cp, initial_cp, initial_sig, initial_sr, initial_prod_mel,"
    "initial_pred_mel, target_sig, target_sr, target_mel, prod_sig, prod_sr,"
    " prod_mel, pred_mel, initial_prod_semvec, initial_pred_semvec,"
    " prod_semvec, pred_semvec, prod_loss_steps, planned_loss_steps,"
    " planned_mel_loss_steps, vel_loss_steps, jerk_loss_steps,"
    " pred_semvec_loss_steps, prod_semvec_loss_steps, cp_steps,"
    " pred_semvec_steps, prod_semvec_steps, grad_steps, sig_steps,"
    " prod_mel_steps, pred_mel_steps, pred_model_loss, inv_model_loss")

BestSynthesisAcoustic = namedtuple(
    "BestSynthesisAcoustic",
    "mel_loss, planned_cp, prod_sig, prod_mel, pred_mel")
BestSynthesisSemantic = namedtuple(
    "BestSynthesisSemantic",
    "semvec_loss, planned_cp, prod_sig, prod_semvec, pred_semvec")
