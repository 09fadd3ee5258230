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

PlanningResultsWithSpeechClassifier = namedtuple(
    "PlanningResultsWithSpeechClassifier",
    "planned_cp, initial_cp, initial_sig, initial_sr, initial_prod_mel,"
    " initial_pred_mel, target_sig, target_sr, target_mel, prod_sig, prod_sr,"
    " prod_mel, pred_mel, initial_prod_semvec, initial_pred_semvec,"
    " prod_semvec, pred_semvec, prod_loss_steps, planned_loss_steps,"
    " planned_mel_loss_steps, vel_loss_steps, jerk_loss_steps,"
    " pred_semvec_loss_steps, prod_semvec_loss_steps,"
    " pred_speech_classifier_loss_steps, prod_speech_classifier_loss_steps,"
    " cp_steps, pred_semvec_steps, prod_semvec_steps, grad_steps, sig_steps,"
    " prod_mel_steps, pred_mel_steps, pred_model_loss, inv_model_loss")

PlanningResultsWithSomatosensory = namedtuple(
    "PlanningResultsWithSomatosensory",
    "planned_cp, initial_cp, initial_sig, initial_sr, initial_prod_mel,"
    "initial_pred_mel, initial_prod_tube, initial_pred_tube,"
    " initial_prod_tube_mel, initial_pred_tube_mel, target_sig, target_sr,"
    " target_mel, prod_sig, prod_sr, prod_mel, pred_mel, prod_tube,"
    " pred_tube, prod_tube_mel, pred_tube_mel, initial_prod_semvec,"
    " initial_pred_semvec, initial_prod_tube_semvec,"
    " initial_pred_tube_semvec, prod_semvec, pred_semvec, prod_tube_semvec,"
    " pred_tube_semvec, prod_loss_steps, planned_loss_steps,"
    " planned_mel_loss_steps, vel_loss_steps, jerk_loss_steps,"
    " pred_semvec_loss_steps, prod_semvec_loss_steps, prod_tube_loss_steps,"
    " pred_tube_mel_loss_steps, prod_tube_mel_loss_steps,"
    " pred_tube_semvec_loss_steps, prod_tube_semvec_loss_steps, cp_steps,"
    " pred_semvec_steps, prod_semvec_steps, grad_steps, sig_steps,"
    " prod_mel_steps, pred_mel_steps, prod_tube_steps, pred_tube_steps,"
    " prod_tube_mel_steps, pred_tube_mel_steps, prod_tube_semvec_steps,"
    " pred_tube_semvec_steps, pred_model_loss, inv_model_loss,"
    " tube_model_loss, tube_mel_model_loss")

BestSynthesisAcoustic = namedtuple(
    "BestSynthesisAcoustic",
    "mel_loss, planned_cp, prod_sig, prod_mel, pred_mel")
BestSynthesisSemantic = namedtuple(
    "BestSynthesisSemantic",
    "semvec_loss, planned_cp, prod_sig, prod_semvec, pred_semvec")
BestSynthesisSomatosensory = namedtuple(
    "BestSynthesisSomatosensory",
    "tube_loss, tube_mel_loss, tube_semvec_loss, planned_cp, prod_sig,"
    " prod_tube, pred_tube, prod_tube_mel, pred_tube_mel, prod_tube_semvec,"
    " pred_tube_semvec")
