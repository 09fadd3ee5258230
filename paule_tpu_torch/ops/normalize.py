"""Normalisation of control parameters (cp), tube features and log-mel
spectrograms.

The port's own copy of the tables of ``paule_tpu/ops/normalize.py``: cp are
normalised to roughly +-1 with the speaker's theoretical parameter ranges,
``norm = (cp - mid) / halfrange``, and the 10 tube features (7 oral-cavity
areas, incisor position, tongue-tip side elevation, velum opening) the same
way with their ranges (``:113-159``); log-mels are anchored to the dB value
of silence under ``amplitude_to_db(0.0, ref=0.15, amin=1e-5)``.

Functions take numpy arrays or torch tensors and return the same kind.
"""

import math

import numpy as np
import torch

N_TRACT = 19
N_GLOTTIS = 11
N_CP = N_TRACT + N_GLOTTIS

#: (min, max) per parameter: 19 vocal-tract parameters
#: HX HY JX JA LP LD VS VO TCX TCY TTX TTY TBX TBY TRX TRY TS1 TS2 TS3,
#: then 11 geometric-glottis parameters F0 PR XB XT CA LAG RA DP PS FL AS
CP_RANGES = np.array([
    (0.0, 1.0), (-6.0, -3.5), (-0.5, 0.0), (-7.0, 0.0), (-1.0, 1.0),
    (-2.0, 4.0), (0.0, 1.0), (-0.1, 1.0), (-3.0, 4.0), (-3.0, 1.0),
    (1.5, 5.5), (-3.0, 2.5), (-3.0, 4.0), (-3.0, 5.0), (-4.0, 2.0),
    (-6.0, 0.0), (0.0, 1.0), (0.0, 1.0), (-1.0, 1.0),
    (40.0, 600.0), (0.0, 20000.0), (-0.05, 0.30), (-0.05, 0.30),
    (-0.25, 0.25), (0.0, 3.1415), (-1.0, 1.0), (0.0, 1.0), (-0.5, 0.5),
    (0.0, 100.0), (-40.0, 0.0),
], dtype=np.float64)

cp_theoretical_means = (CP_RANGES[:, 0] + CP_RANGES[:, 1]) / 2.0
cp_theoretical_stds = (CP_RANGES[:, 1] - CP_RANGES[:, 0]) / 2.0

MIN_AREA, MAX_AREA = 0.0, 15.0
MIN_INCISOR, MAX_INCISOR = 14.0, 18.0
MIN_TONGUE, MAX_TONGUE = -1.0, 1.0
MIN_VELUM, MAX_VELUM = 0.0, 1.0
N_TUBE = 10

tube_mins = np.concatenate([
    np.repeat(MIN_AREA, 7), [MIN_INCISOR], [MIN_TONGUE], [MIN_VELUM]])
tube_maxs = np.concatenate([
    np.repeat(MAX_AREA, 7), [MAX_INCISOR], [MAX_TONGUE], [MAX_VELUM]])
tube_theoretical_means = (tube_mins + tube_maxs) / 2.0
tube_theoretical_stds = (tube_maxs - tube_mins) / 2.0

MEL_AMIN = 1e-5
MEL_DB_REF = 0.15
mel_mean = 20.0 * math.log10(MEL_AMIN) - 20.0 * math.log10(MEL_DB_REF)
mel_std = abs(mel_mean)


def _like(x, table):
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(table, dtype=x.dtype, device=x.device)
    return np.asarray(table, dtype=getattr(x, "dtype", np.float64))


def normalize_cp(cp):
    return (cp - _like(cp, cp_theoretical_means)) / _like(
        cp, cp_theoretical_stds)


def inv_normalize_cp(norm_cp):
    return (_like(norm_cp, cp_theoretical_stds) * norm_cp
            + _like(norm_cp, cp_theoretical_means))


def normalize_tube(tube):
    return (tube - _like(tube, tube_theoretical_means)) / _like(
        tube, tube_theoretical_stds)


def inv_normalize_tube(norm_tube):
    return (norm_tube * _like(norm_tube, tube_theoretical_stds)
            + _like(norm_tube, tube_theoretical_means))


def normalize_mel(mel):
    return (mel - mel_mean) / mel_std


def inv_normalize_mel(norm_mel):
    return mel_std * norm_mel + mel_mean
