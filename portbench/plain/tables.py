"""Frozen copies of the plain tables and generators the yardstick depends
on.  Later changes to the program do not reach them.

Sources (copied, not imported):
- CP ranges and the cp / tube / mel normalisation:
  ``paule_tpu_torch/ops/normalize.py:22-57`` and ``:60-96``.
- ``seeded_cp``: ``paule_tpu_torch/tools/hot_timing.py:32-37``.
- ``random_cp_trajectory``: ``paule_tpu_torch/pretrain.py:43-53``.
- ``LENGTHS`` and ``corpus_cps``: ``paule_tpu_torch/tools/
  corpus_quality_run.py:45`` and ``:64-71``.
- The planning loss weights: ``paule_tpu_torch/planning/engine.py:27-34``.
"""

import math

import numpy as np

CP_RANGES = np.array([
    (0.0, 1.0), (-6.0, -3.5), (-0.5, 0.0), (-7.0, 0.0), (-1.0, 1.0),
    (-2.0, 4.0), (0.0, 1.0), (-0.1, 1.0), (-3.0, 4.0), (-3.0, 1.0),
    (1.5, 5.5), (-3.0, 2.5), (-3.0, 4.0), (-3.0, 5.0), (-4.0, 2.0),
    (-6.0, 0.0), (0.0, 1.0), (0.0, 1.0), (-1.0, 1.0),
    (40.0, 600.0), (0.0, 20000.0), (-0.05, 0.30), (-0.05, 0.30),
    (-0.25, 0.25), (0.0, 3.1415), (-1.0, 1.0), (0.0, 1.0), (-0.5, 0.5),
    (0.0, 100.0), (-40.0, 0.0),
], dtype=np.float64)
CP_MEANS = (CP_RANGES[:, 0] + CP_RANGES[:, 1]) / 2.0
CP_STDS = (CP_RANGES[:, 1] - CP_RANGES[:, 0]) / 2.0
N_TRACT = 19

TUBE_MINS = np.concatenate([np.repeat(0.0, 7), [14.0], [-1.0], [0.0]])
TUBE_MAXS = np.concatenate([np.repeat(15.0, 7), [18.0], [1.0], [1.0]])
TUBE_MEANS = (TUBE_MINS + TUBE_MAXS) / 2.0
TUBE_STDS = (TUBE_MAXS - TUBE_MINS) / 2.0

MEL_AMIN = 1e-5
MEL_DB_REF = 0.15
MEL_MEAN = 20.0 * math.log10(MEL_AMIN) - 20.0 * math.log10(MEL_DB_REF)
MEL_STD = abs(MEL_MEAN)

MEL_WEIGHT = 5.0
VELOCITY_WEIGHT = 80.0
JERK_WEIGHT = 400.0
SEMANTIC_WEIGHT = 10.0
LOCAL_LINEAR_WEIGHT = 100_000.0
TUBE_MEL_WEIGHT = MEL_WEIGHT
TUBE_SEMANTIC_WEIGHT = SEMANTIC_WEIGHT

LENGTHS = (80, 120, 160, 200)


def inv_normalize_cp(norm_cp):
    """Normalised cp -> synthesizer units, float64, in the program's order
    of operations (``stds * cp + means``)."""
    return CP_STDS * np.asarray(norm_cp, dtype=np.float64) + CP_MEANS


def normalize_tube(tube):
    return (tube - TUBE_MEANS) / TUBE_STDS


def seeded_cp(n_frames, seed=0):
    """A seeded smooth normalised cp trajectory of ``n_frames + 1``
    frames."""
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(0, 0.05, (n_frames + 1, 30)).cumsum(0) * 0.2,
                   -1, 1)


def random_cp_trajectory(rng, seq_len, *, walk_scale=0.05, smooth=8):
    """A random smooth normalised cp trajectory ``(seq_len, 30)``: a random
    walk, boxcar-smoothed, centred and clipped to [-1, 1]."""
    steps = rng.normal(0.0, walk_scale, (seq_len + smooth, 30))
    walk = np.cumsum(steps, axis=0)
    kernel = np.ones(smooth) / smooth
    sm = np.stack([np.convolve(walk[:, c], kernel, mode="valid")
                   for c in range(walk.shape[1])], axis=1)[:seq_len]
    return np.clip(sm - sm.mean(0, keepdims=True), -1.0, 1.0)


def corpus_cps(n_utt, lengths=LENGTHS, seed=42):
    """Utterance ``i`` of ``lengths[i % len(lengths)]`` frames."""
    rng = np.random.default_rng(seed)
    return [random_cp_trajectory(rng, lengths[i % len(lengths)])
            for i in range(n_utt)]
