"""Sample-rate conversion matching librosa's ``kaiser_best`` path (resampy's
band-limited sinc interpolation), on the host in numpy.  The port's own
copy of ``paule_tpu/dsp/resample.py:28-149`` (time register ``t / ratio``):
64 zero crossings, 512 filter samples per crossing, Kaiser window
``beta = 14.769656459379492``, rolloff ``0.9475937167399596``, linear
interpolation between table samples, output length fixed to
``ceil(n * ratio)``."""

import functools
import math

import numpy as np
from scipy import special as _special

KAISER_BEST_BETA = 14.769656459379492
KAISER_BEST_ROLLOFF = 0.9475937167399596
NUM_ZEROS = 64
PRECISION_BITS = 9

_BLOCK = 65536  # output samples per vectorised block (bounds temporaries)


@functools.lru_cache(maxsize=1)
def kaiser_best_window():
    """Right half of the kaiser_best interpolation filter."""
    num_bits = 2 ** PRECISION_BITS
    n = num_bits * NUM_ZEROS
    x = np.arange(n + 1, dtype=np.float64) / num_bits
    sinc_part = KAISER_BEST_ROLLOFF * np.sinc(KAISER_BEST_ROLLOFF * x)
    arg = 1.0 - (np.arange(n + 1, dtype=np.float64) / n) ** 2
    taper = _special.i0(KAISER_BEST_BETA * np.sqrt(np.maximum(arg, 0.0)))
    taper /= _special.i0(KAISER_BEST_BETA)
    return sinc_part * taper


def _resample_kaiser_best(x, sr_orig, sr_new):
    x = np.asarray(x, dtype=np.float64)
    ratio = float(sr_new) / float(sr_orig)
    n_orig = x.shape[0]
    n_out = int(n_orig * ratio)

    interp_win = kaiser_best_window()
    if ratio < 1.0:
        interp_win = ratio * interp_win
    interp_delta = np.zeros_like(interp_win)
    interp_delta[:-1] = np.diff(interp_win)

    num_table = 2 ** PRECISION_BITS
    scale = min(1.0, ratio)
    index_step = int(scale * num_table)
    nwin = interp_win.shape[0]
    max_wing = nwin // max(index_step, 1) + 1

    y = np.zeros(n_out, dtype=np.float64)
    taps = np.arange(max_wing)

    def wing(off, eta, bound, x_idx):
        win_idx = off[:, None] + taps[None, :] * index_step
        valid = taps[None, :] < bound[:, None]
        win_idx = np.where(valid, win_idx, 0)
        w = interp_win[win_idx] + eta[:, None] * interp_delta[win_idx]
        xs = x[np.clip(x_idx, 0, n_orig - 1)]
        return np.where(valid, w * xs, 0.0).sum(axis=1)

    for start in range(0, n_out, _BLOCK):
        t = np.arange(start, min(start + _BLOCK, n_out))
        time_register = t / ratio
        n = time_register.astype(np.int64)

        frac = scale * (time_register - n)
        index_frac = frac * num_table
        off = index_frac.astype(np.int64)
        eta = index_frac - off
        i_max = np.minimum(n + 1, (nwin - off) // index_step)
        y[t] = wing(off, eta, i_max, n[:, None] - taps[None, :])

        frac = scale - frac
        index_frac = frac * num_table
        off = index_frac.astype(np.int64)
        eta = index_frac - off
        k_max = np.minimum(n_orig - n - 1, (nwin - off) // index_step)
        y[t] += wing(off, eta, k_max, n[:, None] + 1 + taps[None, :])
    return y


def resample(wav, orig_sr, target_sr):
    """``librosa.resample(res_type='kaiser_best', fix=True, scale=False)``."""
    if orig_sr == target_sr:
        return np.asarray(wav, dtype=np.float64)
    out = _resample_kaiser_best(wav, orig_sr, target_sr)
    n_fixed = int(math.ceil(len(wav) * float(target_sr) / float(orig_sr)))
    if len(out) > n_fixed:
        return out[:n_fixed]
    return np.pad(out, (0, n_fixed - len(out)))
