"""Formant estimation from audio by LPC, the autocorrelation method
(counterpart of ``paule_tpu/dsp/formants.py``).

Checks an imported or calibrated speaker acoustically: synthesise a
sustained phone and estimate its F1/F2/F3.  Host numpy, not on any hot
path.

Method: resample to ~10 kHz (our exact kaiser_best resampler), pre-
emphasize, Hamming-window the steady middle of the signal, LPC by
Levinson-Durbin on the autocorrelation, then formants = angles of the
A(z) roots with positive imaginary part, keeping poles with plausible
bandwidth (< ``max_bandwidth_hz``).  Standard speech-analysis practice
(order ~= 2 + sr/1000).
"""

import numpy as np

from .resample import resample


def _levinson(r, order):
    """Levinson-Durbin: autocorrelation r[0..order] -> LPC coeffs a
    (a[0] = 1)."""
    a = np.zeros(order + 1)
    a[0] = 1.0
    err = r[0]
    if err <= 0:
        raise ValueError("degenerate autocorrelation (silent signal?)")
    for i in range(1, order + 1):
        acc = r[i] + np.dot(a[1:i], r[i - 1:0:-1])
        k = -acc / err
        a[1:i + 1] = a[1:i + 1] + k * a[i - 1::-1][:i]
        err *= (1.0 - k * k)
        if err <= 0:
            break
    return a


def lpc_formants(sig, sr, *, n_formants=3, target_sr=10000,
                 max_bandwidth_hz=300.0, fmin=120.0):
    """Estimate the first ``n_formants`` formant frequencies (Hz).

    Returns a list of ``n_formants`` frequencies (padded with NaN when
    fewer plausible poles are found).
    """
    sig = np.asarray(sig, dtype=np.float64)
    if sig.ndim != 1:
        raise ValueError("sig must be 1-D")
    if sr != target_sr:
        sig = resample(sig, sr, target_sr)
        sr = target_sr
    if len(sig) < 256:
        raise ValueError("signal too short for formant analysis")
    # steady middle: drop 20% on each side (onset/offset transients)
    lo, hi = int(0.2 * len(sig)), int(0.8 * len(sig))
    seg = sig[lo:hi]
    seg = np.append(seg[0], seg[1:] - 0.97 * seg[:-1])  # pre-emphasis
    seg = seg * np.hamming(len(seg))

    order = int(2 + sr / 1000)
    r = np.correlate(seg, seg, mode="full")[len(seg) - 1:len(seg) + order]
    a = _levinson(r, order)
    roots = np.roots(a)
    roots = roots[np.imag(roots) > 1e-6]
    freqs = np.angle(roots) * sr / (2 * np.pi)
    bands = -sr / np.pi * np.log(np.abs(roots))
    keep = (freqs > fmin) & (freqs < sr / 2 - 50) & \
           (bands < max_bandwidth_hz)
    fs = np.sort(freqs[keep])
    out = list(fs[:n_formants])
    while len(out) < n_formants:
        out.append(float("nan"))
    return [float(f) for f in out]
