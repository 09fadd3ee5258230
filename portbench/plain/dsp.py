"""Plain log-mel features of 44.1 kHz audio, as PAULE defines them.

librosa's ``melspectrogram(sr=44100, n_fft=1024, hop_length=220,
n_mels=60, fmin=10, fmax=12000, power=1.0)`` (centred, zero padding,
periodic Hann window, Slaney mel scale and normalisation), then
``amplitude_to_db(ref=0.15, amin=1e-5, top_db=80)`` per utterance, then
PAULE's normalisation ``(db - mean) / std`` with the dB of silence as
``mean``.  A target mel is shifted so that its minimum is 0.

The short-time spectrum is a product of the framed signal with a real DFT
basis, so that a lower matmul precision shows in it.  The filterbank
arithmetic is a frozen copy of ``paule_tpu_torch/dsp/mel.py:30-67``.
"""

import math

import numpy as np
import torch

from .tables import MEL_MEAN, MEL_STD

SR = 44100
N_FFT = 1024
HOP = 220
N_MELS = 60
FMIN = 10.0
FMAX = 12000.0
TOP_DB = 80.0


def _hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    logstep = math.log(6.4) / 27.0
    return np.where(freq >= 1000.0,
                    1000.0 / f_sp + np.log(np.maximum(freq, 1e-10) / 1000.0)
                    / logstep, freq / f_sp)


def _mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    1000.0 * np.exp(logstep * (mels - min_log_mel)),
                    f_sp * mels)


def filterbank():
    """Slaney-normalised triangular filters ``(n_bins, n_mels)``."""
    n_bins = 1 + N_FFT // 2
    fft_freqs = np.linspace(0.0, SR / 2.0, n_bins)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(FMIN), _hz_to_mel(FMAX),
                                N_MELS + 2))
    fdiff = np.diff(hz)
    ramps = hz.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz[2:N_MELS + 2] - hz[:N_MELS])).reshape(-1, 1)
    return np.ascontiguousarray(weights.T)


def dft_basis():
    """Hann-windowed real DFT ``(n_fft, 2 * n_bins)``: [cos | -sin]."""
    n_bins = 1 + N_FFT // 2
    t = np.arange(N_FFT).reshape(-1, 1)
    ang = 2.0 * np.pi * t * np.arange(n_bins).reshape(1, -1) / N_FFT
    win = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1) * win[:, None]


class Mel:
    """Log-mel features on ``device`` in ``dtype``; the basis and the
    filterbank are made once."""

    def __init__(self, device, dtype):
        self.device, self.dtype = device, dtype
        self.basis = torch.as_tensor(dft_basis(), dtype=dtype, device=device)
        self.fb = torch.as_tensor(filterbank(), dtype=dtype, device=device)

    def __call__(self, sigs):
        """Signals ``(B, n)`` (numpy or tensor) -> normalised log-mels
        ``(B, 1 + n // 220, 60)``, unshifted."""
        y = torch.as_tensor(np.asarray(sigs), dtype=self.dtype,
                            device=self.device)
        pad = N_FFT // 2
        frames = torch.nn.functional.pad(y, (pad, pad)).unfold(-1, N_FFT,
                                                                HOP)
        spec = frames @ self.basis
        n_bins = 1 + N_FFT // 2
        mag = torch.sqrt(spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2)
        mel = mag @ self.fb
        db = (20.0 * torch.log10(torch.clamp(mel, min=1e-5))
              - 20.0 * math.log10(0.15))
        db = torch.maximum(db, db.amax(dim=(-2, -1), keepdim=True) - TOP_DB)
        return (db - MEL_MEAN) / MEL_STD

    def target(self, sig):
        """One target signal -> its normalised log-mel ``(F, 60)``,
        shifted so that its minimum is 0."""
        mel = self(np.asarray(sig)[None])[0]
        return mel - mel.min()
