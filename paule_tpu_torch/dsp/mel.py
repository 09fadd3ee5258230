"""Log-mel spectrogram on the device (counterpart of
``paule_tpu/dsp/mel.py:72-171``).

44.1 kHz input; STFT with ``n_fft=1024``, ``hop=220``, periodic Hann window,
centred with zero padding; amplitude mel spectrogram with 60 Slaney-scale,
Slaney-normalised filters from 10 Hz to 12 kHz (:func:`mel_amplitude_44100`,
which the librosa stand-in of :mod:`paule_tpu_torch.reference_bridge`
shares); ``amplitude_to_db`` with ``ref=0.15``, ``amin=1e-5``,
``top_db=80``; frames on the first axis.  The
STFT is a matrix product of the framed signal with the same numpy RFFT
basis the JAX package builds, then one with the filterbank.
"""

import functools
import math

import numpy as np
import torch

from .. import tracing
from .resample import resample

SR = 44100
N_FFT = 1024
HOP = 220
N_MELS = 60
FMIN = 10.0
FMAX = 12000.0
AMIN = 1e-5
DB_REF = 0.15
TOP_DB = 80.0


def hz_to_mel(freq):
    """Slaney mel scale (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(
        freq >= 1000.0,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / 1000.0) / logstep,
        freq / f_sp)


def mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    1000.0 * np.exp(logstep * (mels - min_log_mel)),
                    f_sp * mels)


@functools.lru_cache(maxsize=1)
def mel_filterbank():
    """Triangular Slaney-normalised filterbank, ``(n_bins, n_mels)``."""
    n_bins = 1 + N_FFT // 2
    fft_freqs = np.linspace(0.0, SR / 2.0, n_bins)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(FMIN), hz_to_mel(FMAX),
                                   N_MELS + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:N_MELS + 2] - hz_pts[:N_MELS])).reshape(-1, 1)
    return np.ascontiguousarray(weights.T)


def _hann_periodic(n=N_FFT):
    """The periodic Hann window of ``n`` samples, float64."""
    k = np.arange(n)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


@functools.lru_cache(maxsize=1)
def rfft_basis():
    """Hann-windowed real-DFT basis ``(n_fft, 2*n_bins)``: [cos | -sin]."""
    n_bins = 1 + N_FFT // 2
    t = np.arange(N_FFT).reshape(-1, 1)
    k = np.arange(n_bins).reshape(1, -1)
    ang = 2.0 * np.pi * t * k / N_FFT
    win = _hann_periodic().reshape(-1, 1)
    return np.concatenate([np.cos(ang) * win, -np.sin(ang) * win], axis=1)


def amplitude_to_db(mel, *, ref=DB_REF, amin=AMIN, top_db=TOP_DB,
                    per_item=True):
    """librosa's ``amplitude_to_db(mel, ref, amin, top_db)`` of a
    non-negative tensor (defaults: the reference's 0.15, 1e-5 and 80); the
    top-dB floor taken per item over the last two axes, or with
    ``per_item=False`` over the whole tensor as librosa does; none for
    ``top_db=None``."""
    db = 20.0 * torch.log10(torch.clamp(mel, min=amin)) - 20.0 * math.log10(
        max(ref, amin))
    if top_db is None:
        return db
    peak = db.amax(dim=(-2, -1), keepdim=True) if per_item else db.amax()
    return torch.maximum(db, peak - top_db)


def mel_amplitude_44100(y):
    """44.1 kHz signals ``(..., n)`` (a tensor) -> amplitude mel spectrogram
    ``(..., 1 + n // 220, 60)`` (librosa's ``melspectrogram(power=1.0)``,
    centred with zero padding, frames first) in the signal's dtype and
    device."""
    pad = N_FFT // 2
    frames = torch.nn.functional.pad(y, (pad, pad)).unfold(-1, N_FFT, HOP)
    basis = torch.as_tensor(rfft_basis(), dtype=y.dtype, device=y.device)
    spec = frames @ basis
    n_bins = 1 + N_FFT // 2
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    fb = torch.as_tensor(mel_filterbank(), dtype=y.dtype, device=y.device)
    if tracing.ON:
        tracing.sent(basis)
        tracing.sent(fb)
    return torch.sqrt(re * re + im * im) @ fb


def melspec_44100(y):
    """44.1 kHz signals ``(..., n)`` (a tensor) -> log-mel dB
    ``(..., 1 + n // 220, 60)`` in the signal's dtype and device."""
    return amplitude_to_db(mel_amplitude_44100(y))


def librosa_melspec(wav, sample_rate, *, device, dtype):
    """The reference's ``librosa_melspec``: resample to 44.1 kHz on the host,
    featurise on ``device``; returns float64 numpy ``(frames, 60)``."""
    wav = np.asarray(wav, dtype=np.float64)
    if sample_rate != SR:
        wav = resample(wav, sample_rate, SR)
    y = torch.as_tensor(wav, dtype=dtype, device=device)
    if tracing.ON:
        tracing.sent(y)
    mel = melspec_44100(y)
    if tracing.ON:
        tracing.fetched(mel)
    return mel.cpu().numpy().astype(np.float64)
