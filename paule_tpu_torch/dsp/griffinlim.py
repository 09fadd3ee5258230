"""Mel-spectrogram inversion, mel -> audio (counterpart of
``paule_tpu/dsp/griffinlim.py:30-116``).

1. The mel filterbank is inverted to a linear amplitude spectrogram by a
   regularised least-squares pseudo-inverse, clipped at 0 (numpy, float64).
2. Griffin-Lim phase reconstruction on the device: 32 iterations with
   momentum 0.99, each an inverse STFT (``torch.fft.irfft`` and an
   overlap-add by ``index_add_``, normalised by the precomputed sum of the
   squared window) and an STFT (``torch.fft.rfft``), both with the periodic
   Hann window.
3. 55 zero samples on each side, so that ``frames`` mel frames give
   ``220 * (frames - 1) + 110`` samples, the length the synthesizer gives
   for a trajectory of ``2 * frames`` cp frames.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .mel import DB_REF, HOP, N_FFT, SR, _hann_periodic, mel_filterbank
from ..ops.normalize import inv_normalize_mel

N_ITER = 32
MOMENTUM = 0.99


@functools.lru_cache(maxsize=1)
def _mel_pinv():
    """Regularised pseudo-inverse of the mel filterbank, ``(n_mels,
    n_bins)``."""
    fb = mel_filterbank()  # (n_bins, n_mels)
    gram = fb.T @ fb
    gram += 1e-8 * np.eye(gram.shape[0])
    return np.linalg.solve(gram, fb.T)


@functools.lru_cache(maxsize=8)
def _window_sum(frames):
    """Overlap-added squared window of ``frames`` frames, with 1 where it
    vanishes (float64)."""
    total = HOP * (frames - 1) + N_FFT
    wss = np.zeros(total)
    idx = np.arange(frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
    np.add.at(wss, idx.reshape(-1), np.tile(_hann_periodic() ** 2, frames))
    return np.where(wss > 1e-10, wss, 1.0)


class _Istft:
    """Inverse STFT of ``frames`` frames, cut to ``length`` samples, with
    its window, overlap-add index and normaliser on the device."""

    def __init__(self, frames, length, dtype, device):
        self.length = length
        self.total = HOP * (frames - 1) + N_FFT
        self.win = torch.as_tensor(_hann_periodic(), dtype=dtype,
                                   device=device)
        self.idx = (torch.arange(frames, device=device)[:, None] * HOP
                    + torch.arange(N_FFT, device=device)[None, :]).reshape(-1)
        self.wss = torch.as_tensor(_window_sum(frames), dtype=dtype,
                                   device=device)

    def __call__(self, spec):
        time_frames = torch.fft.irfft(spec, N_FFT, dim=-1) * self.win
        y = torch.zeros(self.total, dtype=self.win.dtype,
                        device=self.win.device)
        y.index_add_(0, self.idx, time_frames.reshape(-1))
        pad = N_FFT // 2
        return (y / self.wss)[pad:pad + self.length]


def _stft(y, win):
    pad = N_FFT // 2
    frames = F.pad(y[None], (pad, pad))[0].unfold(0, N_FFT, HOP)
    return torch.fft.rfft(frames * win, dim=-1)


def griffin_lim(mag, *, n_iter=N_ITER, length=None):
    """Reconstruct a signal from an amplitude spectrogram ``mag (frames,
    n_bins)``, a real tensor, on its device and in its dtype."""
    frames = mag.shape[0]
    if length is None:
        length = HOP * (frames - 1)
    istft = _Istft(frames, length, mag.dtype, mag.device)
    cdtype = torch.complex128 if mag.dtype == torch.float64 else (
        torch.complex64)
    mag_c = mag.to(cdtype)
    angles = torch.ones_like(mag_c)
    rebuilt = torch.zeros_like(mag_c)
    for _ in range(n_iter):
        new_rebuilt = _stft(istft(mag_c * angles), istft.win)
        upd = new_rebuilt - (MOMENTUM / (1.0 + MOMENTUM)) * rebuilt
        angles = upd / torch.clamp(upd.abs(), min=1e-16)
        rebuilt = new_rebuilt
    return istft(mag_c * angles)


def mel_to_sig(mel, *, device, dtype, mel_min=0.0):
    """Normalised log-mel ``(frames, 60)`` (numpy or a tensor) ->
    ``(signal, 44100)``, the signal float64 numpy of ``220 * (frames - 1) +
    110`` samples; Griffin-Lim runs on ``device`` in ``dtype``."""
    if torch.is_tensor(mel):
        mel = mel.detach().cpu().numpy()
    mel = np.asarray(mel, dtype=np.float64) + mel_min
    amplitude = 10.0 ** (inv_normalize_mel(mel) / 20.0) * DB_REF
    lin = np.maximum(amplitude @ _mel_pinv(), 0.0)  # (frames, n_bins)
    length = HOP * (lin.shape[0] - 1)
    sig = griffin_lim(torch.as_tensor(lin, dtype=dtype, device=device),
                      length=length)
    sig = sig.cpu().numpy().astype(np.float64)
    return np.concatenate([np.zeros(55), sig, np.zeros(55)]), SR
