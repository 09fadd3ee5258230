"""Mel-spectrogram inversion, mel -> audio (counterpart of
``paule_tpu/dsp/griffinlim.py:30-116``).

1. The mel filterbank is inverted to a linear amplitude spectrogram by a
   regularised least-squares pseudo-inverse, clipped at 0 (numpy, float64).
2. Griffin-Lim phase reconstruction on the device: 32 iterations with
   momentum 0.99, each an inverse STFT (``torch.fft.irfft`` and an
   overlap-add, normalised by the precomputed sum of the squared window)
   and an STFT (``torch.fft.rfft``), both with the periodic Hann window.
   The overlap-add gathers each sample's (at most ``ceil(N_FFT / HOP)``)
   frame contributions and sums them in frame order, without atomics, so
   that it is bit-reproducible on the card and sums in the order of a
   sequential scatter-add on the CPU.
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


#: the most frames that overlap one sample
N_OVERLAP = -(-N_FFT // HOP)


@functools.lru_cache(maxsize=8)
def _overlap_index(frames):
    """``(total, N_OVERLAP)`` positions in the flattened ``(frames, N_FFT)``
    frames of each output sample's contributions, in frame order; missing
    ones point at ``frames * N_FFT``, one past the end (a zero)."""
    n = np.arange(HOP * (frames - 1) + N_FFT)[:, None]
    f = np.maximum(0, (n - N_FFT + HOP) // HOP) + np.arange(N_OVERLAP)
    valid = (f * HOP <= n) & (f < frames)
    return np.where(valid, f * N_FFT + n - f * HOP, frames * N_FFT)


class _Istft:
    """Inverse STFT of ``frames`` frames, cut to ``length`` samples, with
    its window, overlap-add index and normaliser on the device."""

    def __init__(self, frames, length, dtype, device):
        self.length = length
        self.win = torch.as_tensor(_hann_periodic(), dtype=dtype,
                                   device=device)
        self.idx = torch.as_tensor(_overlap_index(frames), device=device)
        self.wss = torch.as_tensor(_window_sum(frames), dtype=dtype,
                                   device=device)

    def __call__(self, spec):
        time_frames = torch.fft.irfft(spec, N_FFT, dim=-1) * self.win
        flat = torch.cat([time_frames.reshape(-1),
                          time_frames.new_zeros(1)])
        parts = flat[self.idx]
        # 0 + the first + the second ..., as a scatter-add from zeros
        y = torch.zeros_like(parts[:, 0])
        for j in range(N_OVERLAP):
            y = y + parts[:, j]
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


def mel_amplitude_to_audio(amplitude, *, device, dtype):
    """Amplitude mel ``(frames, 60)`` (numpy) -> float64 numpy signal of
    ``220 * (frames - 1)`` samples: steps 1 and 2 of the module
    docstring, Griffin-Lim on ``device`` in ``dtype``."""
    lin = np.maximum(np.asarray(amplitude, dtype=np.float64) @ _mel_pinv(),
                     0.0)  # (frames, n_bins)
    length = HOP * (lin.shape[0] - 1)
    sig = griffin_lim(torch.as_tensor(lin, dtype=dtype, device=device),
                      length=length)
    return sig.cpu().numpy().astype(np.float64)


def mel_to_sig(mel, *, device, dtype, mel_min=0.0):
    """Normalised log-mel ``(frames, 60)`` (numpy or a tensor) ->
    ``(signal, 44100)``, the signal float64 numpy of ``220 * (frames - 1) +
    110`` samples; Griffin-Lim runs on ``device`` in ``dtype``."""
    if torch.is_tensor(mel):
        mel = mel.detach().cpu().numpy()
    mel = np.asarray(mel, dtype=np.float64) + mel_min
    amplitude = 10.0 ** (inv_normalize_mel(mel) / 20.0) * DB_REF
    sig = mel_amplitude_to_audio(amplitude, device=device, dtype=dtype)
    return np.concatenate([np.zeros(55), sig, np.zeros(55)]), SR
