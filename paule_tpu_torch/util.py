"""The reference's ``paule.util`` surface over the port (counterpart of
``paule_tpu/util.py``), so that code written against it ports by changing
one import.  The names re-export the port's own modules; new code should
import from :mod:`paule_tpu_torch.ops`, :mod:`paule_tpu_torch.dsp` and
:mod:`paule_tpu_torch.synth` directly.

Tensor functions take and give torch tensors; the device-bound DSP
helpers (:func:`librosa_melspec`, :func:`mel_to_sig`) run on the card
unless given ``device="cpu"``.
"""

import io
import os
import shutil
import zipfile

import numpy as np
import torch

# --- normalisation tables and functions
from .ops.normalize import (  # noqa: F401
    MAX_AREA as max_area, MAX_INCISOR as max_incisor,
    MAX_TONGUE as max_tongue, MAX_VELUM as max_velum,
    MIN_AREA as min_area, MIN_INCISOR as min_incisor,
    MIN_TONGUE as min_tongue, MIN_VELUM as min_velum,
    cp_theoretical_means, cp_theoretical_stds, inv_normalize_cp,
    inv_normalize_mel, inv_normalize_tube, mel_mean, mel_std, normalize_cp,
    normalize_mel, normalize_tube, tube_maxs, tube_mins,
    tube_theoretical_means, tube_theoretical_stds,
)
# --- DSP
from .dsp import griffinlim as _griffinlim
from .dsp import mel as _mel
from .dsp.audio import stereo_to_mono  # noqa: F401
# --- synthesizer
from .synth import (  # noqa: F401
    ARTICULATOR, cps_to_ema, cps_to_ema_and_mesh, export_svgs,
    get_area_info_within_oral_cavity, ges_to_cps, read_cp, seg_to_cps,
    speak, speak_and_extract_tube_information,
)
from .synth import build as _synth_build
# --- plotting
from .visualize import plot_cp, plot_mel  # noqa: F401
# --- losses and derivatives
from .ops.losses import cp_trajectory_loss, velocity_jerk_loss  # noqa: F401
from .ops.derivatives import (  # noqa: F401
    five_point_stencil as calculate_five_point_stencil_without_padding,
    local_linear, vel_acc_jerk as get_vel_acc_jerk,
)

#: the reference's training-corpus statistics, kept for the surface
#: (planning normalises with the theoretical values)
cp_means = np.array([
    0.53, -5.08, -0.03, -3.73, 0.07, 0.73, 0.48, -0.05, 0.96, -1.58,
    4.46, -0.93, 2.99, -0.05, -1.46, -2.29, 0.23, 0.12, 0.12, 107.2,
    4192.9, 0.03, 0.03, 0.06, 1.22, 0.84, 0.05, 0.0, 25.0, -10.0,
], dtype=np.float64)
cp_stds = np.array([
    0.17, 0.40, 0.04, 0.63, 0.12, 0.22, 0.22, 0.09, 0.49, 0.31,
    0.38, 0.37, 0.35, 0.35, 0.46, 0.38, 0.06, 0.10, 0.18, 9.86,
    3290.25, 0.02, 0.02, 0.01, 0.001, 0.20, 0.001, 0.001, 0.001, 0.001,
], dtype=np.float64)
#: tube section length bounds (cm)
min_length, max_length = 0.23962031463970312, 0.6217119410833707

mel_mean_librosa = mel_mean
mel_std_librosa = mel_std
normalize_mel_librosa = normalize_mel
inv_normalize_mel_librosa = inv_normalize_mel


def librosa_melspec(wav, sample_rate, *, device="cuda", dtype=torch.float32):
    """Normalisation-free log-mel ``(frames, 60)`` of a signal (float64
    numpy), featurised on ``device``."""
    return _mel.librosa_melspec(wav, sample_rate, device=device, dtype=dtype)


def mel_to_sig(mel, *, mel_min=0.0, device="cuda", dtype=torch.float32):
    """Griffin-Lim of a normalised log-mel -> ``(signal, 44100)``."""
    return _griffinlim.mel_to_sig(mel, mel_min=mel_min, device=device,
                                  dtype=dtype)


# --- padding and batching (host numpy)

def audio_padding(sig, samplerate, winlen=0.010):
    """Zero-pad half a window length on each side."""
    pad = int(np.ceil(samplerate * winlen) / 2)
    z = np.zeros(pad)
    return np.concatenate((z, sig, z))


def pad_same_to_even_seq_length(seq):
    """Repeat the last row of an odd-length ``(T, C)`` array."""
    if seq.shape[0] % 2 == 0:
        return seq
    return np.concatenate((seq, seq[-1:, :]), axis=0)


def half_seq_by_average_pooling(seq):
    """``(T, C) -> (ceil(T/2), C)`` by averaging pairs of rows."""
    if len(seq) % 2:
        seq = pad_same_to_even_seq_length(seq)
    return (seq[::2, :] + seq[1::2, :]) / 2


def add_and_pad(xx, max_len, with_onset_dim=False):
    """Pad a ``(T, C)`` array to ``max_len`` rows by repeating its last row;
    ``with_onset_dim`` appends a channel marking the first row."""
    xx = np.asarray(xx)
    seq_length = xx.shape[0]
    if with_onset_dim:
        onset = np.zeros((seq_length, 1), dtype=xx.dtype)
        onset[0, 0] = 1
        xx = np.concatenate((xx, onset), axis=1)
    if max_len < seq_length:
        raise ValueError(f"max_len {max_len} < sequence length {seq_length}")
    if max_len > seq_length:
        reps = (max_len - seq_length,) + (1,) * (xx.ndim - 1)
        xx = np.concatenate((xx, np.tile(xx[-1:], reps)), axis=0)
    return xx


def pad_batch(lens, sequences, with_onset_dim=False, dtype=None):
    """Stack ``(T_i, C)`` arrays into one ``(B, max(lens), C)`` array, each
    padded by :func:`add_and_pad`."""
    max_len = int(max(int(n) for n in lens))
    out = np.stack([add_and_pad(x, max_len, with_onset_dim=with_onset_dim)
                    for x in sequences])
    return out if dtype is None else out.astype(dtype)


pad_batch_online = pad_batch


class RMSELoss:
    """``sqrt(MSE + eps)`` of two tensors, callable as the reference's torch
    module."""

    def __init__(self, eps=1e-6):
        self.eps = eps

    def __call__(self, y_hat, y):
        return torch.sqrt(torch.mean((torch.as_tensor(y_hat)
                                      - torch.as_tensor(y)) ** 2) + self.eps)


rmse_loss = RMSELoss(eps=0)


def numeric_derivative(xx, *, delta_t=1.0):
    return calculate_five_point_stencil_without_padding(xx, delta_t=delta_t)


def array_to_tensor(array):
    """A copy of ``array`` as a tensor with a leading batch axis."""
    return torch.from_numpy(np.array(array))[None]


DIR = os.path.dirname(os.path.abspath(__file__))

#: where the reference's pretrained weights are unpacked, for
#: ``Paule(pretrained_dir=PRETRAINED_DIR)``
PRETRAINED_DIR = os.path.join(DIR, "pretrained_models")

#: the reference's pretrained-weights distribution (torch state dicts)
REFERENCE_WEIGHTS_URL = (
    "https://nc.mlcloud.uni-tuebingen.de/index.php/s/N4nik8wgxwQHP83/download")


def download_pretrained_weights(*, skip_if_exists=True, verbose=True,
                                url=REFERENCE_WEIGHTS_URL):
    """Download the reference's pretrained torch weights (~200 MB) and
    unpack them into :data:`PRETRAINED_DIR`; -> that path, or ``None`` when
    the download fails (offline), after saying so."""
    if os.path.isdir(PRETRAINED_DIR):
        if skip_if_exists:
            if verbose:
                print(f"pretrained_models exist already. Skip download. "
                      f"Path is {PRETRAINED_DIR}")
                print(f'Version of pretrained weights is '
                      f'"{get_pretrained_weights_version()}"')
            return PRETRAINED_DIR
        shutil.rmtree(PRETRAINED_DIR)
    try:
        from urllib.request import urlopen

        if verbose:
            print(f"downloading ~200 MB of pretrained weights from {url}")
        with urlopen(url, timeout=60) as resp:
            payload = resp.read()
        zipfile.ZipFile(io.BytesIO(payload)).extractall(DIR)
        if verbose:
            print(f'Version of pretrained weights is '
                  f'"{get_pretrained_weights_version()}"')
        return PRETRAINED_DIR
    except Exception as exc:  # noqa: BLE001  (offline: say so, go on)
        print(f"could not download pretrained weights ({exc}); "
              f"running with randomly initialized models. Place the "
              f"reference's pretrained_models/ directory at "
              f"{PRETRAINED_DIR} to enable conversion.")
        return None


def get_pretrained_weights_version():
    version_path = os.path.join(PRETRAINED_DIR, "version.txt")
    if not os.path.exists(version_path):
        return f"<No version file found at {version_path}>"
    with open(version_path, "rt") as vfile:
        return vfile.read().strip()


#: the default speaker file (read in place)
SPEAKER_FILE_NAME = os.path.join(os.path.dirname(_synth_build.CSRC),
                                 "speaker", "default.speaker")
FAILURE = 0  # the default instance's initialisation error code


def __getattr__(name):
    # the reference initialises its library at import; here at first use
    if name == "VTL":
        from . import synth

        return synth._default()
    if name == "VERSION":
        from . import synth

        return synth.version()
    raise AttributeError(name)
