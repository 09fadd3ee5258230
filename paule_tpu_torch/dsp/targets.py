"""Target acoustics for planning (counterpart of
``paule_tpu/dsp/targets.py:17-31``): the TARGET mel is shifted so that its
minimum is 0; produced mels stay unshifted."""

import numpy as np

from .audio import read as audio_read, stereo_to_mono
from .mel import librosa_melspec
from ..ops.normalize import normalize_mel


def normalized_target_mel(sig, sr, *, device, dtype):
    """Audio signal -> normalised log-mel with the target min-shift."""
    mel = normalize_mel(librosa_melspec(sig, sr, device=device, dtype=dtype))
    return mel - mel.min()


def audio_target_to_mel(target, *, device, dtype):
    """Audio file path or ``(sig, sr)`` -> ``(sig, sr, target_mel)``."""
    if isinstance(target, str):
        sig, sr = audio_read(target)
    else:
        sig, sr = target
    sig = np.asarray(sig, dtype=np.float64)
    if sig.ndim == 2:
        sig = stereo_to_mono(sig)
    return sig, sr, normalized_target_mel(sig, sr, device=device, dtype=dtype)
