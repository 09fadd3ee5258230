"""Target acoustics for planning (counterpart of
``paule_tpu/dsp/targets.py:17-31``): the TARGET mel is shifted so that its
minimum is 0; produced mels stay unshifted."""

import numpy as np

from .mel import librosa_melspec
from ..ops.normalize import normalize_mel


def normalized_target_mel(sig, sr, *, device, dtype):
    """Audio signal -> normalised log-mel with the target min-shift."""
    mel = normalize_mel(librosa_melspec(sig, sr, device=device, dtype=dtype))
    return mel - mel.min()


def audio_target_to_mel(target, *, device, dtype):
    """``(sig, sr)`` -> ``(sig, sr, target_mel)``."""
    if isinstance(target, str):
        raise NotImplementedError(
            "audio-file targets (paule_tpu/dsp/audio.py) are not ported yet "
            "(ROADMAP.md, 'Modules to port', item 4); pass (sig, sr)")
    sig, sr = target
    sig = np.asarray(sig, dtype=np.float64)
    if sig.ndim == 2:
        sig = sig.mean(axis=1)
    return sig, sr, normalized_target_mel(sig, sr, device=device, dtype=dtype)
