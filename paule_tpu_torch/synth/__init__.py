"""ctypes binding of the C++ articulatory synthesizer (the port's own; the
same C ABI as ``paule_tpu/synth/__init__.py``).

:func:`speak` drives the library's default instance; :class:`SynthPool`
holds independent instances, and synthesises a batch of trajectories in
one native call that spreads them over the instances' threads.  The
library is built on first use (:mod:`.build`).
"""

import ctypes
import threading

import numpy as np

from . import build as _build
from ..ops.normalize import N_CP, N_TRACT

FRAME_STEPS = 110  # samples per control frame (2.5 ms at 44.1 kHz)
SAMPLE_RATE = 44100

_lib = None
_lib_lock = threading.Lock()
_initialized = False


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(_build.build())
            p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
            sigs = {
                "pts_create": ([s], p),
                "pts_destroy": ([p], None),
                "pts_initialize": ([s], i),
                "pts_synth_block": ([p, p, i, i, p], i),
                "pts_synth_block_batch": ([p, i, p, p, i, i, i, p, i]
                                          + [p] * 6 + [p], i),
            }
            for name, (args, res) in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
    return _lib


def initialize(speaker_path="default"):
    """(Re)initialise the default instance from a speaker file
    (``"default"`` is the built-in speaker)."""
    global _initialized
    failure = _load().pts_initialize(str(speaker_path).encode())
    if failure != 0:
        raise ValueError(f"pts_initialize failed: error {failure}")
    _initialized = True


def _check_cp(cp_param):
    cp = np.ascontiguousarray(cp_param, dtype=np.float64)
    if cp.ndim < 2 or cp.shape[-1] != N_CP:
        raise ValueError(f"cp trajectories must be (..., seq, {N_CP}), "
                         f"got {cp.shape}")
    if not np.isfinite(cp).all():
        raise ValueError("cp trajectory contains non-finite values")
    return cp


def _split_cp(cp):
    return (np.ascontiguousarray(cp[..., :N_TRACT]),
            np.ascontiguousarray(cp[..., N_TRACT:]))


def speak(cp_param):
    """Denormalised cp ``(seq, 30)`` -> ``(audio ((seq-1)*110,), 44100)`` on
    the default instance."""
    if not _initialized:
        initialize()
    cp = _check_cp(cp_param)
    if cp.ndim != 2:
        raise ValueError(f"cp_param must be (seq, {N_CP}), got {cp.shape}")
    tract, glottis = _split_cp(cp)
    audio = np.zeros(max(0, cp.shape[0] - 1) * FRAME_STEPS)
    failure = _lib.pts_synth_block(tract.ctypes.data, glottis.ctypes.data,
                                   cp.shape[0], FRAME_STEPS,
                                   audio.ctypes.data)
    if failure != 0:
        raise ValueError(f"pts_synth_block failed: error {failure}")
    return audio, SAMPLE_RATE


class SynthPool:
    """Independent synthesizer instances for batch synthesis."""

    def __init__(self, size=2, speaker_path="default"):
        self._lib = _load()
        self._handles = []
        for _ in range(size):
            h = self._lib.pts_create(str(speaker_path).encode())
            if not h:
                self.close()
                raise ValueError(f"pts_create failed for {speaker_path!r}")
            self._handles.append(h)

    def speak_batch(self, cps_batch):
        """Synthesise ``B`` same-length denormalised trajectories
        ``(B, T, 30)`` in one native call.  Returns ``(audio (B, (T-1)*110),
        44100, errors (B,))``; a nonzero ``errors[i]`` marks a failed item,
        ``-1`` one that is not finite (synthesised as zeros, and its audio
        row left unreliable)."""
        cps = np.array(cps_batch, dtype=np.float64)
        if cps.ndim != 3 or cps.shape[0] == 0 or cps.shape[1] == 0 or (
                cps.shape[2] != N_CP):
            raise ValueError(f"cps_batch must be non-empty (B, T, {N_CP}), "
                             f"got {cps.shape}")
        finite = np.isfinite(cps).all(axis=(1, 2))
        cps[~finite] = 0.0
        b, t = cps.shape[:2]
        tract, glottis = _split_cp(cps)
        audio = np.zeros((b, (t - 1) * FRAME_STEPS))
        errors = np.zeros(b, dtype=np.int32)
        handles = (ctypes.c_void_p * len(self._handles))(*self._handles)
        failure = self._lib.pts_synth_block_batch(
            handles, len(self._handles), tract.ctypes.data,
            glottis.ctypes.data, b, t, FRAME_STEPS, audio.ctypes.data, 0,
            *([None] * 6), errors.ctypes.data)
        if failure != 0:
            raise ValueError(f"pts_synth_block_batch failed: error {failure}")
        errors[~finite] = -1
        return audio, SAMPLE_RATE, errors

    def speak(self, cp_param):
        """One trajectory ``(seq, 30)`` -> ``(audio, 44100)``."""
        audio, sr, errors = self.speak_batch(np.asarray(cp_param)[None])
        if errors[0] != 0:
            raise ValueError(f"synthesis failed: error {errors[0]}")
        return audio[0], sr

    def close(self):
        for h in self._handles:
            self._lib.pts_destroy(h)
        self._handles = []
