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
from ..ops.normalize import N_CP, N_TRACT, normalize_tube

FRAME_STEPS = 110  # samples per control frame (2.5 ms at 44.1 kHz)
SAMPLE_RATE = 44100
N_TUBE_SECTIONS = 40
#: articulator index of a tube section -> its name
ARTICULATOR = {
    0: "vocal folds",
    1: "tongue",
    2: "lower incisors",
    3: "lower lip",
    4: "other articulator",
    5: "num articulators",
}

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
                "pts_speak_and_extract": ([p, p, i, i] + [p] * 7, i),
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


def _tube_buffers(shape):
    """Zeroed output buffers of tube extraction for ``shape`` = ``(T,)`` or
    ``(B, T)`` frames, in the order of the C entry points' arguments."""
    sections = (*shape, N_TUBE_SECTIONS)
    return (np.zeros(sections), np.zeros(sections),
            np.zeros(sections, dtype=np.int32), np.zeros(shape),
            np.zeros(shape), np.zeros(shape))


def _tube_info(length, area, articulator, incisor, tongue_tip, velum):
    return {"tube_length_cm": length, "tube_area_cm2": area,
            "tube_articulator": np.vectorize(ARTICULATOR.get)(articulator),
            "incisor_pos_cm": incisor,
            "tongue_tip_side_elevation": tongue_tip,
            "velum_opening_cm2": velum}


def speak_and_extract_tube_information(cp_param):
    """Denormalised cp ``(seq, 30)`` -> ``(audio ((seq-1)*110,), 44100,
    tube_info)`` on the default instance, in one native call.
    ``tube_info`` holds per frame ``tube_length_cm`` and ``tube_area_cm2``
    ``(seq, 40)``, ``tube_articulator`` (names), ``incisor_pos_cm``,
    ``tongue_tip_side_elevation`` and ``velum_opening_cm2`` ``(seq,)``."""
    if not _initialized:
        initialize()
    cp = _check_cp(cp_param)
    if cp.ndim != 2 or cp.shape[0] == 0:
        raise ValueError(f"cp_param must be (seq, {N_CP}), seq > 0, got "
                         f"{cp.shape}")
    tract, glottis = _split_cp(cp)
    audio = np.zeros((cp.shape[0] - 1) * FRAME_STEPS)
    bufs = _tube_buffers(cp.shape[:1])
    failure = _lib.pts_speak_and_extract(
        tract.ctypes.data, glottis.ctypes.data, cp.shape[0], FRAME_STEPS,
        audio.ctypes.data, *(b.ctypes.data for b in bufs))
    if failure != 0:
        raise ValueError(f"pts_speak_and_extract failed: error {failure}")
    return audio, SAMPLE_RATE, _tube_info(*bufs)


def get_area_info_within_oral_cavity(tube_length, tube_area, *, cm_inside=7,
                                     calculate="min"):
    """Tube sections ``(T, 40)`` -> one feature per cm of the last
    ``cm_inside`` cm before the lips ``(T, cm_inside)``: over the sections
    inside each cm, and the one after them, the ``"min"`` area, the
    ``"mean"`` area, or (``"binary"``) whether any is closed
    (``paule_tpu/synth/__init__.py:472-505``)."""
    tube_length = np.asarray(tube_length)
    tube_area = np.asarray(tube_area)
    cum = np.cumsum(tube_length, axis=1)
    total = cum[:, -1:]
    n_sections = tube_area.shape[1]
    idx = np.arange(n_sections)[None, :]
    out = np.zeros((tube_area.shape[0], cm_inside))
    for j in range(cm_inside):
        inside = ((cum >= total - (cm_inside - j))
                  & (cum <= total - (cm_inside - j - 1)))
        last_idx = np.where(inside, idx, -1).max(axis=1)
        extra = idx == np.minimum(last_idx + 1, n_sections - 1)[:, None]
        sel = inside | (extra & (last_idx >= 0)[:, None])
        if calculate == "min":
            vals = np.where(sel, tube_area, np.inf).min(axis=1)
        elif calculate == "mean":
            vals = (np.where(sel, tube_area, 0.0).sum(axis=1)
                    / np.maximum(sel.sum(axis=1), 1))
        elif calculate == "binary":
            vals = (np.where(sel, tube_area, np.inf) <= 0.001).any(axis=1)
        else:
            raise ValueError(
                "calculate must be one of ['mean','binary','min']")
        out[:, j] = vals
    return out


def tube_features(tube_info):
    """A ``tube_info`` -> the normalised tube ``(T, 10)``: the 7
    oral-cavity areas, incisor position, tongue-tip side elevation and
    velum opening (``paule_tpu/api.py:595-602``)."""
    area = get_area_info_within_oral_cavity(
        tube_info["tube_length_cm"], tube_info["tube_area_cm2"])
    return normalize_tube(np.concatenate(
        [area, tube_info["incisor_pos_cm"][:, None],
         tube_info["tongue_tip_side_elevation"][:, None],
         tube_info["velum_opening_cm2"][:, None]], axis=1))


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

    def _batch(self, cps_batch, with_tube):
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
        bufs = _tube_buffers((b, t)) if with_tube else ()
        handles = (ctypes.c_void_p * len(self._handles))(*self._handles)
        failure = self._lib.pts_synth_block_batch(
            handles, len(self._handles), tract.ctypes.data,
            glottis.ctypes.data, b, t, FRAME_STEPS, audio.ctypes.data,
            int(with_tube),
            *([x.ctypes.data for x in bufs] if with_tube else [None] * 6),
            errors.ctypes.data)
        if failure != 0:
            raise ValueError(f"pts_synth_block_batch failed: error {failure}")
        errors[~finite] = -1
        tubes = ([_tube_info(*(x[i] for x in bufs)) for i in range(b)]
                 if with_tube else None)
        return audio, SAMPLE_RATE, errors, tubes

    def speak_batch(self, cps_batch):
        """Synthesise ``B`` same-length denormalised trajectories
        ``(B, T, 30)`` in one native call.  Returns ``(audio (B, (T-1)*110),
        44100, errors (B,))``; a nonzero ``errors[i]`` marks a failed item,
        ``-1`` one that is not finite (synthesised as zeros, and its audio
        row left unreliable)."""
        return self._batch(cps_batch, False)[:3]

    def speak_and_extract_batch(self, cps_batch):
        """:meth:`speak_batch` with tube extraction, in one native call:
        -> ``(audio, 44100, errors, [tube_info] * B)``, each ``tube_info``
        as :func:`speak_and_extract_tube_information` gives it."""
        return self._batch(cps_batch, True)

    def speak(self, cp_param):
        """One trajectory ``(seq, 30)`` -> ``(audio, 44100)``."""
        audio, sr, errors = self.speak_batch(np.asarray(cp_param)[None])
        if errors[0] != 0:
            raise ValueError(f"synthesis failed: error {errors[0]}")
        return audio[0], sr

    def speak_and_extract_tube_information(self, cp_param):
        """One trajectory ``(seq, 30)`` -> ``(audio, 44100, tube_info)``."""
        audio, sr, errors, tubes = self.speak_and_extract_batch(
            np.asarray(cp_param)[None])
        if errors[0] != 0:
            raise ValueError(f"synthesis failed: error {errors[0]}")
        return audio[0], sr, tubes[0]

    def close(self):
        for h in self._handles:
            self._lib.pts_destroy(h)
        self._handles = []
