"""Plant adapter for the VocalTractLab synthesizer (the port's own copy of
``paule_tpu/synth/vtl_plant.py``).

:class:`paule_tpu_torch.api.Paule` accepts any *plant*, an object with

* ``speak(cp_denorm) -> (audio, sr)``
* ``speak_and_extract_tube_information(cp_denorm) -> (audio, sr, tube_info)``
* ``close()``

for denormalised ``(seq, 30)`` trajectories, ``(seq-1)*110`` samples of
44.1 kHz audio and the tube-info dict.  The default plant is the C++
synthesizer (:class:`paule_tpu_torch.synth.SynthPool`); :class:`VTLPlant`
is the same surface on the native VocalTractLab library
(``libVocalTractLabApi.so``), which the repo does not ship: point
``PAULE_REFERENCE_ROOT`` at a reference checkout holding
``paule/vocaltractlab_api/`` (default: ``reference/`` in the checkout), or
pass ``lib_path`` and ``speaker_path``.  :func:`vtl_available` says
whether it is there.

VTL holds *global* state behind ``vtlInitialize`` (one speaker, one
synthesis timeline per process), so every entry point serialises on a
module-level lock.
"""

import ctypes
import os
import threading

import numpy as np

from . import ARTICULATOR, FRAME_STEPS, SAMPLE_RATE
from ..ops.normalize import N_CP, N_GLOTTIS, N_TRACT
from ..reference_bridge import REFERENCE_ROOT, reference_hidden

DEFAULT_LIB = os.path.join(REFERENCE_ROOT, "paule", "vocaltractlab_api",
                           "libVocalTractLabApi.so")
DEFAULT_SPEAKER = os.path.join(REFERENCE_ROOT, "paule", "vocaltractlab_api",
                               "JD3.speaker")

# VTL is a process-global singleton: one dlopen handle, one lock, one
# initialized speaker, shared by every VTLPlant instance (and by any other
# user of the same library in the process: dlopen refcounts the handle).
_LOCK = threading.RLock()
_LIB = None
_INITIALIZED_SPEAKER = None

# 2000 extra samples of scratch tail vtlSynthBlock may write past the
# nominal (seq-1)*110 output
_SAFETY_TAIL = 2000


def vtl_available(lib_path=DEFAULT_LIB, speaker_path=DEFAULT_SPEAKER):
    """Whether the VTL library and speaker file exist (and the reference
    is not hidden)."""
    if reference_hidden():
        return False
    return os.path.exists(lib_path) and os.path.exists(speaker_path)


def _load(lib_path):
    global _LIB
    if _LIB is None:
        lib = ctypes.cdll.LoadLibrary(lib_path)
        lib.vtlInitialize.argtypes = [ctypes.c_char_p]
        _LIB = lib
    return _LIB


def _ensure_initialized(lib, speaker_path):
    """Initialize VTL once per process (re-init on a speaker change).

    If another user of the same dlopen'd library already initialized it
    (the reference's ``paule.util`` does so at import time), a second
    ``vtlInitialize`` is still safe — VTL tears down and re-reads the
    speaker — but it is skipped when the speaker matches, so as not to
    reset that user's synthesis timeline.
    """
    global _INITIALIZED_SPEAKER
    speaker_path = os.path.abspath(speaker_path)
    if _INITIALIZED_SPEAKER == speaker_path:
        return
    failure = lib.vtlInitialize(speaker_path.encode())
    if failure == 0:
        _INITIALIZED_SPEAKER = speaker_path
        return
    if _INITIALIZED_SPEAKER is not None:
        # a DIFFERENT speaker is live and the re-init failed; proceeding
        # would silently synthesize with the wrong speaker
        raise ValueError(
            f"Error in vtlInitialize! Errorcode: {failure} (requested "
            f"{speaker_path!r} while {_INITIALIZED_SPEAKER!r} is loaded)")
    # we never initialized, but an external user of the same dlopen handle
    # may have (the reference's paule.util does at import time): probe
    # with a constants query;
    # a library that answers is usable, but the live speaker is unknown,
    # so do NOT cache the requested path — a later speaker change retries
    # the init instead of short-circuiting on a wrong cache entry
    sr = ctypes.c_int(0)
    probe = lib.vtlGetConstants(
        ctypes.byref(sr), ctypes.byref(ctypes.c_int(0)),
        ctypes.byref(ctypes.c_int(0)), ctypes.byref(ctypes.c_int(0)),
        ctypes.byref(ctypes.c_int(0)), ctypes.byref(ctypes.c_double(0)))
    if probe != 0 or sr.value <= 0:
        raise ValueError(
            f"Error in vtlInitialize! Errorcode: {failure}")


class VTLPlant:
    """The native VocalTractLab synthesizer as a Paule plant."""

    def __init__(self, lib_path=DEFAULT_LIB, speaker_path=DEFAULT_SPEAKER):
        with _LOCK:
            self._lib = _load(lib_path)
            _ensure_initialized(self._lib, speaker_path)
            self._check_constants()

    # -- helpers -------------------------------------------------------

    def _check_constants(self):
        sr = ctypes.c_int(0)
        n_tube = ctypes.c_int(0)
        n_tract = ctypes.c_int(0)
        n_glottis = ctypes.c_int(0)
        n_per_state = ctypes.c_int(0)
        internal_sr = ctypes.c_double(0)
        failure = self._lib.vtlGetConstants(
            ctypes.byref(sr), ctypes.byref(n_tube), ctypes.byref(n_tract),
            ctypes.byref(n_glottis), ctypes.byref(n_per_state),
            ctypes.byref(internal_sr))
        if failure != 0:
            raise ValueError(f"Error in vtlGetConstants! Errorcode: {failure}")
        if (sr.value, n_tract.value, n_glottis.value) != \
                (SAMPLE_RATE, N_TRACT, N_GLOTTIS):
            raise ValueError(
                "VTL constants mismatch: expected "
                f"({SAMPLE_RATE}, {N_TRACT}, {N_GLOTTIS}), got "
                f"({sr.value}, {n_tract.value}, {n_glottis.value})")
        self.n_tube_sections = n_tube.value

    @staticmethod
    def _split(cp_param):
        cp = np.ascontiguousarray(cp_param, dtype=np.float64)
        if cp.ndim != 2 or cp.shape[1] != N_CP:
            raise ValueError(f"cp_param must be (seq, {N_CP}), got {cp.shape}")
        if not np.isfinite(cp).all():
            raise ValueError("cp_param contains non-finite values")
        tract = np.ascontiguousarray(cp[:, :N_TRACT])
        glottis = np.ascontiguousarray(cp[:, N_TRACT:])
        return tract, glottis

    # -- plant surface --------------------------------------------------

    def speak(self, cp_param):
        """Block synthesis; audio length contract ``(seq-1)*110``."""
        tract, glottis = self._split(cp_param)
        n_frames = tract.shape[0]
        n_audio = max(0, (n_frames - 1) * FRAME_STEPS)
        audio = np.zeros(n_audio + _SAFETY_TAIL, dtype=np.float64)
        dptr = ctypes.POINTER(ctypes.c_double)
        with _LOCK:
            failure = self._lib.vtlSynthesisReset()
            if failure != 0:
                raise ValueError(
                    f"Error in vtlSynthesisReset! Errorcode: {failure}")
            failure = self._lib.vtlSynthBlock(
                tract.ctypes.data_as(dptr), glottis.ctypes.data_as(dptr),
                ctypes.c_int(n_frames), ctypes.c_int(FRAME_STEPS),
                audio.ctypes.data_as(dptr), ctypes.c_int(0))
            if failure != 0:
                raise ValueError(
                    f"Error in vtlSynthBlock! Errorcode: {failure}")
        return audio[:n_audio], SAMPLE_RATE

    def speak_and_extract_tube_information(self, cp_param):
        """Incremental synthesis with per-frame tube extraction."""
        tract, glottis = self._split(cp_param)
        n_frames = tract.shape[0]
        n_tube = self.n_tube_sections
        audio = np.zeros(max(0, n_frames - 1) * FRAME_STEPS, dtype=np.float64)
        tube_length = np.zeros((n_frames, n_tube))
        tube_area = np.zeros((n_frames, n_tube))
        tube_articulator_idx = np.zeros((n_frames, n_tube), dtype=np.int32)
        incisor = np.zeros(n_frames)
        tongue_tip = np.zeros(n_frames)
        velum = np.zeros(n_frames)

        dptr = ctypes.POINTER(ctypes.c_double)
        iptr = ctypes.POINTER(ctypes.c_int)
        frame_buf = np.zeros(FRAME_STEPS, dtype=np.float64)
        with _LOCK:
            failure = self._lib.vtlSynthesisReset()
            if failure != 0:
                raise ValueError(
                    f"Error in vtlSynthesisReset! Errorcode: {failure}")
            for i in range(n_frames):
                n_new = 0 if i == 0 else FRAME_STEPS
                failure = self._lib.vtlSynthesisAddTract(
                    ctypes.c_int(n_new), frame_buf.ctypes.data_as(dptr),
                    tract[i].ctypes.data_as(dptr),
                    glottis[i].ctypes.data_as(dptr))
                if failure != 0:
                    raise ValueError(
                        f"Error in vtlSynthesisAddTract! Errorcode: {failure}")
                if i > 0:
                    audio[(i - 1) * FRAME_STEPS:i * FRAME_STEPS] = frame_buf
                inc = ctypes.c_double(0)
                tts = ctypes.c_double(0)
                vel = ctypes.c_double(0)
                failure = self._lib.vtlTractToTube(
                    tract[i].ctypes.data_as(dptr),
                    tube_length[i].ctypes.data_as(dptr),
                    tube_area[i].ctypes.data_as(dptr),
                    tube_articulator_idx[i].ctypes.data_as(iptr),
                    ctypes.byref(inc), ctypes.byref(tts), ctypes.byref(vel))
                if failure != 0:
                    raise ValueError(
                        f"Error in vtlTractToTube! Errorcode: {failure}")
                incisor[i] = inc.value
                tongue_tip[i] = tts.value
                velum[i] = vel.value

        arti = np.vectorize(ARTICULATOR.get)(tube_articulator_idx) \
            if n_frames else np.zeros((0, n_tube), dtype=object)
        tube_info = {
            "tube_length_cm": tube_length,
            "tube_area_cm2": tube_area,
            "tube_articulator": arti,
            "incisor_pos_cm": incisor,
            "tongue_tip_side_elevation": tongue_tip,
            "velum_opening_cm2": velum,
        }
        return audio, SAMPLE_RATE, tube_info

    def tract_to_tube(self, tract_row):
        """Direct ``vtlTractToTube`` on ONE (19,) tract state — no
        synthesis, microseconds per call.  Used to sample VTL's tract
        model as ground truth when fitting an imported speaker's
        ``[tract_affine]`` tube map (speaker_import.fit_tract_affine)."""
        tract = np.ascontiguousarray(tract_row, dtype=np.float64)
        if tract.shape != (N_TRACT,):
            raise ValueError(f"tract_row must be ({N_TRACT},), got "
                             f"{tract.shape}")
        n_tube = self.n_tube_sections
        tube_length = np.zeros(n_tube)
        tube_area = np.zeros(n_tube)
        tube_articulator_idx = np.zeros(n_tube, dtype=np.int32)
        inc = ctypes.c_double(0)
        tts = ctypes.c_double(0)
        vel = ctypes.c_double(0)
        dptr = ctypes.POINTER(ctypes.c_double)
        iptr = ctypes.POINTER(ctypes.c_int)
        with _LOCK:
            failure = self._lib.vtlTractToTube(
                tract.ctypes.data_as(dptr),
                tube_length.ctypes.data_as(dptr),
                tube_area.ctypes.data_as(dptr),
                tube_articulator_idx.ctypes.data_as(iptr),
                ctypes.byref(inc), ctypes.byref(tts), ctypes.byref(vel))
            if failure != 0:
                raise ValueError(
                    f"Error in vtlTractToTube! Errorcode: {failure}")
        return {"tube_length_cm": tube_length, "tube_area_cm2": tube_area,
                "tube_articulator_idx": tube_articulator_idx,
                "incisor_pos_cm": inc.value,
                "tongue_tip_side_elevation": tts.value,
                "velum_opening_cm2": vel.value}

    def get_transfer_function(self, tract_row, n_points=2048):
        """``vtlGetTransferFunction`` on one (19,) tract state — the
        glottis-to-lips magnitude/phase spectrum, for formant-level
        validation of imported speakers against VTL's own acoustics.

        Uses the VTL >= 2.3 five-argument signature (with an options
        pointer, NULL = defaults) — the API the shipped reference binary
        exports ("API 2.6.0quantling"); a pre-2.3 library would need the
        four-argument call instead.  Note VTL's transfer function
        includes subglottal/glottal coupling, so its peaks are NOT
        directly the audio formants."""
        tract = np.ascontiguousarray(tract_row, dtype=np.float64)
        if tract.shape != (N_TRACT,):
            raise ValueError(f"tract_row must be ({N_TRACT},), got "
                             f"{tract.shape}")
        mag = np.zeros(n_points)
        phase = np.zeros(n_points)
        dptr = ctypes.POINTER(ctypes.c_double)
        with _LOCK:
            # VTL >= 2.3 signature: (tractParams, numSamples,
            # opts (TransferFunctionOptions*, NULL = defaults), mag, phase)
            failure = self._lib.vtlGetTransferFunction(
                tract.ctypes.data_as(dptr), ctypes.c_int(n_points),
                None, mag.ctypes.data_as(dptr), phase.ctypes.data_as(dptr))
            if failure != 0:
                raise ValueError(
                    f"Error in vtlGetTransferFunction! Errorcode: {failure}")
        return mag, phase

    def close(self):
        # VTL state is process-global and possibly shared with another
        # user of the library; never vtlClose from a plant handle
        pass
