"""ctypes binding of the C++ articulatory synthesizer (the port's own; the
same C ABI as ``paule_tpu/synth/__init__.py``).

:func:`speak` drives the library's default instance; :class:`SynthPool`
holds independent instances, and synthesises a batch of trajectories in
one native call that spreads them over the instances' threads.  The rest
of the default instance's surface: constants and parameter ranges,
single-frame tube extraction and transfer functions, synthesis from tube
areas, speaker files, gestural scores and segment files, EMA, mesh and
SVG export, and the tract-sequence file reader :func:`read_cp`.  The
library is built on first use (:mod:`.build`).
"""

import ctypes
import os
import tempfile
import threading

import numpy as np

from . import build as _build
from ..ops.normalize import N_CP, N_GLOTTIS, N_TRACT, normalize_tube

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
            d = ctypes.c_double
            sigs = {
                "pts_create": ([s], p),
                "pts_destroy": ([p], None),
                "pts_initialize": ([s], i),
                "pts_get_version": ([p, i], i),
                "pts_get_constants": ([p] * 6, i),
                "pts_get_tract_param_info": ([p, i, p, p, p], i),
                "pts_get_glottis_param_info": ([p, i, p, p, p], i),
                "pts_synth_block": ([p, p, i, i, p], i),
                "pts_speak_and_extract": ([p, p, i, i] + [p] * 7, i),
                "pts_tract_to_tube": ([p] * 7, i),
                "pts_synthesis_add_tube": ([i, p, p, p, p, d], i),
                "pts_get_transfer_function": ([p, i, p, p], i),
                "pts_input_tract_to_limited_tract": ([p, p], i),
                "pts_calc_tongue_root_automatically": ([p], i),
                "pts_save_speaker": ([s], i),
                "pts_gestural_score_to_audio": ([s, s, p, i, p], i),
                "pts_gestural_score_to_ema_and_mesh": ([s, s, s], i),
                "pts_export_tract_svg": ([p, s], i),
                "pts_segment_sequence_to_gestural_score": ([s, s], i),
                "pts_gestural_score_to_tract_sequence": ([s, s], i),
                "pts_tract_sequence_to_ema_and_mesh": ([p, p, i, i, i, i, p,
                                                        p, s, s], i),
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


def _default():
    """The library, its default instance initialised."""
    if not _initialized:
        initialize()
    return _lib


def _failed(what, failure):
    if failure != 0:
        raise ValueError(f"Error in {what}! Errorcode: {failure}")


def _finite(arr, what):
    """``arr`` as contiguous float64; non-finite values raise (the C
    core's fast math assumes finite inputs)."""
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    if not np.isfinite(arr).all():
        raise ValueError(f"{what} contains non-finite values")
    return arr


def version():
    """The synthesizer library's version string."""
    buf = ctypes.create_string_buffer(64)
    _load().pts_get_version(buf, 64)
    return buf.value.decode()


def get_constants():
    """The synthesizer's constants: ``audio_sampling_rate``,
    ``n_tube_sections``, ``n_tract_params``, ``n_glottis_params``,
    ``n_samples_per_state`` and ``internal_sampling_rate``."""
    ints = [ctypes.c_int(0) for _ in range(5)]
    internal = ctypes.c_double(0)
    _default().pts_get_constants(*(ctypes.byref(v) for v in ints),
                                 ctypes.byref(internal))
    names = ("audio_sampling_rate", "n_tube_sections", "n_tract_params",
             "n_glottis_params", "n_samples_per_state")
    out = {k: v.value for k, v in zip(names, ints)}
    out["internal_sampling_rate"] = internal.value
    return out


def get_param_info(which="tract"):
    """The default speaker's ``"tract"`` (19) or, for any other ``which``,
    glottis (11) parameters: ``names``, ``mins``, ``maxs``,
    ``neutrals``."""
    lib = _default()
    n = N_TRACT if which == "tract" else N_GLOTTIS
    names = ctypes.create_string_buffer(512)
    mins, maxs, neutrals = np.zeros(n), np.zeros(n), np.zeros(n)
    fn = (lib.pts_get_tract_param_info if which == "tract"
          else lib.pts_get_glottis_param_info)
    fn(names, 512, mins.ctypes.data, maxs.ctypes.data, neutrals.ctypes.data)
    return {"names": names.value.decode().split(), "mins": mins,
            "maxs": maxs, "neutrals": neutrals}


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
    lib = _default()
    cp = _check_cp(cp_param)
    if cp.ndim != 2:
        raise ValueError(f"cp_param must be (seq, {N_CP}), got {cp.shape}")
    tract, glottis = _split_cp(cp)
    audio = np.zeros(max(0, cp.shape[0] - 1) * FRAME_STEPS)
    failure = lib.pts_synth_block(tract.ctypes.data, glottis.ctypes.data,
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
    lib = _default()
    cp = _check_cp(cp_param)
    if cp.ndim != 2 or cp.shape[0] == 0:
        raise ValueError(f"cp_param must be (seq, {N_CP}), seq > 0, got "
                         f"{cp.shape}")
    tract, glottis = _split_cp(cp)
    audio = np.zeros((cp.shape[0] - 1) * FRAME_STEPS)
    bufs = _tube_buffers(cp.shape[:1])
    failure = lib.pts_speak_and_extract(
        tract.ctypes.data, glottis.ctypes.data, cp.shape[0], FRAME_STEPS,
        audio.ctypes.data, *(b.ctypes.data for b in bufs))
    if failure != 0:
        raise ValueError(f"pts_speak_and_extract failed: error {failure}")
    return audio, SAMPLE_RATE, _tube_info(*bufs)


def tract_to_tube(tract_params):
    """One frame's 19 tract parameters -> ``(tube_length (40,), tube_area
    (40,), articulator indices (40,), incisor_pos_cm,
    tongue_tip_side_elevation, velum_opening_cm2)``."""
    lib = _default()
    tract = _finite(tract_params, "tract_params")
    tl, ta, ai, *scalars = _tube_buffers(())
    failure = lib.pts_tract_to_tube(
        tract.ctypes.data, tl.ctypes.data, ta.ctypes.data, ai.ctypes.data,
        *(x.ctypes.data for x in scalars))
    _failed("pts_tract_to_tube", failure)
    return (tl, ta, ai, *(float(x) for x in scalars))


def synthesis_add_tube(n_samples, tube_areas, glottis, *, tube_lengths=None,
                       velum_opening_cm2=0.0):
    """Incremental synthesis on the default instance from 40 tube-section
    areas (the tract model bypassed): ``n_samples`` samples towards the
    given state (empty on the first call, which installs the state)."""
    lib = _default()
    areas = np.ascontiguousarray(tube_areas, dtype=np.float64)
    if areas.shape != (N_TUBE_SECTIONS,):
        raise ValueError(f"tube_areas must be ({N_TUBE_SECTIONS},)")
    _finite(areas, "tube_areas")
    lengths = (np.full(N_TUBE_SECTIONS, 16.0 / N_TUBE_SECTIONS)
               if tube_lengths is None
               else _finite(tube_lengths, "tube_lengths"))
    gl = _finite(glottis, "glottis")
    audio = np.zeros(max(n_samples, 1))
    failure = lib.pts_synthesis_add_tube(
        int(n_samples), audio.ctypes.data, areas.ctypes.data,
        lengths.ctypes.data, gl.ctypes.data, float(velum_opening_cm2))
    _failed("pts_synthesis_add_tube", failure)
    return audio[:n_samples]


def get_transfer_function(tract_params, n_points=1024):
    """The tract's transfer function ``(magnitude, phase)`` at ``n_points``
    frequencies up to the Nyquist frequency."""
    lib = _default()
    tract = _finite(tract_params, "tract_params")
    mag, phase = np.zeros(n_points), np.zeros(n_points)
    failure = lib.pts_get_transfer_function(
        tract.ctypes.data, int(n_points), mag.ctypes.data, phase.ctypes.data)
    _failed("pts_get_transfer_function", failure)
    return mag, phase


def input_tract_to_limited_tract(tract_params):
    """19 tract parameters clamped into the speaker's domain."""
    lib = _default()
    tract = np.ascontiguousarray(tract_params, dtype=np.float64)
    out = np.zeros_like(tract)
    failure = lib.pts_input_tract_to_limited_tract(tract.ctypes.data,
                                                   out.ctypes.data)
    if failure != 0:
        raise ValueError(f"Errorcode: {failure}")
    return out


def calc_tongue_root_automatically(tract_params):
    """A copy of 19 tract parameters with TRX and TRY set from the tongue
    body's position."""
    lib = _default()
    tract = np.array(tract_params, dtype=np.float64)
    failure = lib.pts_calc_tongue_root_automatically(tract.ctypes.data)
    if failure != 0:
        raise ValueError(f"Errorcode: {failure}")
    return tract


def save_speaker(path):
    """Write the default instance's speaker to a speaker file."""
    _failed("pts_save_speaker", _default().pts_save_speaker(
        str(path).encode()))


def ges_to_audio(ges_file, wav_file=None):
    """A gestural score file -> ``(audio, 44100)``; with ``wav_file`` also
    written there."""
    lib = _default()
    n = ctypes.c_int(0)
    # the first call asks for the length only
    _failed("pts_gestural_score_to_audio", lib.pts_gestural_score_to_audio(
        str(ges_file).encode(), b"", None, 0, ctypes.byref(n)))
    audio = np.zeros(n.value)
    _failed("pts_gestural_score_to_audio", lib.pts_gestural_score_to_audio(
        str(ges_file).encode(), str(wav_file).encode() if wav_file else b"",
        audio.ctypes.data, n.value, ctypes.byref(n)))
    return audio, SAMPLE_RATE


def ges_to_ema_and_mesh(ges_file, file_prefix, *, path=""):
    """A gestural score file -> EMA and mesh files
    ``<path>/<file_prefix>-*``."""
    lib = _default()
    if path:
        os.makedirs(path, exist_ok=True)
    _failed("pts_gestural_score_to_ema_and_mesh",
            lib.pts_gestural_score_to_ema_and_mesh(
                str(ges_file).encode(), str(path).encode(),
                str(file_prefix).encode()))


def export_svgs(cps, path="svgs/", hop_length=5):
    """One midsagittal SVG ``<path>/tract%05d.svg`` of every
    ``hop_length``-th frame of the denormalised cps ``(T, 30)`` (5 is ~80
    frames per second, 16 ~25)."""
    lib = _default()
    cps = np.ascontiguousarray(cps, dtype=np.float64)
    os.makedirs(path, exist_ok=True)
    for ii in range(cps.shape[0] // hop_length):
        tract = np.ascontiguousarray(cps[ii * hop_length, :N_TRACT])
        lib.pts_export_tract_svg(
            tract.ctypes.data,
            os.path.join(path, f"tract{ii:05d}.svg").encode())


def cps_to_ema_and_mesh(cps, file_prefix, *, path=""):
    """EMA trajectories of three tongue points (back, middle, tip) and the
    meshes of the denormalised cps ``(T, 30)``, as files
    ``<path>/<file_prefix>-*``."""
    lib = _default()
    cps = _check_cp(cps)
    if cps.ndim != 2:
        raise ValueError(f"cp_param must be (seq, {N_CP}), got {cps.shape}")
    tract, glottis = _split_cp(cps)
    surf = (ctypes.c_int * 3)(16, 16, 16)  # the tongue's surface
    vert = (ctypes.c_int * 3)(115, 225, 335)  # back, middle, tip
    if path:
        os.makedirs(path, exist_ok=True)
    _failed("pts_tract_sequence_to_ema_and_mesh",
            lib.pts_tract_sequence_to_ema_and_mesh(
                tract.ctypes.data, glottis.ctypes.data, N_TRACT, N_GLOTTIS,
                cps.shape[0], 3, surf, vert, str(path).encode(),
                str(file_prefix).encode()))


def cps_to_ema(cps):
    """:func:`cps_to_ema_and_mesh`'s EMA table as a pandas DataFrame
    (pandas is imported here only)."""
    import pandas as pd

    with tempfile.TemporaryDirectory(prefix="paule_tpu_torch_") as path:
        name = "paule_tpu_ema_export"
        cps_to_ema_and_mesh(cps, file_prefix=name, path=path)
        return pd.read_table(os.path.join(path, f"{name}-ema.txt"), sep=" ")


def read_cp(filename):
    """A tract-sequence file -> its denormalised cps ``(n, 30)``: six
    header lines, ``Geometric glottis``, the number of states, then per
    state a line of 11 glottis and a line of 19 tract values."""
    with open(filename, "rt") as cp_file:
        for _ in range(6):
            cp_file.readline()
        if cp_file.readline().strip() != "Geometric glottis":
            raise ValueError(
                f'glottis model is not "Geometric glottis" in file {filename}')
        n_states = int(cp_file.readline().strip())
        cp_param = np.zeros((n_states, N_CP))
        for ii, line in enumerate(cp_file):
            kk = ii // 2
            if kk >= n_states:
                raise ValueError(
                    f"more states saved in file {filename} than claimed")
            vals = np.array(line.split(), dtype=np.float64)
            cols = (slice(N_TRACT, None) if ii % 2 == 0
                    else slice(None, N_TRACT))
            if vals.shape != cp_param[kk, cols].shape:
                raise ValueError(
                    f"state {kk} of {filename} has {vals.size} "
                    f"{'glottis' if ii % 2 == 0 else 'tract'} values")
            cp_param[kk, cols] = vals
    return cp_param


def seg_to_cps(seg_file):
    """A segment file -> a gestural score (a temporary file) -> its
    denormalised cps."""
    lib = _default()
    with tempfile.TemporaryDirectory() as tmpdir:
        ges = os.path.join(tmpdir, "gestural_score.txt")
        _failed("pts_segment_sequence_to_gestural_score",
                lib.pts_segment_sequence_to_gestural_score(
                    str(seg_file).encode(), ges.encode()))
        return ges_to_cps(ges)


def ges_to_cps(ges_file):
    """A gestural score file -> a tract sequence (a temporary file) -> its
    denormalised cps."""
    lib = _default()
    with tempfile.TemporaryDirectory() as tmpdir:
        seq = os.path.join(tmpdir, "tract_sequence.txt")
        _failed("pts_gestural_score_to_tract_sequence",
                lib.pts_gestural_score_to_tract_sequence(
                    str(ges_file).encode(), seq.encode()))
        return read_cp(seq)


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
    """Independent synthesizer instances for batch synthesis.

    One native call at a time uses the instances (a lock): a call spreads
    its batch over all of them, and an instance synthesising for two
    threads at once returns corrupt audio (the HTTP service's concurrent
    /synthesize requests, or one beside a plan's synthesis)."""

    def __init__(self, size=2, speaker_path="default"):
        self._lib = _load()
        self._lock = threading.Lock()
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
        with self._lock:
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
        with self._lock:
            for h in self._handles:
                self._lib.pts_destroy(h)
            self._handles = []
