"""The benchmark's own build of the articulatory synthesizer.

It compiles the C++ sources of ``paule_tpu/synth/csrc`` (read in place, as
data; the same flags as ``paule_tpu_torch/synth/build.py:22-23`` and
``:60-61``) into ``portbench/_build/`` and binds the three entry points it
needs with ``ctypes``.  It never loads the program's library.

Every trajectory is synthesised on an instance that has synthesised
nothing before: an instance's frication noise generator is not reset
between trajectories, so its audio can depend on its history.
:func:`speak_twice` synthesises a trajectory twice in a row on one new
instance: the two agree up to the first sample that drew frication noise,
and no history can change the audio before it.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import threading

import numpy as np

from .tables import N_TRACT, inv_normalize_cp, normalize_tube

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
CSRC = os.path.join(os.path.dirname(BENCH), "paule_tpu", "synth", "csrc")
BUILD_DIR = os.path.join(BENCH, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libptsynth_ref.so")
SOURCES = ("model.cpp", "files.cpp", "api.cpp")
HEADERS = ("model.h", "fastmath.h")
FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared", "-fno-math-errno",
         "-fno-trapping-math"]
FRAME_STEPS = 110
SAMPLE_RATE = 44100
N_SECTIONS = 40

_lib = None
_lock = threading.Lock()


def _digest(native):
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(fh.read())
    if native:
        with open("/proc/cpuinfo") as fh:
            flags = next((ln for ln in fh
                          if ln.startswith(("flags", "Features"))), "")
        h.update((platform.machine() + flags).encode())
    return h.hexdigest()


def build():
    """Compile the library unless one built from the same sources, flags
    and CPU exists; -> its path."""
    native = sys.platform.startswith("linux")
    digest = _digest(native)
    stamp = LIB_PATH + ".sha256"
    try:
        with open(stamp) as fh:
            if fh.read().strip() == digest and os.path.exists(LIB_PATH):
                return LIB_PATH
    except OSError:
        pass
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", *FLAGS, *(["-march=native"] if native else []),
           *(os.path.join(CSRC, s) for s in SOURCES), "-o", tmp]
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        raise RuntimeError(f"synthesizer build failed:\n{result.stderr}")
    os.replace(tmp, LIB_PATH)
    with open(stamp, "w") as fh:
        fh.write(digest)
    return LIB_PATH


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pts_create.argtypes = [ctypes.c_char_p]
            lib.pts_create.restype = p
            lib.pts_destroy.argtypes = [p]
            lib.pts_destroy.restype = None
            lib.pts_synth_block_batch.argtypes = (
                [p, i, p, p, i, i, i, p, i] + [p] * 6 + [p])
            lib.pts_synth_block_batch.restype = i
            _lib = lib
    return _lib


def _run(cps, repeats, with_tube):
    """Denormalised cps ``(T, 30)`` synthesised ``repeats`` times in a row
    on one new instance.  -> (audio ``(repeats, n)``, tube buffers or
    None)."""
    lib = _load()
    cps = np.ascontiguousarray(np.broadcast_to(cps, (repeats,) + cps.shape))
    tract = np.ascontiguousarray(cps[..., :N_TRACT])
    glottis = np.ascontiguousarray(cps[..., N_TRACT:])
    t = cps.shape[1]
    audio = np.zeros((repeats, (t - 1) * FRAME_STEPS))
    errors = np.zeros(repeats, dtype=np.int32)
    shape = (repeats, t, N_SECTIONS)
    bufs = ((np.zeros(shape), np.zeros(shape), np.zeros(shape, np.int32),
             np.zeros(shape[:2]), np.zeros(shape[:2]), np.zeros(shape[:2]))
            if with_tube else None)
    handle = lib.pts_create(b"default")
    if not handle:
        raise RuntimeError("pts_create failed")
    try:
        handles = (ctypes.c_void_p * 1)(handle)
        failure = lib.pts_synth_block_batch(
            handles, 1, tract.ctypes.data, glottis.ctypes.data, repeats, t,
            FRAME_STEPS, audio.ctypes.data, int(with_tube),
            *([b.ctypes.data for b in bufs] if with_tube else [None] * 6),
            errors.ctypes.data)
    finally:
        lib.pts_destroy(handle)
    if failure or errors.any():
        raise RuntimeError(f"synthesis failed: {failure}, {errors}")
    return audio, bufs


def speak(norm_cp):
    """A normalised trajectory on a new instance -> float64 audio."""
    return _run(inv_normalize_cp(norm_cp), 1, False)[0][0]


def oral_cavity_min_area(tube_length, tube_area, cm_inside=7):
    """Tube sections ``(T, 40)`` -> the least area of each of the last
    ``cm_inside`` cm before the lips ``(T, cm_inside)``, over the sections
    inside each cm and the one after them (frozen copy of
    ``paule_tpu_torch/synth/__init__.py:423-455``, ``calculate="min"``)."""
    cum = np.cumsum(tube_length, axis=1)
    total = cum[:, -1:]
    n = tube_area.shape[1]
    idx = np.arange(n)[None, :]
    out = np.zeros((tube_area.shape[0], cm_inside))
    for j in range(cm_inside):
        inside = ((cum >= total - (cm_inside - j))
                  & (cum <= total - (cm_inside - j - 1)))
        last = np.where(inside, idx, -1).max(axis=1)
        extra = idx == np.minimum(last + 1, n - 1)[:, None]
        sel = inside | (extra & (last >= 0)[:, None])
        out[:, j] = np.where(sel, tube_area, np.inf).min(axis=1)
    return out


def speak_twice(norm_cp, with_tube=False):
    """A normalised trajectory synthesised twice in a row on a new
    instance.  -> ``(first audio, second audio, tube)``, with
    ``with_tube`` the normalised tube ``(T, 10)`` of the first, else
    ``None``.  The two audios agree up to the first sample that drew
    frication noise, and everywhere when none was drawn."""
    audio, bufs = _run(inv_normalize_cp(norm_cp), 2, with_tube)
    tube = None
    if with_tube:
        length, area, _art, incisor, tongue, velum = (b[0] for b in bufs)
        tube = normalize_tube(np.concatenate(
            [oral_cavity_min_area(length, area), incisor[:, None],
             tongue[:, None], velum[:, None]], axis=1))
    return audio[0], audio[1], tube
