"""Builds the C++ articulatory synthesizer for the port.

Compiles the sources of ``paule_tpu/synth/csrc/`` (read in place) with the
flags of ``paule_tpu/synth/build.py:68-85`` into
``paule_tpu_torch/synth/_build/libptsynth.so``, at first use and again when
the sources or the host CPU's features change (the library is built with
``-march=native``)."""

import hashlib
import os
import platform
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(os.path.dirname(HERE)), "paule_tpu",
                    "synth", "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libptsynth.so")
_STAMP = LIB_PATH + ".sha256"
SOURCES = ("model.cpp", "files.cpp", "api.cpp")
HEADERS = ("model.h", "fastmath.h")
FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared", "-fno-math-errno",
         "-fno-trapping-math", "-Wall", "-Wextra"]


def _digest(native):
    """Hash of the sources, the flags and (for -march=native) the CPU's
    feature flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(fh.read())
    if native:
        with open("/proc/cpuinfo") as fh:
            flags = next((ln for ln in fh if ln.startswith(("flags",
                                                             "Features"))),
                         "")
        h.update((platform.machine() + flags).encode())
    return h.hexdigest()


def build():
    """Compile the synthesizer library unless an up-to-date one exists;
    returns its path."""
    native = sys.platform.startswith("linux")
    digest = _digest(native)
    try:
        with open(_STAMP) as fh:
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
        raise RuntimeError(
            f"synthesizer build failed:\n{result.stderr}\n{result.stdout}")
    os.replace(tmp, LIB_PATH)
    with open(_STAMP, "w") as fh:
        fh.write(digest)
    return LIB_PATH
