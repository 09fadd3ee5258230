"""Build and bind one CUDA source of ``paule_tpu_torch/csrc``.

A :class:`CudaLibrary` compiles its source with ``nvcc`` for ``sm_90a`` on
first use into ``paule_tpu_torch/_build/`` (rebuilt when the source
changes), loads it with ``ctypes`` and launches its entry points.  Every
entry point has a plain C interface: device pointers, then ints (the sizes
``T, B, H`` and, for the persistent kernels, their launch plan), then the
CUDA stream; it returns the CUDA error of its launch.  Nothing is built or
loaded at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


#: CUDA errors an entry point returns before it launches, by number
_ERRORS = {
    1: " (cudaErrorInvalidValue: sizes or launch plan out of range)",
    720: " (cudaErrorCooperativeLaunchTooLarge: the grid of a persistent "
         "kernel cannot be co-resident on the card)",
}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the kernels are built with the "
                           "CUDA toolkit (set CUDA_HOME)")
    return path


class CudaLibrary:
    """``csrc/<source>`` built into ``_build/lib<stem>.so``; ``entry_points``
    maps each C function to its numbers of pointer and int arguments,
    ``(n_ptr, n_int)``."""

    def __init__(self, source, entry_points):
        self.source = os.path.join(_PKG, "csrc", source)
        stem = os.path.splitext(source)[0]
        self.lib_path = os.path.join(BUILD_DIR, f"lib{stem}.so")
        self.entry_points = dict(entry_points)
        self._lib = None
        self._lock = threading.Lock()

    def build(self, verbose=False):
        """Compile the source unless a library built from the same source
        exists; returns its path.  With ``verbose``, prints ``ptxas``'s
        register and shared-memory report."""
        with open(self.source, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()
        stamp = self.lib_path + ".sha256"
        try:
            with open(stamp) as fh:
                if (fh.read().strip() == digest
                        and os.path.exists(self.lib_path)):
                    return self.lib_path
        except OSError:
            pass
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{self.lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, self.source]
        result = subprocess.run(cmd, capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source}:\n{result.stderr}\n"
                f"{result.stdout}")
        if verbose:
            print(result.stderr, end="")
        os.replace(tmp, self.lib_path)
        with open(stamp, "w") as fh:
            fh.write(digest)
        return self.lib_path

    def load(self):
        """Build if needed and load the library (once per process).  A
        caller that traces with ``torch.profiler`` loads every library
        before its first trace: the profiler records no kernel of a
        library loaded after it first started (each library carries its
        own static CUDA runtime)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                p, i = ctypes.c_void_p, ctypes.c_int
                for name, (n_ptr, n_int) in self.entry_points.items():
                    fn = getattr(lib, name)
                    fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
                    fn.restype = i
                self._lib = lib
        return self._lib

    def launch(self, fn_name, device, tensors, ints):
        """Call ``fn_name`` on the current stream of ``device`` with the
        tensors' pointers and the ``ints``; raises on a CUDA error."""
        fn = getattr(self.load(), fn_name)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*[t.data_ptr() for t in tensors], *ints, stream)
        if rc != 0:
            raise RuntimeError(f"{fn_name} failed: CUDA error {rc}"
                               + _ERRORS.get(rc, ""))


def check_tensor(name, t, shape, device):
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device``: what the kernels take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernels take float32, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
