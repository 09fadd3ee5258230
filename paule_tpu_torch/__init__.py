"""PyTorch/CUDA port of paule_tpu (see README, "PyTorch/CUDA port")."""

import multiprocessing as mp
import platform
import sys

__version__ = "0.1.0"


def sysinfo():
    """Print the versions of Python, the port and its dependencies, the
    operating system, and torch's devices (counterpart of
    ``paule_tpu.sysinfo``)."""
    import torch

    uname = platform.uname()
    lines = ["paule_tpu_torch Information", "===========================", "",
             f"Python version: {sys.version.split()[0]}",
             f"paule_tpu_torch version: {__version__}", "",
             f"OS: {uname.system} {uname.machine}",
             f"Kernel: {uname.release}", f"CPU: {mp.cpu_count()}", ""]
    for name in ("torch", "numpy", "scipy"):
        try:
            mod = __import__(name)
            lines.append(f"{name}: {getattr(mod, '__version__', '?')}")
        except ImportError:
            lines.append(f"{name}: <not installed>")
    lines.append(f"torch CUDA: {torch.version.cuda}")
    count = torch.cuda.device_count()
    lines.append(f"CUDA devices: {count}")
    lines += [f"  cuda:{i}: {torch.cuda.get_device_name(i)}"
              for i in range(count)]
    print("\n".join(lines))
