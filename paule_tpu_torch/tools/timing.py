"""Device timing and roofline bounds for the kernels, and the device
checks of the measurement tools.

Measurement helpers shared by ``chip_smoke.py``, the ceiling probes and the
tools of this package; the port itself never calls them.
``torch.nn.LSTM`` (cuDNN) appears here only as the yardstick beside a
kernel's time.
"""

import json
import subprocess
import time

import torch

#: published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s
#: and float32 FLOP/s outside the tensor cores (the kernels use FMA units)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
F32 = 4


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls, after one
    warm-up call (CUDA events around the whole run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_flops):
    """-> (least time in ms, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the FLOPs over the f32 rate."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lstm_fwd_bound(seq, batch, hidden):
    """B1's function: read gates_x, W_hh, h0, c0; write hs, cs."""
    return bound_ms(
        F32 * (seq * batch * 6 * hidden + 4 * hidden * hidden
               + 2 * batch * hidden),
        seq * batch * (8 * hidden * hidden + 13 * hidden))


def lstm_bwd_bound(seq, batch, hidden):
    """B2's function: read acts, cs_prev, ghs, W_hh; write dgates, dh0,
    dc0."""
    return bound_ms(
        F32 * (seq * batch * 10 * hidden + 4 * hidden * hidden
               + 2 * batch * hidden),
        seq * batch * (8 * hidden * hidden + 20 * hidden))


def cudnn_lstm_ms(n_in, hidden, n_layers, seq, batch, device, backward,
                  reps=20):
    """``torch.nn.LSTM`` (cuDNN) at a kernel's shape: the forward, or the
    backward of a retained graph."""
    lstm = torch.nn.LSTM(n_in, hidden, num_layers=n_layers).to(device)
    x = torch.randn(seq, batch, n_in, device=device, requires_grad=True)
    if not backward:
        with torch.no_grad():
            return cuda_ms(lambda: lstm(x), reps)
    out, _ = lstm(x)
    g = torch.randn_like(out)
    params = [x, *lstm.parameters()]
    return cuda_ms(lambda: torch.autograd.grad(out, params, g,
                                               retain_graph=True), reps)


def card_line():
    """``name, power limit`` of the card as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip()


def open_device(device):
    """``device`` as a ``torch.device``.  A CUDA device raises
    ``RuntimeError`` when there is no card, so that a measurement never
    falls back to the CPU, and gets full-f32 math (no TF32), as
    ``Paule`` sets it; only a caller that names the CPU runs there."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the measurement tools run on the card "
                "(run(device='cpu') rehearses one on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def labels(device):
    """What a result was measured on: ``{"device": "cuda" | "cpu",
    "card": nvidia-smi's name and power limit, or None on the CPU}``."""
    on_card = device.type == "cuda"
    return {"device": device.type, "card": card_line() if on_card else None}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_s(fn, device):
    """Host seconds of ``fn()`` up to ``torch.cuda.synchronize()`` on the
    card.  -> (seconds, what ``fn`` returned)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def leaf_numbers(obj, key=None):
    """-> [(key, value)] of every leaf number or ``None`` of a tool's
    result, each with the key it stands under."""
    if isinstance(obj, dict):
        return [kv for k, v in obj.items() for kv in leaf_numbers(v, k)]
    if isinstance(obj, (list, tuple)):
        return [kv for v in obj for kv in leaf_numbers(v, key)]
    if obj is None or (isinstance(obj, (int, float))
                       and not isinstance(obj, bool)):
        return [(key, obj)]
    return []


def emit(result, out_path=None):
    """Print a tool's ``result`` as one JSON line, and write it to
    ``out_path`` when given."""
    line = json.dumps(result)
    print(line)
    if out_path:
        with open(out_path, "w") as fh:
            fh.write(line + "\n")
