"""The fixed cost of one LSTM kernel call against its cost per time step,
on the card (the port's counterpart of ``tools/launch_overhead_probe.py``).

A chain of K dependent calls of the forward model's recurrence
(``LSTMCore``: B1, and B2 with the gradient), each of length T, costs::

    wall(K, T) = dispatch + K * (fixed + T * s)

The slope over K at each T gives the cost of one call; two values of T
give the per-step cost ``s`` and the fixed cost per call ``fixed``
independently, the K-slope cancelling the dispatch.  The sweep is the JAX
tool's: H=720, B=1, T in (64, 256), K in (1, 8), the least of 8 host walls
each ending in a fetch of the chain's scalar.  On the card the same sweep
is fitted once more on device time (CUDA events around one chain), which
splits the fixed cost into what the device spends per launch and what
the host adds.

The projection bills the fixed cost of the launch pairs one planning
inner step runs and sets the bill beside the gap between the measured
inner step and its recurrence floor, both from
:func:`paule_tpu_torch.tools.roofline.run` at B=1 in the same process.

Run on the card::

    python -m paule_tpu_torch.tools.launch_overhead_probe [--out FILE]

Prints one JSON line (with the card's name and power limit); without a
card it raises.
"""

import argparse
import sys
import time

import numpy as np
import torch

from ..ops.lstm_kernels import LSTMCore
from . import roofline, timing

H = 720
B = 1
REPS = 8
T_LENS = (64, 256)
K_CALLS = (1, 8)
#: one planning inner step (acoustic_semvec) launches two pairs: B1 + B2
#: for the forward model and B3 + B4 for the embedder, whose two layers are
#: one fused pair (PERF.md's launch counts over the main path's 50 inner
#: steps: 50 B1 and 48 B2 at (402, 1), 53 B3 and 48 B4 at (201, 1))
LAUNCH_PAIRS_PER_INNER_STEP = 2


def chain_fn(k_calls, grad, *, hidden=H, batch=B, device):
    """-> ``fn(gates (T, B, 4H), w_hh (H, 4H))`` that chains ``k_calls``
    dependent ``LSTMCore`` calls, each from the previous call's last
    states, and returns the sum of every call's hidden states
    (``tools/launch_overhead_probe.py:58-81``); with ``grad``, the sum of
    the gradients of that sum with respect to ``gates`` and ``w_hh``."""

    def chain(gates, w_hh):
        h = c = torch.zeros((batch, hidden), device=device, dtype=gates.dtype)
        out = 0.0
        for _ in range(k_calls):
            hs, cs = LSTMCore.apply(gates, w_hh, h, c)
            # the next call starts from this call's final state, so the
            # calls cannot overlap
            h, c = hs[-1], cs[-1]
            out = out + hs.sum()
        return out

    if not grad:
        return chain

    def chain_grad(gates, w_hh):
        leaves = [x.detach().requires_grad_(True) for x in (gates, w_hh)]
        with torch.enable_grad():
            grads = torch.autograd.grad(chain(*leaves), leaves)
        # one scalar, so that a fetch waits for the whole chain
        return sum(g.sum() for g in grads)
    return chain_grad


def host_s(fn, args, reps):
    """Least host wall in seconds of ``fn(*args).item()`` over ``reps``
    calls after two warm-up calls: the fetch waits for the device."""
    fn(*args).item()
    fn(*args).item()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args).item()
        walls.append(time.perf_counter() - t0)
    return min(walls)


def device_s(fn, args, reps):
    """Least device time in seconds of one ``fn(*args)`` over ``reps``
    calls after a warm-up: CUDA events recorded before and after the call
    on the current stream, so that the time includes any wait of the
    device for the host between the chain's launches."""
    fn(*args).item()
    best = np.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def fit_launch_cost(walls):
    """``{(T, K): seconds}`` at two Ts -> the per-call cost at each T (the
    least-squares slope over K), the per-step cost (the slope between the
    Ts) and the fixed cost per call (the intercept), rounded as the JAX
    tool rounds them (``tools/launch_overhead_probe.py:103-115``)."""
    t_lo, t_hi = sorted({t for t, _k in walls})
    ks = sorted({k for _t, k in walls})
    percall = {}
    for t in (t_lo, t_hi):
        ws = np.array([walls[(t, k)] for k in ks])
        percall[t] = np.polyfit(np.array(ks, float), ws, 1)[0]
    s = (percall[t_hi] - percall[t_lo]) / (t_hi - t_lo)
    fixed = percall[t_lo] - t_lo * s
    return {"per_call_cost_ms": {str(t): round(v * 1e3, 4)
                                 for t, v in percall.items()},
            "per_step_us": round(s * 1e6, 4),
            "per_launch_fixed_us": round(fixed * 1e6, 2)}


def walls_ms(walls):
    return {f"T{t}_K{k}": round(v * 1e3, 3) for (t, k), v in walls.items()}


def run(*, device="cuda", hidden=H, reps=REPS, roofline_kw=None):
    """The sweep, its fits and the projection.  ``roofline_kw``: keywords
    of the B=1 :func:`~paule_tpu_torch.tools.roofline.run` that gives the
    measured-minus-floor gap (default: its full budget at ``hidden``).
    -> the result as a JSON-able dict."""
    device = timing.open_device(device)
    on_card = device.type == "cuda"
    rng = np.random.default_rng(0)

    def tensor(shape, scale):
        return torch.as_tensor(rng.normal(0, scale, shape),
                               dtype=torch.float32, device=device)

    w_hh = tensor((hidden, 4 * hidden), 0.02)
    out = {"backend": device.type, "hidden": hidden, "batch": B,
           "reps": reps, "walls_ms": {}, "per_launch": {},
           "per_launch_device": {} if on_card else None,
           "device_walls_ms": {} if on_card else None}
    for grad in (False, True):
        tag = "fwdbwd" if grad else "fwd"
        host, dev = {}, {}
        for t in T_LENS:
            gates = tensor((t, B, 4 * hidden), 0.1)
            for k in K_CALLS:
                fn = chain_fn(k, grad, hidden=hidden, device=device)
                host[(t, k)] = host_s(fn, (gates, w_hh), reps)
                if on_card:
                    dev[(t, k)] = device_s(fn, (gates, w_hh), reps)
                print(f"[launch] {tag} T={t} K={k}: host "
                      f"{host[(t, k)] * 1e3:.3f} ms" + (
                          f", device {dev[(t, k)] * 1e3:.3f} ms"
                          if on_card else ""), file=sys.stderr, flush=True)
        out["per_launch"][tag] = fit_launch_cost(host)
        out["walls_ms"][tag] = walls_ms(host)
        if on_card:
            out["per_launch_device"][tag] = fit_launch_cost(dev)
            out["device_walls_ms"][tag] = walls_ms(dev)

    roof = roofline.run(device=device, batches=(1,), hidden=hidden,
                        **(roofline_kw or {}))["derived_vs_measured"]["B1"]

    def bill_ms(fits):
        return (LAUNCH_PAIRS_PER_INNER_STEP
                * fits["fwdbwd"]["per_launch_fixed_us"] / 1e3)

    out["projection"] = {
        "launch_pairs_per_inner_step": LAUNCH_PAIRS_PER_INNER_STEP,
        "fixed_cost_bill_ms": bill_ms(out["per_launch"]),
        "device_fixed_cost_bill_ms": (bill_ms(out["per_launch_device"])
                                      if on_card else None),
        "measured_minus_floor_ms": (roof["measured_ms_per_inner_step"]
                                    - roof["derived_floor_ms"]),
        "measured_ms_per_inner_step": roof["measured_ms_per_inner_step"],
        "derived_floor_ms": roof["derived_floor_ms"],
        "note": "fixed_cost_bill = launch pairs per inner step x the "
                "fwdbwd fixed cost per call, against the gap between the "
                "measured inner step and its recurrence floor (roofline, "
                "B=1, this process): if they are comparable, fewer launches "
                "is the attack. The fwdbwd fixed cost also holds the glue "
                "between B1 and B2 (the activation recompute and the w_hh "
                "gradient einsum) and autograd's own work. B3/B4's fixed "
                "cost per call is taken as B1/B2's, an assumption: this "
                "probe does not chain the embedder's pair",
    }
    return {**out, **timing.labels(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    timing.emit(run(device="cuda"), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
