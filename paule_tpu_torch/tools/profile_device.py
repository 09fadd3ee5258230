"""Device profile of the hot planning loop, on the card (the port's
counterpart of ``tools/profile_device.py``).

Measures:

1. the phase split of a hot ``plan_resynth`` (3 outer iterations of the
   reference's budget: 25 inner steps, ``log_ii=1``, continue-learning 10
   epochs x 3 batches of 8) from ``Paule.last_planning_timings``, after a
   warm-up call of 1 outer iteration;
2. analytic FLOPs of the planning inner step (:func:`planning_step_flops`,
   the JAX tool's count) and the achieved FLOP/s of the planning phase,
   against the card's float32 rate (``timing.PEAK_F32``, 67 TFLOP/s: the
   port computes in full float32);
3. a ``torch.profiler`` trace of one more hot call of 1 outer iteration,
   not timed: per phase (the tracer's ``plan_resynth.<phase>.<leaf>``
   ranges grouped by phase) the seconds the card was busy (kernels and
   copies) and their share of the traced phase and of the untraced hot
   run's phase per outer iteration, the ten device operations that took
   the most time, the five longest idle gaps, each with the host
   operations that ran inside it, and per leaf its wall, busy and idle
   seconds;
4. the ``acoustic`` planning step at B=8 through
   ``parallel.batched.plan_batch_resynth`` (1 x 25 steps, no
   continue-learning): wall and FLOP/s, counting the forward model's
   FLOPs only (:func:`acoustic_step_flops`: that criterion runs no
   embedder).

A part that fails fails the run.

Run on the card::

    python -m paule_tpu_torch.tools.profile_device [--out FILE]

Prints one JSON line (with the card's name and power limit); without a
card it raises.
"""

import argparse
import bisect
import collections
import sys

import numpy as np
import torch

from ..api import Paule
from ..dsp.mel import librosa_melspec
from ..ops import lstm_kernels as K
from ..ops.normalize import normalize_mel
from ..parallel import batched as B
from . import timing
from .hot_timing import seeded_target

HIDDEN = 720
T_CP = 402  # 1 s utterance
TOP_OPS = 10
LONGEST_GAPS = 5
#: the batched row's batch size, as the JAX tool's
BATCH = 8
HOST_OPS_PER_GAP = 8


def lstm_flops(t_steps, in_size, hidden, layers=1):
    """2*MACs of one LSTM forward over t_steps (gates only; elementwise
    negligible)."""
    total = 0
    for li in range(layers):
        i = in_size if li == 0 else hidden
        total += t_steps * 2 * (i + hidden) * 4 * hidden
    return total


def planning_step_flops(t_cp, batch=1):
    """One planning inner step: ForwardModel fwd+bwd + Embedder fwd+bwd
    (acoustic_semvec criterion); bwd ~ 2x fwd for LSTMs."""
    t_mel = t_cp // 2
    fwd = lstm_flops(t_cp, 30, HIDDEN) + t_cp * 2 * HIDDEN * 60
    emb = lstm_flops(t_mel, 60, HIDDEN, layers=2) + 2 * HIDDEN * 300
    return batch * 3 * (fwd + emb)  # fwd + ~2x bwd


def acoustic_step_flops(t_cp, batch=1):
    """One planning inner step of the ``acoustic`` criterion: ForwardModel
    fwd+bwd only (the embedder is not run); bwd ~ 2x fwd."""
    return batch * 3 * (lstm_flops(t_cp, 30, HIDDEN) + t_cp * 2 * HIDDEN * 60)


def _union(intervals):
    """Sorted, disjoint cover of ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(a, b, lo, hi):
    return max(0.0, min(b, hi) - max(a, lo))


def _gaps(busy, a, b):
    """The parts of ``[a, b)`` that the disjoint sorted ``busy`` leaves
    uncovered."""
    out, t = [], a
    i = max(bisect.bisect_right([u[0] for u in busy], a) - 1, 0)
    for lo, hi in busy[i:]:
        if lo >= b:
            break
        if hi <= t:
            continue
        if lo > t:
            out.append((t, lo))
        t = max(t, hi)
    if t < b:
        out.append((t, b))
    return out


def split_trace(events, scope="plan_resynth", phases=None):
    """Per phase of a trace's ``events`` (``prof.events()``), from the
    tracer's ``<scope>.<phase>.<leaf>`` ranges (``paule_tpu_torch.
    tracing``) grouped by phase: its wall seconds, the seconds in which the
    card ran a kernel or a copy and their share, the :data:`TOP_OPS`
    device operations that took the most time in it, its
    :data:`LONGEST_GAPS` longest device-idle gaps, each with the host
    operations that overlap it (by name, ms of overlap; nested host ranges
    each count), and ``leaves``, each leaf's wall and device-busy seconds
    and its number of ranges.  ``phases``: the phases to report (default:
    all).  -> {phase: dict}."""
    windows = collections.defaultdict(list)
    leaves = collections.defaultdict(list)
    device, host = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a profiler range mirrored on the device is no device work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(scope + ".")):
                device.append((span, e.name))
        elif e.name.startswith(scope + "."):
            phase = e.name.split(".")[1]
            if phases is None or phase in phases:
                windows[phase].append(span)
                if e.name.count(".") == 2:
                    leaves[e.name].append(span)
        else:
            host.append((span, e.name))
    busy = _union(span for span, _name in device)
    out = {}
    for phase, spans in windows.items():
        spans.sort()
        wall = sum(b - a for a, b in spans)
        ops = collections.defaultdict(lambda: [0.0, 0])
        for (a, b), name in device:
            inside = sum(_overlap(a, b, lo, hi) for lo, hi in spans)
            if inside > 0:
                ops[name][0] += inside
                ops[name][1] += 1
        gaps = sorted((g for lo, hi in spans for g in _gaps(busy, lo, hi)),
                      key=lambda g: g[1] - g[0], reverse=True)
        on = wall - sum(b - a for lo, hi in spans
                        for a, b in _gaps(busy, lo, hi))
        out[phase] = {
            "wall_s": wall / 1e6,
            "device_busy_s": on / 1e6 if device else None,
            "device_busy_share": on / wall if device and wall else None,
            "top_device_ops": [
                {"name": name, "ms": us / 1e3, "count": n}
                for name, (us, n) in sorted(ops.items(),
                                            key=lambda kv: -kv[1][0])
                [:TOP_OPS]],
            "idle_gaps": [
                {"start_ms": (a - spans[0][0]) / 1e3, "ms": (b - a) / 1e3,
                 "host_ops": _host_ops_in(host, a, b)}
                for a, b in gaps[:LONGEST_GAPS]] if device else [],
            "leaves": {},
        }
    for name, spans in leaves.items():
        wall = sum(b - a for a, b in spans)
        idle = sum(b - a for lo, hi in spans for a, b in _gaps(busy, lo, hi))
        _scope, phase, leaf = name.split(".")
        out[phase]["leaves"][leaf] = {
            "wall_s": wall / 1e6, "count": len(spans),
            "device_busy_s": (wall - idle) / 1e6 if device else None}
    return out


def _host_ops_in(host, a, b):
    """The host operations overlapping ``[a, b)``, by name, the
    :data:`HOST_OPS_PER_GAP` with the most overlap."""
    by_name = collections.Counter()
    for (lo, hi), name in host:
        if lo < b and hi > a:
            by_name[name] += _overlap(lo, hi, a, b)
    return [{"name": name, "ms": us / 1e3}
            for name, us in by_name.most_common(HOST_OPS_PER_GAP)]


def trace(fn, device):
    """``fn()`` once under ``torch.profiler`` (the card's activities too
    on a CUDA device).  -> the trace's events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        timing.sync(device)
    return prof.events()


def run(*, device="cuda", paule=None, t_cp=T_CP, n_inner=25, n_outer=3,
        n_epochs=10, n_batches=3, batch_size=8):
    """The four parts above.  ``paule``: the instance to plan with
    (default ``Paule(seed=1)`` on ``device``, closed afterwards).  -> the
    result as a JSON-able dict; on the CPU the device metrics (FLOP/s,
    utilisation, device-busy time) are ``None``."""
    device = timing.open_device(device)
    on_card = device.type == "cuda"
    target = seeded_target(t_cp)
    kw = dict(target_acoustic=target, objective="acoustic_semvec",
              initialize_from="acoustic", log_ii=1, log_semantics=True,
              n_inner=n_inner, n_batches=n_batches, batch_size=batch_size,
              n_epochs=n_epochs, continue_learning=True, verbose=False)
    p = paule if paule is not None else Paule(seed=1, device=device)
    try:
        print("[profile] warm-up...", file=sys.stderr, flush=True)
        p.plan_resynth(n_outer=1, **kw)
        print(f"[profile] hot run ({n_outer} outers)...", file=sys.stderr,
              flush=True)
        K.reset_launch_counts()
        wall, _r = timing.wall_s(lambda: p.plan_resynth(n_outer=n_outer,
                                                        **kw), device)
        launches = {k.__name__: k.launches for k in K.KERNELS}
        split = dict(p.last_planning_timings)
        print("[profile] traced run (1 outer)...", file=sys.stderr,
              flush=True)
        phases = split_trace(trace(lambda: p.plan_resynth(n_outer=1, **kw),
                                   device), phases=split)

        tmel = normalize_mel(librosa_melspec(*target, device=p.device,
                                             dtype=p.dtype))
        tmels = np.stack([tmel] * BATCH)
        bkw = dict(objective="acoustic", n_outer=1, n_inner=n_inner,
                   continue_learning=False)
        B.plan_batch_resynth(p, tmels, None, **bkw)  # warm
        tb, _out = timing.wall_s(
            lambda: B.plan_batch_resynth(p, tmels, None, **bkw), device)
    finally:
        if paule is None:
            p.close()

    for phase, v in phases.items():
        # the profiler slows the host, not the card: the busy time also as
        # a share of the untimed hot run's phase wall per outer iteration
        per_outer = split[phase] / n_outer
        v["untraced_wall_s_per_outer"] = per_outer
        v["device_busy_share_of_untraced"] = (
            v["device_busy_s"] / per_outer
            if v["device_busy_s"] is not None and per_outer > 0 else None)
    flops = n_outer * n_inner * planning_step_flops(t_cp)
    flops_per_s = flops / split["planning"]
    bflops = n_inner * acoustic_step_flops(t_cp, batch=BATCH)
    return {
        "backend": device.type, **timing.labels(device),
        "lstm_kernels_active": all(launches.values()),
        "launches": launches,
        "budget": (f"{n_outer} outers x {n_inner} inner, log_ii=1, "
                   f"continue-learning {n_epochs} epochs x {n_batches} "
                   f"batches of {batch_size}"),
        "wall_s": wall,
        "phase_split_s": split,
        "phase_split_pct": {k: 100 * v / split["total"]
                            for k, v in split.items() if k != "total"},
        "planning_flops_analytic": flops,
        "planning_flops_per_s": flops_per_s if on_card else None,
        "mfu_vs_f32_peak_B1": (flops_per_s / timing.PEAK_F32 if on_card
                               else None),
        f"batched_B{BATCH}": {
            "batch": BATCH, "objective": "acoustic",
            "flops_analytic": bflops, "wall_s_per_outer": tb,
            "flops_per_s": bflops / tb if on_card else None,
            "mfu_vs_f32_peak": (bflops / tb / timing.PEAK_F32 if on_card
                                else None)},
        "profiler_trace": phases,
        "notes": ("B=1 LSTM planning is bound by the recurrence's chain of "
                  "dependent steps, not by FLOPs, so its FLOP utilisation "
                  "is low; the batched row is the throughput mode. The "
                  "trace's phases come from one more call of 1 outer "
                  "iteration, not timed."),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    timing.emit(run(device="cuda"), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
