"""Reading a ``torch.profiler`` trace into small sums: the seconds in
which each card ran a kernel or a copy, kernel time by name, the device
operations that took most time and the longest idle gaps with the host
operations inside them.  Nothing of the trace is written out.

``_union``, ``_overlap`` and ``_gaps`` are frozen copies of
``paule_tpu_torch/tools/profile_device.py:80-114``; ``summarize`` follows
its ``split_trace`` (``:117-165``) and ``_host_ops_in`` (``:168-176``)
over one window instead of per phase.
"""

import bisect
import collections

#: the annotation the harness puts around the traced calls
WINDOW = "portbench.window"
TOP = 10


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


class Summary:
    """What the metric readers take from a trace: ``window_s``, per card
    ``busy_s``, ``kernel_s`` (device seconds by kernel name),
    ``device_ops`` and ``idle_gaps`` (``[[name, seconds], ...]``)."""

    def __init__(self, window_s, busy_s, kernel_s, device_ops, idle_gaps):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernel_s = kernel_s
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps

    def seconds_of(self, names):
        """Device seconds of the kernels whose names contain one of
        ``names``."""
        return sum(s for k, s in self.kernel_s.items()
                   if any(n in k for n in names))


def summarize(records, n_devices):
    """``records``: ``(start_us, end_us, name, on_device, device_index,
    is_annotation)`` of each trace event.  -> :class:`Summary` of the
    span of the :data:`WINDOW` annotation."""
    spans = [(a, b) for a, b, name, dev, _i, _ann in records
             if not dev and name == WINDOW]
    if not spans:
        raise ValueError("the trace holds no window annotation")
    lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
    per_dev = collections.defaultdict(list)
    kernel_s = collections.Counter()
    host = []
    for a, b, name, dev, index, ann in records:
        if dev:
            # a profiler range mirrored on the device is no device work
            if (ann or name.startswith(("plan_", "portbench."))
                    or b <= lo or a >= hi):
                continue
            a, b = max(a, lo), min(b, hi)
            per_dev[index].append((a, b))
            kernel_s[name] += (b - a) / 1e6
        elif name != WINDOW:
            host.append((a, b, name))
    busy = {i: _union(v) for i, v in per_dev.items()}
    busy_s = [sum(b - a for a, b in busy.get(i, [])) / 1e6
              for i in range(n_devices)]
    first = busy.get(0, [])
    gaps = sorted(_gaps(first, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    return Summary(
        window_s=(hi - lo) / 1e6, busy_s=busy_s, kernel_s=dict(kernel_s),
        device_ops=[[n, s] for n, s in kernel_s.most_common(TOP)],
        idle_gaps=[[_host_ops_in(host, a, b), (b - a) / 1e6]
                   for a, b in gaps])


def _host_ops_in(host, a, b, n=2):
    """The names of the ``n`` host operations with the most overlap with
    ``[a, b)``, joined."""
    by_name = collections.Counter()
    for lo, hi, name in host:
        if lo < b and hi > a:
            by_name[name] += _overlap(lo, hi, a, b)
    return " | ".join(name for name, _ in by_name.most_common(n)) or "none"


def records(events):
    """``torch.profiler`` events -> the tuples :func:`summarize` takes."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.time_range.start, e.time_range.end, e.name,
             e.device_type == cuda, getattr(e, "device_index", 0),
             bool(getattr(e, "is_user_annotation", False)))
            for e in events]
