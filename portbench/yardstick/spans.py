"""Readers of the program's own call records (``paule_tpu_torch.tracing``),
which a call makes by itself when it starts under a recording profiler:
the units that a ``--trace 1`` run profiles.  From them the metrics read
only what the profiler does not distort, counts and device times of CUDA
events, never host durations.  A program without the tracer, or a run
without profiled calls, gives ``None``.

Each LSTM op record holds its family (``single``: one layer, ``pair``:
two stacked layers), direction, T, B, H, a count and its event-timed
device milliseconds, whatever kernel ran it; its least time comes from
the frozen bounds of :mod:`.bounds`, the same per shape as the
kernel-name rooflines count from the traffic.
"""

import importlib

from . import bounds

#: a cell's entry driver -> the scope of the program calls it makes
SCOPES = {"resynth": "plan_resynth", "corpus": "plan_batch_resynth"}
#: an op's (family, direction) -> the least time of its function
BOUNDS = {("single", "fwd"): bounds.lstm_fwd_bound,
          ("single", "bwd"): bounds.lstm_bwd_bound,
          ("pair", "fwd"): bounds.stack2_fwd_bound,
          ("pair", "bwd"): bounds.stack2_bwd_bound}


def records():
    """The program's finished call records; ``[]`` when it has no
    tracer."""
    try:
        tracing = importlib.import_module("paule_tpu_torch.tracing")
    except ImportError:
        return []
    return tracing.calls()


def profiled(calls, scope):
    """The records of ``calls`` of ``scope`` made under the profiler, or
    ``None``."""
    return [c for c in calls
            if c["scope"] == scope and c["profiled"]] or None


def op_roofline(calls, family):
    """Percent: the least time of ``family``'s recorded ops over their
    event-timed device seconds, or ``None`` without device times."""
    least = spent = 0.0
    for c in calls:
        for o in c["ops"]:
            if o["family"] != family or o["device_ms"] is None:
                continue
            least += o["count"] * BOUNDS[family, o["direction"]](
                o["T"], o["B"], o["H"])
            spent += o["device_ms"] / 1e3
    return 100.0 * least / spent if spent > 0 and least > 0 else None


def waits_per(calls, count):
    """The calls' ``host_waits`` per ``count`` (a number of inner steps)."""
    waits = sum(c["counters"]["host_waits"] for c in calls)
    return waits / count if count else None


def _calls(cell, driver):
    if cell.workload["driver"] != driver:
        return None
    return profiled(records(), SCOPES[driver])


def roofline(cell, driver, family):
    """:func:`op_roofline` of the cell's profiled calls."""
    calls = _calls(cell, driver)
    return None if calls is None else op_roofline(calls, family)


def host_waits_per_step(cell, driver):
    """The profiled calls' host waits per inner step of the traced
    units."""
    calls = _calls(cell, driver)
    if calls is None:
        return None
    return waits_per(calls, sum(u["inner_steps"] for u in cell.units
                                if u["traced"]))
