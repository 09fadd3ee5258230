"""Readers of what the program's call records (``paule_tpu_torch.tracing``)
say per model and per device span, and what :mod:`.spans` reads, for
drivers it does not name: the LSTM ops of named models (each op
record's ``models``), the op rooflines and host waits of a driver, the
tube models' share of continue-learning
(``last_planning_timings["continue_learning_tube"]``) and the device
span ``sync_replicas``.  A program whose records lack these gives
``None``, as does a run without profiled calls."""

from . import spans

#: the models that ``continue_learning_tube`` trains
TUBE_MODELS = ("cp_tube", "tube_mel")


def model_op_roofline(calls, models):
    """Percent: the least time of the LSTM ops that ``models`` launched,
    each at its own (T, B, H), over their event-timed device seconds, or
    ``None`` without such ops or device times."""
    least = spent = 0.0
    for c in calls:
        for o in c["ops"]:
            for model, part in o.get("models", {}).items():
                if model not in models or part["device_ms"] is None:
                    continue
                least += part["count"] * spans.BOUNDS[
                    o["family"], o["direction"]](o["T"], o["B"], o["H"])
                spent += part["device_ms"] / 1e3
    return 100.0 * least / spent if spent > 0 and least > 0 else None


def _profiled(cell, driver):
    if cell.workload["driver"] != driver:
        return None
    return spans.profiled(spans.records(), "plan_batch_resynth")


def op_roofline(cell, driver, family):
    """:func:`.spans.op_roofline` of the cell's profiled calls, for a
    driver that :data:`.spans.SCOPES` does not name."""
    calls = _profiled(cell, driver)
    return None if calls is None else spans.op_roofline(calls, family)


def host_waits_per_step(cell, driver):
    """:func:`.spans.host_waits_per_step` for a driver that
    :data:`.spans.SCOPES` does not name."""
    calls = _profiled(cell, driver)
    if calls is None:
        return None
    return spans.waits_per(calls, sum(u["inner_steps"] for u in cell.units
                                      if u["traced"]))


def tube_op_roofline(cell, driver):
    """:func:`model_op_roofline` of the tube models in the cell's profiled
    calls."""
    calls = _profiled(cell, driver)
    return None if calls is None else model_op_roofline(calls, TUBE_MODELS)


def tube_cl_ms_per_step(cell, driver):
    """Milliseconds of ``continue_learning_tube`` per Adam step of a tube
    model, over the units that ran without the profiler."""
    if cell.workload["driver"] != driver:
        return None
    units = [u for u in cell.units if not u["traced"]]
    if not units or any("continue_learning_tube" not in u["timings"]
                        for u in units):
        return None
    n = sum(u["tube_adam_steps"] for u in units)
    return (1e3 * sum(u["timings"]["continue_learning_tube"]
                      for u in units) / n if n else None)


def device_span_ms_per(cell, driver, name, count):
    """Device milliseconds of the span ``name`` in the profiled calls per
    ``count`` (a unit's ``adam_steps``) of the traced units, or ``None``
    where no call recorded it with device times."""
    calls = _profiled(cell, driver)
    if calls is None:
        return None
    ms = [c.get("device_spans", {}).get(name, {}).get("device_ms")
          for c in calls]
    if any(m is None for m in ms):
        return None
    n = sum(u[count] for u in cell.units if u["traced"])
    return sum(ms) / n if n and sum(ms) > 0 else None
