"""The arithmetic of the per-layer metrics; each metric's own file in
``portbench/metrics`` picks a reader and its arguments.  A reader that
finds nothing to read returns ``None``."""

from . import bounds, work


def _untraced(cell, driver):
    """The units of the window that ran without the profiler, or ``None``
    when the cell is not ``driver``'s or there are none."""
    if cell.workload["driver"] != driver:
        return None
    return [u for u in cell.units if not u["traced"]] or None


def phase_ms_per(cell, driver, phase, count):
    """Milliseconds of the program's ``<scope>.<phase>`` span
    (``last_planning_timings[phase]``) per ``count`` (a unit's
    ``inner_steps``, ``adam_steps`` or ``snapshots``), over the units that
    ran without the profiler."""
    units = _untraced(cell, driver)
    if not units:
        return None
    n = sum(u[count] for u in units)
    return 1e3 * sum(u["timings"][phase] for u in units) / n if n else None


def roofline(cell, driver, family, kernels):
    """Percent: the least time of the traced units' ``family`` kernel
    work (counted from the traffic) over the device time of the kernels
    named ``kernels`` in the trace."""
    if cell.workload["driver"] != driver or cell.trace is None:
        return None
    spent = cell.trace.seconds_of(kernels)
    least = sum(work.least_s(u["work"], family) for u in cell.units
                if u["traced"])
    return 100.0 * least / spent if spent > 0 and least > 0 else None


def idle(cell, driver):
    """Percent of the time in which a card ran no kernel or copy: one less
    the traced units' device-busy seconds (from the trace, averaged over
    the cards) over the host seconds that the same work took without the
    profiler: for each traced unit the wall of the untraced unit of the
    same shape (``key``) nearest to it in the window, so of nearly the
    same process age.  The profiler slows the host, so the traced
    window's own idle share would measure the profiler."""
    if _untraced(cell, driver) is None or cell.trace is None:
        return None
    expect = 0.0
    for i, u in enumerate(cell.units):
        if not u["traced"]:
            continue
        near = [(abs(j - i), v["wall"]) for j, v in enumerate(cell.units)
                if not v["traced"] and v["key"] == u["key"]]
        if not near:
            return None
        expect += min(near)[1]
    busy = sum(cell.trace.busy_s) / len(cell.trace.busy_s)
    if busy <= 0 or expect <= 0:
        return None
    return 100.0 * (1.0 - busy / expect)


def device_s_per(cell, driver, count):
    """Device-busy seconds (summed over the cards) per ``count`` (a
    unit's ``inner_steps``, or ``utterances``) of the traced units: the
    card's work, which the host's speed does not move."""
    if cell.workload["driver"] != driver or cell.trace is None:
        return None
    n = sum(u[count] for u in cell.units if u["traced"])
    busy = sum(cell.trace.busy_s)
    return busy / n if n and busy > 0 else None


def mfu(cell, driver):
    """Percent: the model FLOPs of the traffic of the units that ran
    without the profiler over their host seconds times the float32 peak
    of the cards used."""
    units = _untraced(cell, driver)
    if not units:
        return None
    total = sum(work.flops(u["work"]) for u in units)
    return 100.0 * total / (sum(u["wall"] for u in units) * bounds.PEAK_F32
                            * len(cell.devices))
