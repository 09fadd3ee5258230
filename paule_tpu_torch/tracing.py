"""The port's tracer: one record per traced call of an entry point
(``Paule.plan_resynth``, ``parallel.batched.plan_batch_resynth``) that
says where the call's host and device time went.

Switch.  Tracing is off by default.  A call is traced when
:func:`enable` was called, when it starts while a ``torch.profiler`` is
recording (checked once, as the call starts), or when it starts inside
another traced call.  While no traced call is open, the module-level
boolean :data:`ON` is false, and every span, op and counter site of the
port tests it and does nothing more: no clock read, no
``record_function``, no CUDA event.  Only the phases' wall times, which
``last_planning_timings`` always keeps (with the batched planner's
``continue_learning_tube``), are read then.

Spans.  A call holds phases (``planning``, ``synthesis``, ``metrics``,
``continue_learning``, and ``prelude`` and ``final`` for the code before
and after the outer loop), each entry of a phase a span of its own, and
each phase holds leaf spans that tile it: a leaf runs from its mark
(:func:`leaf`) to the next mark, the phase's end or the call's end.  A
leaf is named ``<scope>.<phase>.<leaf>``, e.g.
``plan_resynth.synthesis.wait``.  Every span keeps its id, its parent's
id (0: the call), its name and its host start and end
(``time.perf_counter_ns``); on a CUDA call also its device start and end:
a pooled timing-event pair on the call's stream, put on the host's clock
through an event recorded as the call starts, and read when the call
closes, after its last host fetch (no synchronize inside the call).  The
device start minus the host start of a span is how far the card lagged
behind the host there.  Under a recording profiler the leaves alone are
also ``record_function`` ranges, so a trace's idle gaps are named by the
leaves that overlap them; phases stay in the record.

LSTM ops.  The four kernel wrappers of :mod:`.ops.lstm_kernels` record
each call's family (``single``: B1/B2, ``pair``: B3/B4), direction
(``fwd``/``bwd``), T, B and H, and on a CUDA tensor an event pair that
the launch records right before and after the kernel; a call's record
sums them by (family, direction, T, B, H) as
a count and device milliseconds (``None`` on the CPU), and split each
sum by the model that launched the op (``models``): ``Paule`` names its
models (``predictive``, ``inverse``, ``embedder``, ``cp_tube``,
``tube_mel``, ``tube_embedder``) as a traced call starts, a model's LSTM
stack runs under its name (:func:`set_model`), and a backward op takes
the name its forward saw; an op of no named model counts as ``other``.
B2 and B4 run on the autograd engine's device thread, so the open call
is process-wide.

Device spans.  A stretch of device work with no kernel of its own, such
as the weight copies of ``parallel.mesh.sync_replicas``, is timed by an
event pair on its card's current stream (:func:`device_span_start`,
:func:`device_span_end`); a call's record sums them by name as a count
and device milliseconds (``None`` on the CPU).

Counters (per call): ``host_waits``, the points where the call's own
thread blocks on the device (a device-to-host copy, a synchronous
host-to-device copy, an event or device synchronize), and
``worker_waits``, the same on other threads (the synthesis thread);
``d2h_bytes`` and ``h2d_bytes``; ``adam_steps`` by model;
``snapshots`` synthesised; ``sync_replicas`` calls that copied and
``sync_replicas_bytes``; ``lstm_bwd_tiled``, the B2 launches that took
the tiled layout (``ops.lstm_kernels.TiledPlan``).

A call opened inside another adds its ops and counters to the outer
one's when it closes.  :func:`calls` returns the last 64 finished
records, which outlive the ``Paule`` that made them.
"""

import collections
import contextlib
import functools
import itertools
import threading
import time

import torch

#: a traced call is open: spans, ops and counters record
ON = False
#: :func:`enable` was called: every call is traced
_enabled = False
#: the open traced calls, innermost last
_stack = []
#: the finished call records, newest last
_done = collections.deque(maxlen=64)
_ids = itertools.count(1)
_lock = threading.Lock()
#: free timing events, by CUDA device index
_pool = collections.defaultdict(list)
#: the model whose LSTM stack runs now, or ``None`` (:func:`set_model`);
#: the models' forwards run on the call's thread, and a backward op takes
#: the name its forward saw
MODEL = None
#: the ``models`` name of an op launched outside every named model
OTHER = "other"

COUNTERS = ("host_waits", "worker_waits", "d2h_bytes", "h2d_bytes",
            "snapshots", "sync_replicas", "sync_replicas_bytes",
            "lstm_bwd_tiled")


def enable(on=True):
    """Trace every call from now on (``on=False``: only profiled ones)."""
    global _enabled
    _enabled = bool(on)


def calls():
    """The finished call records, oldest first (at most 64): dicts of
    ``id``, ``parent`` (the enclosing call's id or ``None``), ``scope``,
    ``profiled``, ``device``, ``host_start_ns``, ``host_end_ns``,
    ``device_start_ns``, ``device_end_ns``, ``spans``, ``ops``,
    ``device_spans`` and ``counters`` (module docstring)."""
    return list(_done)


def clear():
    """Forget the finished records."""
    _done.clear()


def _event(index):
    """A timing event of CUDA device ``index`` from the pool."""
    free = _pool[index]
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("id", "parent", "name", "kind", "t0", "e0", "t1", "e1",
                 "rf")

    def __init__(self, sid, parent, name, kind, at):
        self.id, self.parent, self.name, self.kind = sid, parent, name, kind
        self.t0, self.e0 = at
        self.t1 = self.e1 = self.rf = None


class _Call:
    """An open traced call.  A span boundary is a mark: one host clock
    reading and, on a CUDA call, one event on the call's stream, shared by
    the span that ends there and the one that starts."""

    def __init__(self, scope, device, profiled, parent):
        self.id = next(_ids)
        self.scope = scope
        self.parent = parent
        self.profiled = profiled
        self.thread = threading.get_ident()
        self.device = device if device is not None and (
            device.type == "cuda") else None
        self.spans = []
        self.phase = self.leaf = None
        #: the marks' events, in order
        self.marks = []
        #: (key, start event, end event, device index, model) per op;
        #: the events and index ``None`` on the CPU
        self.ops = []
        #: (name, start event, end event, device index) per device span
        self.timed = []
        #: {(key, model): [count, device ms or None]} of the ops, and
        #: {name: [count, device ms or None]} of the device spans, of the
        #: calls closed inside this one
        self.merged = collections.defaultdict(lambda: [0, None])
        self.merged_spans = collections.defaultdict(lambda: [0, None])
        self.counters = collections.Counter()
        self.adam = collections.Counter()
        self.record = None
        self.stream = None
        if self.device is not None:
            self.stream = torch.cuda.current_stream(self.device)
        self.start = self.mark()

    def mark(self):
        """-> ``(host ns, event or None)``, taken now."""
        ev = None
        if self.stream is not None:
            ev = _event(self.device.index)
            ev.record(self.stream)
            self.marks.append(ev)
        return time.perf_counter_ns(), ev

    def begin(self, name, kind, parent, at):
        span = _Span(len(self.spans) + 1, parent, name, kind, at)
        self.spans.append(span)
        return span

    @staticmethod
    def end(span, at):
        if span.rf is not None:
            span.rf.__exit__(None, None, None)
        span.t1, span.e1 = at

    def end_leaf(self, at):
        if self.leaf is not None:
            self.end(self.leaf, at)
            self.leaf = None

    def end_phase(self, at):
        self.end_leaf(at)
        if self.phase is not None:
            self.end(self.phase, at)
            self.phase = None

    def close(self):
        """End what is open, read the events (the call's last fetch is
        behind it, so they have completed) and make :attr:`record`."""
        stop = self.mark()
        self.end_phase(stop)
        last = {index: e1 for _key, _e0, e1, index, *_ in self.ops
                + self.timed if e1 is not None}
        if stop[1] is not None:
            last[self.device.index] = stop[1]
        for ev in last.values():
            ev.synchronize()
        t0, anchor = self.start
        device_ns = {}
        if anchor is not None:
            device_ns = {id(ev): t0 + int(round(anchor.elapsed_time(ev)
                                                * 1e6))
                         for ev in self.marks}
            _pool[self.device.index].extend(self.marks)
        spans = [{"id": s.id, "parent": s.parent, "name": s.name,
                  "kind": s.kind, "host_start_ns": s.t0,
                  "host_end_ns": s.t1,
                  "device_start_ns": device_ns.get(id(s.e0)),
                  "device_end_ns": device_ns.get(id(s.e1))}
                 for s in self.spans]
        agg = collections.defaultdict(lambda: [0, None])
        for key, e0, e1, index, model in self.ops:
            _add(agg[key, model], 1, _elapsed(e0, e1, index))
        for key, (n, ms) in self.merged.items():
            _add(agg[key], n, ms)
        timed = collections.defaultdict(lambda: [0, None])
        for name, e0, e1, index in self.timed:
            _add(timed[name], 1, _elapsed(e0, e1, index))
        for name, (n, ms) in self.merged_spans.items():
            _add(timed[name], n, ms)
        shapes = collections.defaultdict(lambda: [0, None, {}])
        for (key, model), (n, ms) in sorted(
                agg.items(), key=lambda kv: (kv[0][0], kv[0][1] or "")):
            entry = shapes[key]
            _add(entry, n, ms)
            entry[2][model or OTHER] = {"count": n, "device_ms": ms}
        counters = {k: self.counters[k] for k in COUNTERS}
        counters["adam_steps"] = dict(self.adam)
        self.record = {
            "id": self.id, "parent": None if self.parent is None
            else self.parent.id, "scope": self.scope,
            "profiled": self.profiled,
            "device": None if self.device is None else str(self.device),
            "host_start_ns": t0, "host_end_ns": stop[0],
            "device_start_ns": device_ns.get(id(anchor)),
            "device_end_ns": device_ns.get(id(stop[1])),
            "spans": spans,
            "ops": [{"family": f, "direction": d, "T": t, "B": b, "H": h,
                     "count": n, "device_ms": ms, "models": models}
                    for (f, d, t, b, h), (n, ms, models) in shapes.items()],
            "device_spans": {name: {"count": n, "device_ms": ms}
                             for name, (n, ms) in sorted(timed.items())},
            "counters": counters}
        if self.parent is not None:
            for key, (n, ms) in agg.items():
                _add(self.parent.merged[key], n, ms)
            for name, (n, ms) in timed.items():
                _add(self.parent.merged_spans[name], n, ms)
            with _lock:
                self.parent.counters.update(self.counters)
                self.parent.adam.update(self.adam)


def _elapsed(e0, e1, index):
    """The milliseconds between two completed events, which go back to the
    pool; ``None`` without events (the CPU)."""
    if e0 is None:
        return None
    _pool[index].extend((e0, e1))
    return e0.elapsed_time(e1)


def _add(entry, n, ms):
    """Add ``n`` ops and ``ms`` device milliseconds (or ``None``) to an
    aggregate ``[count, ms]``."""
    entry[0] += n
    if ms is not None:
        entry[1] = (entry[1] or 0.0) + ms


@contextlib.contextmanager
def call(scope, device=None, force=False):
    """A call of the entry point ``scope`` on ``device`` (a
    ``torch.device`` or ``None``): traced as the module docstring says, or
    always with ``force``.  Yields the open call (``None`` when it is not
    traced); its ``record`` is filled in when the block ends."""
    global ON
    profiled = torch._C._autograd._profiler_enabled()
    if not (force or _enabled or ON or profiled):
        yield None
        return
    rec = _Call(scope, None if device is None else torch.device(device),
                profiled, _stack[-1] if _stack else None)
    _stack.append(rec)
    ON = True
    try:
        yield rec
    finally:
        _stack.remove(rec)
        ON = bool(_stack)
        rec.close()
        _done.append(rec.record)


def entry(scope):
    """Decorator of an entry point whose first argument (``self`` or a
    ``Paule``) has a ``device``: each call runs inside :func:`call`."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(owner, *args, **kwargs):
            with call(scope, owner.device):
                return fn(owner, *args, **kwargs)
        return traced
    return wrap


def _open_call():
    """The innermost open call if this is its thread, else ``None``."""
    if _stack and _stack[-1].thread == threading.get_ident():
        return _stack[-1]
    return None


@contextlib.contextmanager
def phase(timings, name):
    """A phase of the open call: its wall seconds are added to
    ``timings[name]`` (always, unless ``timings`` is ``None``), and while
    tracing it is a span that ends whatever phase and leaf were open."""
    t0 = time.perf_counter() if timings is not None else None
    rec = _open_call() if ON else None
    if rec is None:
        yield
    else:
        at = rec.mark()
        rec.end_phase(at)
        span = rec.phase = rec.begin(f"{rec.scope}.{name}", "phase", 0, at)
        yield
        if rec.phase is span:
            rec.end_phase(rec.mark())
    if t0 is not None:
        timings[name] += time.perf_counter() - t0


def leaf(name, phase=None):
    """Call only while :data:`ON`.  Start leaf ``name`` of the open phase,
    ending the leaf before it (a leaf of the same name goes on); with
    ``phase``, first end the open phase unless it is ``phase``, and open
    ``phase`` (prelude and final code, which is no block).  A mark outside
    a phase, or on another thread than the call's, does nothing."""
    rec = _open_call()
    if rec is None:
        return
    at = None
    if phase is not None and (rec.phase is None or rec.phase.name
                              != f"{rec.scope}.{phase}"):
        at = rec.mark()
        rec.end_phase(at)
        rec.phase = rec.begin(f"{rec.scope}.{phase}", "phase", 0, at)
    if rec.phase is None:
        return
    full = f"{rec.phase.name}.{name}"
    if rec.leaf is not None and rec.leaf.name == full:
        return
    at = at or rec.mark()
    rec.end_leaf(at)
    span = rec.leaf = rec.begin(full, "leaf", rec.phase.id, at)
    if rec.profiled:
        span.rf = torch.profiler.record_function(full)
        span.rf.__enter__()


def op_events(device):
    """Call only while :data:`ON`: a pair of timing events of CUDA
    ``device`` for a kernel launch to record right before and after the
    kernel (``CudaLibrary.launch(..., events=)``)."""
    return _event(device.index), _event(device.index)


def set_model(name):
    """Call only while :data:`ON`.  The LSTM forwards launched from now on
    are model ``name``'s (``None``: no named model's).  -> the name it
    replaces, to put back when the model's stack is done."""
    global MODEL
    before, MODEL = MODEL, name
    return before


def op(family, direction, seq, batch, hidden, events=None, device=None,
       model=None):
    """Call only while :data:`ON`, after the launch: one LSTM op of the
    innermost open call launched by ``model`` (a name or ``None``), timed
    by ``events`` (of :func:`op_events`) on CUDA ``device``; without them
    an op that ran on the CPU."""
    if _stack:
        _stack[-1].ops.append(((family, direction, seq, batch, hidden),
                               *(events or (None, None)),
                               None if events is None else device.index,
                               model))


def device_span_start(device):
    """Call only while :data:`ON`: the start of a device span on the
    current stream of ``device``, an event recorded there now, or ``None``
    off CUDA (:func:`device_span_end`)."""
    if device.type != "cuda":
        return None
    ev = _event(device.index)
    ev.record(torch.cuda.current_stream(device))
    return ev


def device_span_end(name, start, device):
    """Call only while :data:`ON`: end the device span ``name`` begun at
    ``start`` (of :func:`device_span_start`) on ``device``'s current
    stream, and add it to the innermost open call."""
    end = None
    if start is not None:
        end = _event(device.index)
        end.record(torch.cuda.current_stream(device))
    if _stack:
        _stack[-1].timed.append((name, start, end, None if start is None
                                 else device.index))


def count(name, n=1):
    """Call only while :data:`ON`.  Add ``n`` to counter ``name``."""
    if _stack:
        with _lock:
            _stack[-1].counters[name] += n


def adam_step(model):
    """Call only while :data:`ON`.  One Adam step of ``model`` (a name)."""
    if _stack:
        with _lock:
            _stack[-1].adam[model] += 1


def waited():
    """Call only while :data:`ON`.  The host blocked on the device here
    (an event or a device synchronize)."""
    if _stack:
        rec = _stack[-1]
        with _lock:
            rec.counters["host_waits" if rec.thread == threading.get_ident()
                         else "worker_waits"] += 1


def fetched(t):
    """Call only while :data:`ON`, before copying tensor ``t`` to the host
    and waiting for it: on a CUDA tensor, one wait and its bytes."""
    if t.is_cuda:
        waited()
        count("d2h_bytes", t.numel() * t.element_size())


def fetch_queued(t):
    """Call only while :data:`ON`: tensor ``t`` starts an asynchronous
    copy to pinned host memory (its bytes; the wait is counted where the
    host waits for it)."""
    if t.is_cuda:
        count("d2h_bytes", t.numel() * t.element_size())


def sent(t):
    """Call only while :data:`ON`, after tensor ``t`` was copied from
    pageable host memory to the device: its bytes, and one wait, since
    such a copy returns only when the device's stream has reached it."""
    if t.is_cuda:
        waited()
        count("h2d_bytes", t.numel() * t.element_size())
