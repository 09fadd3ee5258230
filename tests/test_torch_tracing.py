"""The port's tracer (``paule_tpu_torch.tracing``) on the CPU, with small
models: off, a call leaves no record and reads no extra clock; on, every
leaf lies in a phase of its call and the leaves tile it; the LSTM op
aggregates count each wrapper call with its caller's (T, B, H), to the
counts the budget implies; the wait and byte counters count where a
device fetch happens; a call under a recording profiler is recorded as
profiled and only its leaves reach the trace."""

import collections
import re
import threading
import time

import numpy as np
import pytest
import torch

from paule_tpu_torch import api, synth, tracing
from paule_tpu_torch.api import Paule
from paule_tpu_torch.models.blocks import init_random
from paule_tpu_torch.models.embedder import EmbeddingModel
from paule_tpu_torch.models.forward import ForwardModel
from paule_tpu_torch.models.inverse import InverseModelMelTimeSmoothResidual
from paule_tpu_torch.ops import lstm_kernels as K
from paule_tpu_torch.ops.normalize import inv_normalize_cp
from paule_tpu_torch.parallel import batched as TB
from paule_tpu_torch.planning.trainer import ModelTrainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HIDDEN = 16
T_CP = 24
#: two outer iterations of 4 logged steps; continue-learning draws its
#: 2 x 2 rows from the 4 snapshots of each iteration
PLAN = dict(objective="acoustic_semvec", initialize_from="acoustic",
            n_outer=2, n_inner=4, log_ii=1, n_epochs=2, n_batches=2,
            batch_size=2, continue_learning=True, verbose=False)
BATCH = dict(n_outer=1, n_inner=2, n_epochs=1, batch_size=2)
PHASES = {"prelude", "planning", "synthesis", "metrics",
          "continue_learning", "final"}
#: the leaves of each phase, per entry point
LEAVES = {
    "plan_resynth": {
        "prelude": {"target", "init", "baseline"},
        "planning": {"enqueue", "fetch", "log"},
        "synthesis": {"wait", "run"},
        "metrics": {"flush", "prod", "copy", "log"},
        "continue_learning": {"batch", "step", "losses", "replay"},
        "final": {"results"}},
    "plan_batch_resynth": {
        "prelude": {"shards"}, "planning": {"shards", "to_host"},
        "synthesis": {"run"}, "metrics": {"prod", "log"},
        "continue_learning": {"batch", "step", "tube_batch", "tube_step",
                              "sync_replicas"},
        "final": {"to_host"}}}
NAME = re.compile(
    r"^(plan_resynth|plan_batch_resynth)\.([a-z_]+)\.([a-z_]+)$")


@pytest.fixture(scope="module")
def paule():
    """A CPU float64 ``Paule`` whose forward, inverse and embedder models
    are seeded at H=16."""
    p = Paule(seed=1, pretrained_dir="random", device="cpu",
              dtype=torch.float64)
    gen = torch.Generator().manual_seed(1)
    for name, module in (
            ("pred_model", ForwardModel(num_lstm_layers=1,
                                        hidden_size=HIDDEN)),
            ("inv_model", InverseModelMelTimeSmoothResidual(
                num_lstm_layers=1, hidden_size=HIDDEN)),
            ("embedder", EmbeddingModel(num_lstm_layers=2,
                                        hidden_size=HIDDEN))):
        module.to(torch.float64)
        init_random(module, gen)
        setattr(p, name, module.eval())
    p.embedder.requires_grad_(False)
    p.pred_trainer = ModelTrainer(p.pred_model, loss="rmse",
                                  name="predictive")
    p.inv_trainer = ModelTrainer(p.inv_model, loss="cp_trajectory",
                                 name="inverse")
    yield p
    p.close()


@pytest.fixture(scope="module")
def target():
    rng = np.random.default_rng(0)
    cp = np.clip(rng.normal(0, 0.05, (T_CP, 30)).cumsum(0) * 0.2, -1, 1)
    return synth.speak(inv_normalize_cp(cp))


@pytest.fixture
def traced():
    """Tracing on for the test."""
    tracing.enable()
    yield
    tracing.enable(False)


def _mels(n=3, frames=T_CP // 2):
    return np.stack([np.random.default_rng(i).normal(size=(frames, 60))
                     for i in range(n)]) * 0.3


def _plan(paule, target, scope):
    if scope == "plan_resynth":
        return paule.plan_resynth(target_acoustic=target, **PLAN)
    return TB.plan_batch_resynth(paule, _mels(), **BATCH)


def _last(scope):
    return [c for c in tracing.calls() if c["scope"] == scope][-1]


@pytest.mark.parametrize("scope", ["plan_resynth", "plan_batch_resynth"])
def test_off_a_call_leaves_no_record_and_reads_no_extra_clock(
        paule, target, scope, monkeypatch):
    """No record, no ``record_function``, no CUDA event, no
    ``perf_counter_ns``, and ``perf_counter`` only in the phases' pairs
    (and the total's)."""
    used = collections.Counter()

    def counting(name, fn):
        def wrapped(*a, **k):
            used[name] += 1
            return fn(*a, **k)
        return wrapped

    phase = tracing.phase

    def phase_counted(timings, name):
        used["phase"] += 1
        return phase(timings, name)

    before = len(tracing.calls())
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting("record_function",
                                 torch.profiler.record_function))
    monkeypatch.setattr(torch.cuda, "Event",
                        counting("event", torch.cuda.Event))
    monkeypatch.setattr(time, "perf_counter_ns",
                        counting("perf_counter_ns", time.perf_counter_ns))
    monkeypatch.setattr(time, "perf_counter",
                        counting("perf_counter", time.perf_counter))
    monkeypatch.setattr(tracing, "phase", phase_counted)
    _plan(paule, target, scope)
    monkeypatch.undo()
    assert len(tracing.calls()) == before
    assert used["record_function"] == used["event"] == 0
    assert used["perf_counter_ns"] == 0
    assert used["phase"] > 0
    total = 2 if scope == "plan_resynth" else 0
    assert used["perf_counter"] == 2 * used["phase"] + total


@pytest.mark.parametrize("scope", ["plan_resynth", "plan_batch_resynth"])
def test_on_every_leaf_lies_in_a_phase_of_its_call_and_tiles_it(
        paule, target, scope, traced):
    _plan(paule, target, scope)
    rec = _last(scope)
    assert not rec["profiled"] and rec["device"] is None
    spans = {s["id"]: s for s in rec["spans"]}
    phases = {i: s for i, s in spans.items() if s["kind"] == "phase"}
    assert all(s["parent"] == 0 for s in phases.values())
    assert {s["name"].split(".")[1] for s in phases.values()} == PHASES
    seen = collections.defaultdict(set)
    for s in spans.values():
        assert s["host_start_ns"] <= s["host_end_ns"]
        assert s["device_start_ns"] is None
        if s["kind"] != "leaf":
            continue
        parent = phases[s["parent"]]
        got = NAME.match(s["name"])
        assert got and got.group(1) == scope, s["name"]
        assert f"{scope}.{got.group(2)}" == parent["name"]
        assert (parent["host_start_ns"] <= s["host_start_ns"]
                and s["host_end_ns"] <= parent["host_end_ns"])
        seen[got.group(2)].add(got.group(3))
    assert set(seen) == PHASES
    for name, leaves in seen.items():
        assert leaves <= LEAVES[scope][name], name
    # each phase's leaves follow one another without a gap between marks
    for pid, ph in phases.items():
        leaves = [s for s in spans.values() if s["parent"] == pid]
        assert leaves, ph["name"]
        for a, b in zip(leaves, leaves[1:]):
            assert a["host_end_ns"] <= b["host_start_ns"]


@pytest.mark.parametrize("on", [False, True])
def test_last_planning_timings_keeps_its_keys(paule, target, on):
    tracing.enable(on)
    try:
        _plan(paule, target, "plan_resynth")
        assert set(paule.last_planning_timings) == {
            "planning", "synthesis", "metrics", "continue_learning",
            "total"}
        _plan(paule, target, "plan_batch_resynth")
        assert set(paule.last_planning_timings) == {
            "planning", "synthesis", "metrics", "continue_learning",
            "continue_learning_tube"}
    finally:
        tracing.enable(False)


def test_op_aggregates_count_each_wrapper_call_with_its_shape(
        paule, target, traced, monkeypatch):
    """The plain versions, which the wrappers run on the CPU, counted by
    (family, direction, T, B, H) from their own arguments."""
    seen = collections.Counter()
    for name, key in (("lstm_fwd_plain", ("single", "fwd")),
                      ("lstm_bwd_plain", ("single", "bwd")),
                      ("lstm_stack2_fwd_plain", ("pair", "fwd")),
                      ("lstm_stack2_bwd_plain", ("pair", "bwd"))):
        # the first argument holds the 4H gates of each (T, B) row
        def wrapped(x, *rest, _fn=getattr(K, name), _key=key):
            seen[(*_key, x.shape[0], x.shape[1], x.shape[2] // 4)] += 1
            return _fn(x, *rest)
        monkeypatch.setattr(K, name, wrapped)
    _plan(paule, target, "plan_resynth")
    rec = _last("plan_resynth")
    got = {(o["family"], o["direction"], o["T"], o["B"], o["H"]): o["count"]
           for o in rec["ops"]}
    assert got == dict(seen)
    assert all(o["device_ms"] is None for o in rec["ops"])


def test_recorded_ops_are_the_counts_the_budget_implies(paule, target,
                                                        traced):
    """2 outer iterations x 4 steps at 24 cp frames (12 mel frames), 2
    epochs x 2 batches of 2: the forward model (single, T=24) and the
    two-layer embedder (pair, T=12)."""
    _plan(paule, target, "plan_resynth")
    got = collections.Counter()
    for o in _last("plan_resynth")["ops"]:
        assert o["H"] == HIDDEN
        got[(o["family"], o["T"], o["B"], o["direction"])] += o["count"]
    assert dict(got) == {
        # each planning step: forward and backward of both models
        ("single", 24, 1, "fwd"): 2 * 4 + 2,  # + the baseline, the final
        ("single", 24, 1, "bwd"): 2 * 4,
        ("pair", 12, 1, "fwd"): 2 * 4 + 5,  # + target, baseline x2, final x2
        ("pair", 12, 1, "bwd"): 2 * 4,
        ("single", 12, 1, "fwd"): 1,  # the inverse model's start
        ("pair", 12, 4, "fwd"): 2,  # the logged mels' semvecs, per outer
        # continue-learning: 2 outer x 2 epochs x 2 batches of 2
        ("single", 24, 2, "fwd"): 8,
        ("single", 24, 2, "bwd"): 8}
    counters = _last("plan_resynth")["counters"]
    assert counters["adam_steps"] == {"predictive": 8}
    assert counters["snapshots"] == 2 * 4


class _CudaLike:
    """A stand-in for a CUDA tensor of ``n`` float64 values."""

    is_cuda = True

    def __init__(self, n):
        self.t = torch.zeros(n, dtype=torch.float64)

    def numel(self):
        return self.t.numel()

    def element_size(self):
        return 8

    def detach(self):
        return self.t


class _Event:
    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


def test_waits_and_bytes_are_counted_where_a_fetch_happens():
    with tracing.call("test", force=True) as rec:
        api._np(_CudaLike(5))
        api._np(torch.zeros(7))  # a host tensor: no wait
        copy = api._HostCopy({"x": None}, non_blocking=False)
        copy._event, copy._host = _Event(), {"a": torch.zeros(2),
                                             "b": torch.zeros(3)}
        copy.all()  # one wait for both keys
        tracing.sent(_CudaLike(4))
        worker = threading.Thread(target=lambda: api._np(_CudaLike(1)))
        worker.start()
        worker.join()
    counters = rec.record["counters"]
    assert copy._event.waits == 1
    assert counters["host_waits"] == 3 and counters["worker_waits"] == 1
    assert counters["d2h_bytes"] == 8 * (5 + 1)
    assert counters["h2d_bytes"] == 8 * 4
    assert tracing.calls()[-1] is rec.record


def test_an_inner_call_adds_its_ops_and_counters_to_the_outer_one(
        paule, target):
    with tracing.call("outer", force=True) as outer:
        _plan(paule, target, "plan_batch_resynth")
    inner = _last("plan_batch_resynth")
    assert inner["parent"] == outer.id
    assert outer.record["ops"] == inner["ops"]
    assert outer.record["counters"] == inner["counters"]
    assert outer.record["spans"] == []


def test_a_call_under_the_profiler_is_recorded_profiled(paule, target):
    """Only leaves reach the trace, as ``record_function`` ranges."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _plan(paule, target, "plan_batch_resynth")
    rec = _last("plan_batch_resynth")
    assert rec["profiled"]
    names = {e.name for e in prof.events()
             if e.name.startswith("plan_batch_resynth.")}
    leaves = {s["name"] for s in rec["spans"] if s["kind"] == "leaf"}
    assert names == leaves
    assert all(NAME.match(n) for n in names)
