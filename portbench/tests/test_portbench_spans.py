"""The readers of the program's call records (``yardstick/spans.py``) on
synthetic records, the metrics that use them, and a cut cell traced on
the CPU."""

import sys

import pytest

from portbench import run as R
from portbench.yardstick import bounds, spans

NEW = ("lstm1_op_roofline", "lstm2_op_roofline", "host_waits_per_step")


class _Cell:
    def __init__(self, units, driver="resynth"):
        self.units = units
        self.workload = {"driver": driver}


def _op(family, direction, t, b, h, count, ms):
    return {"family": family, "direction": direction, "T": t, "B": b,
            "H": h, "count": count, "device_ms": ms}


def _call(scope="plan_resynth", profiled=True, ops=(), waits=0):
    return {"scope": scope, "profiled": profiled, "ops": list(ops),
            "counters": {"host_waits": waits}}


def test_an_op_roofline_is_the_least_time_over_the_event_time():
    fwd = bounds.lstm_fwd_bound(402, 1, 720)
    bwd = bounds.lstm_bwd_bound(402, 8, 720)
    pair = bounds.stack2_fwd_bound(201, 1, 720)
    calls = [_call(ops=[_op("single", "fwd", 402, 1, 720, 3, 30e3 * fwd),
                        _op("pair", "fwd", 201, 1, 720, 2, 4e3 * pair)]),
             _call(ops=[_op("single", "bwd", 402, 8, 720, 1, 10e3 * bwd)])]
    # 3 fwd + 1 bwd least times over 10 + 10 times their device time
    assert spans.op_roofline(calls, "single") == pytest.approx(
        100 * (3 * fwd + bwd) / (30 * fwd + 10 * bwd))
    assert spans.op_roofline(calls, "pair") == pytest.approx(50.0)
    # ops run on the CPU have no device time
    cpu = [_call(ops=[_op("single", "fwd", 24, 1, 16, 4, None)])]
    assert spans.op_roofline(cpu, "single") is None
    assert spans.op_roofline(calls[1:], "pair") is None


def test_only_profiled_calls_of_the_scope_are_read(monkeypatch):
    fwd = bounds.lstm_fwd_bound(402, 1, 720)
    calls = [_call(ops=[_op("single", "fwd", 402, 1, 720, 1, 1e3 * fwd)],
                   waits=500),
             _call(profiled=False, waits=7),
             _call(scope="plan_batch_resynth", waits=300)]
    monkeypatch.setattr(spans, "records", lambda: calls)
    cell = _Cell([{"traced": True, "inner_steps": 250},
                  {"traced": False, "inner_steps": 250}])
    assert spans.roofline(cell, "resynth", "single") == pytest.approx(100.0)
    assert spans.host_waits_per_step(cell, "resynth") == pytest.approx(2.0)
    batch = _Cell([{"traced": True, "inner_steps": 250}] * 2, "corpus")
    assert spans.host_waits_per_step(batch, "corpus") == pytest.approx(0.6)
    assert spans.roofline(batch, "corpus", "single") is None
    assert spans.roofline(cell, "corpus", "single") is None
    monkeypatch.setattr(spans, "records", lambda: calls[1:2])
    assert spans.host_waits_per_step(cell, "resynth") is None
    assert spans.roofline(cell, "resynth", "single") is None


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "paule_tpu_torch.tracing", None)
    assert spans.records() == []
    for name in NEW:
        for cell, driver in (("resynth", "resynth"), ("corpus", "corpus")):
            read = R.metric_reader(f"{name}.{cell}")
            assert read(_Cell([{"traced": True, "inner_steps": 1}],
                              driver)) is None


def test_the_new_metrics_follow_the_rules():
    entries = {m["name"]: m for m in R.benchmark()["per_layer"]}
    for name in NEW:
        for cell, moves in (("resynth", "resynth_s"),
                            ("corpus", "corpus_utt_per_s")):
            m = entries[f"{name}.{cell}"]
            assert m["source"] == "program_span" and m["moves"] == moves
            if name.endswith("_roofline"):
                assert m["unit"] == "%" and m["better"] == "higher"
            else:
                assert m["unit"] == "count" and m["better"] == "lower"


def test_a_cut_cell_traced_on_the_cpu_reads_its_calls():
    """The profiled call's record: waits counted on the card only (0
    here), no device times, so no roofline."""
    sys.path.insert(0, R.BENCH + "/tests")
    import tiny

    before = {c["id"] for c in spans.records()}
    cell, _window, _checks = tiny.run("resynth-1s", trace=1)
    calls = spans.profiled([c for c in spans.records()
                            if c["id"] not in before], "plan_resynth")
    assert calls and len(calls) == sum(u["traced"] for u in cell.units)
    assert calls[-1]["ops"]
    assert R.metric_reader("host_waits_per_step.resynth")(cell) == 0.0
    assert R.metric_reader("lstm1_op_roofline.resynth")(cell) is None
