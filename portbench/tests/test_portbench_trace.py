"""The trace reader on synthetic profiler events."""

import pytest

from portbench.yardstick import trace as T


def _rec(a, b, name, dev=False, index=0, ann=False):
    return (a, b, name, dev, index, ann)


RECORDS = [
    _rec(0, 100, T.WINDOW, ann=True),
    _rec(0, 100, T.WINDOW, dev=True, ann=True),
    _rec(5, 95, "plan_resynth.planning", dev=True),
    _rec(10, 30, "lstm_fwd_persistent(int, int)", dev=True),
    _rec(20, 40, "lstm_bwd_persistent(int, int)", dev=True),
    _rec(60, 70, "Memcpy DtoH", dev=True),
    _rec(95, 120, "late kernel", dev=True),
    _rec(35, 100, "plan_resynth.synthesis"),
    _rec(72, 98, "pts_synth_block_batch"),
    _rec(0, 10, "aten::mm"),
]


def test_busy_kernels_and_gaps():
    s = T.summarize(RECORDS, 1)
    assert s.window_s == pytest.approx(100e-6)
    # [10, 40) + [60, 70) + [95, 100): the late kernel is clipped
    assert s.busy_s == [pytest.approx(45e-6)]
    assert s.kernel_s["lstm_fwd_persistent(int, int)"] == pytest.approx(
        20e-6)
    assert s.seconds_of(("lstm_fwd_persistent", "lstm_bwd_persistent")) == (
        pytest.approx(40e-6))
    assert "plan_resynth.planning" not in s.kernel_s
    # the gaps [70, 95), [40, 60), [0, 10), longest first
    assert [g[1] for g in s.idle_gaps] == [pytest.approx(25e-6),
                                           pytest.approx(20e-6),
                                           pytest.approx(10e-6)]
    assert s.idle_gaps[0][0] == ("plan_resynth.synthesis | "
                                 "pts_synth_block_batch")
    assert s.idle_gaps[2][0] == "aten::mm"
    assert s.device_ops[0][1] == pytest.approx(20e-6)


def test_busy_is_kept_per_card():
    recs = RECORDS + [_rec(0, 50, "k", dev=True, index=1)]
    assert T.summarize(recs, 2).busy_s[1] == pytest.approx(50e-6)
    assert T.summarize(RECORDS, 2).busy_s[1] == 0


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        T.summarize(RECORDS[2:], 1)
