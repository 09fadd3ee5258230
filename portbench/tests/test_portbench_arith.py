"""The yardstick's arithmetic, pinned against counts made by hand."""

import numpy as np
import pytest

from portbench.yardstick import bounds, readers, work


def test_lstm_bounds_by_hand():
    # B1 at (402, 1, 720): 402 * (8 * 720^2 + 13 * 720) FLOPs; its bytes
    # 4 * (402 * 6 * 720 + 4 * 720^2 + 2 * 720) take less time
    assert bounds.lstm_fwd_bound(402, 1, 720) == pytest.approx(
        1_670_937_120 / 67e12)
    assert 15_246_720 / 3.35e12 < 1_670_937_120 / 67e12
    # B2 at (402, 8, 720): 3216 * (8 * 720^2 + 20 * 720)
    assert bounds.lstm_bwd_bound(402, 8, 720) == pytest.approx(
        13_383_705_600 / 67e12)
    # B3 at (201, 1, 720): 201 * (24 * 720^2 + 26 * 720)
    assert bounds.stack2_fwd_bound(201, 1, 720) == pytest.approx(
        2_504_524_320 / 67e12)
    # B4 at (201, 1, 720): 201 * (24 * 720^2 + 40 * 720)
    assert bounds.stack2_bwd_bound(201, 1, 720) == pytest.approx(
        201 * (24 * 720 ** 2 + 40 * 720) / 67e12)


def test_a_planning_step_counts_as_profile_device_did():
    step = work._criterion(402, 1, False, True)
    frozen = 3 * (bounds.lstm_flops(402, 30, 720) + 402 * 2 * 720 * 60
                  + bounds.lstm_flops(201, 60, 720, layers=2)
                  + 2 * 720 * 300)
    assert work.flops(step) == frozen
    assert bounds.lstm_flops(402, 30, 720) == 402 * 2 * 750 * 2880


def _count(passes, model, steps, batch, backward):
    return sum(p == work.Pass(model, steps, batch, backward)
               for p in passes)


def test_a_call_at_the_default_budget_by_hand():
    calls = work.resynth_call(402, n_outer=10, n_inner=25, n_epochs=10,
                              n_batches=3, batch_size=8)
    # 250 planning steps, the initial baseline and the final forward
    assert _count(calls, "predictive", 402, 1, False) == 252
    assert _count(calls, "predictive", 402, 1, True) == 250
    # 10 rounds of 10 epochs x 3 batches of 8
    assert _count(calls, "predictive", 402, 8, False) == 300
    assert _count(calls, "predictive", 402, 8, True) == 300
    # planning, the target's, the baseline's two, the final two
    assert _count(calls, "embedder", 201, 1, False) == 255
    assert _count(calls, "embedder", 201, 25, False) == 10
    assert _count(calls, "inverse", 201, 1, False) == 1
    # B1 + B2's least time: 250 x (402, 1) both ways, 2 more forwards,
    # the inverse model's, 300 x (402, 8) both ways
    least = (252 * bounds.lstm_fwd_bound(402, 1, 720)
             + 250 * bounds.lstm_bwd_bound(402, 1, 720)
             + bounds.lstm_fwd_bound(201, 1, 720)
             + 300 * (bounds.lstm_fwd_bound(402, 8, 720)
                      + bounds.lstm_bwd_bound(402, 8, 720)))
    assert work.least_s(calls, "single") == pytest.approx(least)


def test_the_tube_embedder_runs_layer_by_layer_while_planning():
    step = work._criterion(200, 1, True, True)
    singles = [k for p in step for k in work.kernel_passes(p)
               if k[0] == "single"]
    # predictive, cp_tube, tube_mel, and the tube embedder's two layers,
    # each forward and backward
    assert len(singles) == 2 * 5
    assert sum(k[3] == 360 for k in singles) == 4


def test_a_sharded_batch_counts_each_shard():
    one = work.corpus_batch(80, 16, n_outer=1, n_inner=1, n_epochs=1,
                            batch_size=8)
    four = work.corpus_batch(80, 16, n_outer=1, n_inner=1, n_epochs=1,
                             batch_size=8, dp=4)
    assert work.flops(one) == work.flops(four)
    # planning: 4 shards of 4; training: 2 batches of 8, 4 shards of 2
    assert _count(four, "predictive", 80, 4, True) == 4
    assert _count(four, "predictive", 80, 2, True) == 8


class _Cell:
    def __init__(self, units, trace=None, devices=("x",), driver="resynth"):
        self.units, self.trace = units, trace
        self.devices = list(devices)
        self.workload = {"driver": driver}


class _Trace:
    def __init__(self, kernel_s, busy_s, window_s):
        self.kernel_s, self.busy_s, self.window_s = kernel_s, busy_s, window_s

    def seconds_of(self, names):
        return sum(s for k, s in self.kernel_s.items()
                   if any(n in k for n in names))


def test_readers_by_hand():
    passes = [work.Pass("predictive", 402, 1, False)]
    traced = {"work": passes, "traced": True, "inner_steps": 4,
              "timings": {"planning": 9.0}, "wall": 9.0, "key": 402}
    plain = dict(traced, traced=False, timings={"planning": 0.02},
                 wall=2.0)
    least = bounds.lstm_fwd_bound(402, 1, 720)
    trace = _Trace({"void lstm_fwd_persistent(int, ...)": 10 * least},
                   [0.75], 1.0)
    cell = _Cell([traced, plain], trace)
    assert readers.roofline(cell, "resynth", "single",
                            ("lstm_fwd_persistent",)) == pytest.approx(10.0)
    assert readers.roofline(cell, "resynth", "pair", ("x",)) is None
    assert readers.roofline(cell, "corpus", "single", ("lstm",)) is None
    # 0.75 s busy against the 2.0 s the untraced unit took
    assert readers.idle(cell, "resynth") == pytest.approx(62.5)
    # the spans and the rate of the unit that ran without the profiler
    assert readers.phase_ms_per(cell, "resynth", "planning",
                                "inner_steps") == pytest.approx(5.0)
    assert readers.mfu(cell, "resynth") == pytest.approx(
        100 * work.flops(passes) / (2.0 * 67e12))
    assert readers.idle(_Cell([plain]), "resynth") is None
    # the untraced unit nearest in the window stands for the traced one
    later = dict(plain, wall=4.0)
    assert readers.idle(_Cell([traced, plain, later], trace),
                        "resynth") == pytest.approx(62.5)
    assert readers.idle(_Cell([later, plain, traced], trace),
                        "resynth") == pytest.approx(62.5)
    assert readers.idle(_Cell([traced, dict(plain, key=201)], trace),
                        "resynth") is None
    assert readers.mfu(_Cell([traced]), "resynth") is None


def test_the_judges_gaps_by_hand():
    from portbench import judge as J

    # two steps of one row: the largest gap of a row over its own norm
    ref = np.array([[[3.0, 4.0]], [[0.0, 0.01]]])
    got = ref + np.array([[[0.0, 0.5]], [[0.0, 0.05]]])
    assert J._rel_norm(got, ref) == pytest.approx(5.0)
    # leaves: a leaf near nought against the median leaf
    ref_leaves = {"a": np.array([3.0, 4.0]), "b": np.array([0.0, 1.0]),
                  "c": np.array([0.0, 1e-6]), "d": np.array([2.0])}
    got_leaves = dict(ref_leaves, a=np.array([3.0, 4.5]),
                      c=np.array([0.0, 0.01]))
    gaps = J._leaf_gaps(got_leaves, ref_leaves)
    median = 1.5
    assert gaps["a"] == pytest.approx((np.hypot(3.0, 4.5) - 5.0) / 5.0)
    assert gaps["c"] == pytest.approx((0.01 - 1e-6) / median)
    assert gaps["b"] == gaps["d"] == 0.0
    assert J._leaf_gaps({"a": ref_leaves["a"]}, ref_leaves) is None
