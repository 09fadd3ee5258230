"""A whole run of each cell on the CPU, cut to test size, with the
harness's look for a chip skipped: sound, it comes out correct; with its
timed path broken underneath in each way the cell can break, it does
not."""

import numpy as np
import pytest
import torch

from portbench import run as R
from portbench.faults import FAULTS, exchange_left_out
from portbench.tests import tiny

CELLS = ["resynth-1s", "corpus-b16", "soma-resynth-0.5s"]


def _failed(checks):
    return sorted(k for k, c in checks.items()
                  if not c["value"] <= c["limit"])


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    _cell, window, checks = tiny.run(name)
    assert window["attempted"] >= 1 and window["failed"] == 0
    assert R.is_correct(checks), checks


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    _cell, _window, checks = tiny.run(name)
    assert not R.is_correct(checks), checks


@pytest.mark.parametrize("name", CELLS)
def test_training_that_does_not_start_from_the_release_is_not_correct(
        name, monkeypatch):
    # the warm-up's training left in the trainer
    from portbench import program

    monkeypatch.setattr(program, "restore", lambda *a: None)
    _cell, _window, checks = tiny.run(name)
    assert checks["start_state"]["value"] > 0, checks
    assert not R.is_correct(checks), checks


def test_a_sharded_corpus_is_correct():
    # one device listed twice: the sharded code runs shard after shard
    _cell, _window, checks = tiny.run("corpus-b16", devices=("cpu", "cpu"),
                                      dp=2)
    assert R.is_correct(checks), checks


@pytest.mark.card
def test_a_corpus_over_cards_without_its_exchange_is_not_correct(
        card, monkeypatch):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: replicas on one device share "
                    "their weights")
    devices = ("cuda:0", "cuda:1")
    _cell, _window, checks = tiny.run("corpus-b16", devices=devices, dp=2)
    assert R.is_correct(checks), checks
    exchange_left_out(monkeypatch)
    _cell, _window, checks = tiny.run("corpus-b16", devices=devices, dp=2)
    assert not R.is_correct(checks), checks


def test_the_traced_run_reads_its_per_layer_metrics_on_the_cpu():
    # the first call traced, the next ones not
    cell, _window, _checks = tiny.run("resynth-1s", trace=1, seconds=2.0)
    assert sum(not u["traced"] for u in cell.units) >= 1
    assert cell.trace is not None and cell.trace.window_s > 0
    bench = R.benchmark()
    got = R.metrics_of(cell, bench, {"end_to_end": {}}, 1.0, 1)
    # the program's spans and the traffic's FLOPs; no device time here
    assert {"planning_ms_per_step.resynth", "cl_ms_per_step.resynth",
            "synthesis_ms_per_snapshot.resynth", "mfu.resynth"} <= set(got)
    assert "lstm1_roofline.resynth" not in got
    assert all(np.isfinite(v["value"]) for v in got.values())
