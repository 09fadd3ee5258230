"""The cells ``soma-corpus-b16`` and ``corpus-dp4`` cut to test size on
the CPU, with the harness's look for a chip skipped: sound runs come out
correct and broken ones do not, a fault in one tube model's training
included; the three per-layer metrics they add are
read from a traced run; the somatosensory work count is what the traced
calls ran."""

import collections
import copy

import numpy as np
import pytest

from portbench import run as R
from portbench.faults import FAULTS, exchange_left_out
from portbench.tests import tiny
from portbench.yardstick import model_spans, spans, soma_work, work

SOMA = "soma-corpus-b16"
#: the training numbers each tube model is compared by
TRAIN_NUMBERS = ("start_state", "train_loss", "train_grad", "train_change")
TUBE_MODELS = ("cp_tube", "tube_mel")
NEW = ("tube_lstm_op_roofline.soma", "tube_cl_ms_per_step.soma",
       "sync_ms_per_step.dp4")


def _copying_replicate(mesh, module):
    """``replicate`` with a copy of ``module`` for every shard but the
    first, also on one device: the replicas then hold weights of their
    own, as on distinct cards."""
    if module is None:
        return [None] * len(mesh.devices)
    return [module] + [copy.deepcopy(module) for _ in mesh.devices[1:]]


@pytest.fixture(scope="module")
def traced_soma():
    """A traced run of the cut cell: its first batch profiled, the next
    not; -> (cell, checks, the profiled calls' records)."""
    before = {c["id"] for c in spans.records()}
    cell, _window, checks = tiny.run(SOMA, trace=1, trace_iterations=1)
    calls = spans.profiled([c for c in spans.records()
                            if c["id"] not in before], "plan_batch_resynth")
    return cell, checks, calls


def test_a_sound_soma_run_is_correct(traced_soma):
    _cell, checks, _calls = traced_soma
    assert "tube" in checks and "plan_step" in checks
    assert set(TRAIN_NUMBERS) <= set(checks)
    assert R.is_correct(checks), checks


@pytest.mark.parametrize("fault", FAULTS)
def test_a_soma_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    _cell, _window, checks = tiny.run(SOMA)
    assert not R.is_correct(checks), checks


@pytest.mark.parametrize("model", TUBE_MODELS)
@pytest.mark.parametrize("fault", ["train_step_unchanged", "half_batch"])
def test_a_tube_trainer_fault_is_not_correct(fault, model, monkeypatch):
    """A fault in one tube model's training alone: the run is not correct,
    and of each model's own training numbers only that model's leave
    their limits."""
    from paule_tpu_torch.planning.trainer import ModelTrainer

    sound = {k: getattr(ModelTrainer, k) for k in ("_step", "_loss")}
    FAULTS[fault](monkeypatch)
    for k, fn in sound.items():
        broken = getattr(ModelTrainer, k)
        if broken is not fn:
            monkeypatch.setattr(
                ModelTrainer, k,
                lambda self, *a, _b=broken, _f=fn: (
                    _b if self.name == model else _f)(self, *a))
    cell = R.Cell(SOMA, 2 ** 31 + 11, ["cpu"], workload=tiny.workload(SOMA))
    _setup, _window, _peak, outputs, inputs = R.execute(cell, 0.05, 0, 0.0)
    numbers = R.judge(cell, outputs, inputs)
    assert not R.is_correct(R.checks_of(cell, numbers))
    limits = cell.workload["limits"]
    each = {f"{n}.{m}" for n in TRAIN_NUMBERS
            for m in ("predictive",) + TUBE_MODELS}
    assert each <= set(numbers)
    bad = {k for k in each if not numbers[k] <= limits[k.split(".")[0]]}
    assert bad and all(k.endswith("." + model) for k in bad), numbers


def test_masks_from_another_seed_are_not_correct(monkeypatch):
    """The judge draws the tube embedder's masks from ``mask_seed``: a
    batch planned with other masks parts from it at once."""
    from portbench.drivers import corpus_soma

    gather = corpus_soma.gather

    def other_seed(cell):
        outputs, inputs = gather(cell)
        return outputs, dict(inputs, mask_seed=inputs["mask_seed"] + 1)

    monkeypatch.setattr(corpus_soma, "gather", other_seed)
    _cell, _window, checks = tiny.run(SOMA)
    assert checks["plan_loss"]["value"] > checks["plan_loss"]["limit"]


@pytest.mark.parametrize("replicas", ["shared", "copies"])
def test_a_sharded_corpus_over_two_devices_is_correct(replicas,
                                                      monkeypatch):
    from paule_tpu_torch.parallel import mesh

    if replicas == "copies":
        monkeypatch.setattr(mesh, "replicate", _copying_replicate)
    _cell, _window, checks = tiny.run("corpus-dp4", devices=("cpu", "cpu"),
                                      dp=2)
    assert R.is_correct(checks), checks


def test_a_sharded_corpus_without_its_exchange_is_not_correct(monkeypatch):
    """Replicas with weights of their own that are not brought up to the
    new weights after a step train the next step's shard from stale
    ones."""
    from paule_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "replicate", _copying_replicate)
    exchange_left_out(monkeypatch)
    _cell, _window, checks = tiny.run("corpus-dp4", devices=("cpu", "cpu"),
                                      dp=2)
    assert not R.is_correct(checks), checks


def test_the_new_metrics_read_a_traced_cpu_run(traced_soma):
    """On the CPU the ops and the sync have no device time, so only the
    host-timed metric has a value; given device times, the readers give
    the least time over them and the ms per Adam step."""
    cell, _checks, calls = traced_soma
    assert sum(not u["traced"] for u in cell.units) >= 1
    got = R.metrics_of(cell, R.benchmark(), {"end_to_end": {}}, 1.0, 1)
    assert np.isfinite(got["tube_cl_ms_per_step.soma"]["value"])
    assert got["tube_cl_ms_per_step.soma"]["value"] > 0
    assert "tube_lstm_op_roofline.soma" not in got
    # the same records with a device time: ten times each op's least time
    timed = copy.deepcopy(calls)
    least = 0.0
    for c in timed:
        for o in c["ops"]:
            fn = spans.BOUNDS[o["family"], o["direction"]]
            for model, part in o["models"].items():
                part["device_ms"] = 1e4 * part["count"] * fn(
                    o["T"], o["B"], o["H"])
                if model in model_spans.TUBE_MODELS:
                    least += part["count"] * fn(o["T"], o["B"], o["H"])
    assert least > 0
    assert model_spans.model_op_roofline(
        timed, model_spans.TUBE_MODELS) == pytest.approx(10.0)
    # 4 ms of sync over the traced units' Adam steps
    steps = sum(u["adam_steps"] for u in cell.units if u["traced"])
    for c in timed:
        c["device_spans"] = {"sync_replicas": {"count": 1,
                                               "device_ms": 4.0}}
    dp4 = type("Cell", (), {"workload": {"driver": "corpus"},
                            "units": cell.units})
    mp = pytest.MonkeyPatch()
    mp.setattr(spans, "records", lambda: timed)
    try:
        assert R.metric_reader("sync_ms_per_step.dp4")(dp4) == (
            pytest.approx(4.0 * len(timed) / steps))
        assert R.metric_reader("tube_lstm_op_roofline.soma")(cell) == (
            pytest.approx(10.0))
    finally:
        mp.undo()


def test_a_program_without_the_new_records_gives_nothing(traced_soma,
                                                         monkeypatch):
    """Records and timings as a program before these metrics makes them:
    no ``models`` split, no ``device_spans``, no
    ``continue_learning_tube``."""
    cell, _checks, calls = traced_soma
    old = copy.deepcopy(calls)
    for c in old:
        c.pop("device_spans", None)
        for o in c["ops"]:
            o.pop("models", None)
            o["device_ms"] = 1.0
    monkeypatch.setattr(spans, "records", lambda: old)
    units = copy.deepcopy(cell.units)
    for u in units:
        u["timings"].pop("continue_learning_tube", None)
    monkeypatch.setattr(cell, "units", units)
    dp4 = type("Cell", (), {"workload": {"driver": "corpus"},
                            "units": units})
    for name in NEW:
        assert R.metric_reader(name)(dp4 if name.endswith("dp4")
                                     else cell) is None


def test_the_soma_work_is_what_the_traced_call_ran(traced_soma):
    """The recorded LSTM ops of the profiled batch, by (family, direction,
    T, B, H), are the kernel calls of its somatosensory work count."""
    cell, _checks, calls = traced_soma
    traced = [u for u in cell.units if u["traced"]]
    assert len(traced) == len(calls) == 1
    want = collections.Counter()
    for p in traced[0]["work"]:
        for fam, steps, batch, hidden, backward in work.kernel_passes(p):
            want[fam, "bwd" if backward else "fwd", steps, batch,
                 hidden] += 1
    got = {(o["family"], o["direction"], o["T"], o["B"], o["H"]):
           o["count"] for o in calls[0]["ops"]}
    assert got == dict(want)
    models = {m for o in calls[0]["ops"] for m in o["models"]}
    assert models == {"predictive", "inverse", "embedder", "cp_tube",
                      "tube_mel", "tube_embedder"}


def test_the_soma_count_adds_the_tube_models_to_the_corpus_count():
    kw = dict(n_outer=10, n_inner=25, n_epochs=10, batch_size=8)
    base = work.corpus_batch(160, 16, **kw)
    soma = soma_work.corpus_batch(160, 16, **kw)
    assert collections.Counter(base) - collections.Counter(soma) == {}
    added = collections.Counter(p.model for p in soma) - (
        collections.Counter(p.model for p in base))
    # per outer: 25 steps x (fwd + bwd) of each tube model (the tube
    # embedder with dropout), the metrics' forwards, 20 training steps of
    # each trained tube model
    assert added == {"cp_tube": 10 * (50 + 1 + 40),
                     "tube_mel": 10 * (50 + 2 + 40),
                     "tube_embedder": 10 * (50 + 1)}
