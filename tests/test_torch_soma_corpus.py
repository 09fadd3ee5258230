"""The batched planner under the somatosensory variant with
``continue_learning_tube`` (``parallel.batched.plan_batch_resynth``), on
the CPU in float64 with seeded models at H=16, against the benchmark's
plain reference (``portbench/plain``): the losses and trajectories of its
planning steps, with the tube embedder's dropout masks drawn again from
the same seed, the produced tubes, and each tube model's first training
step.  Then the tracer's records of such a call: each LSTM op split by
the model that launched it, the per-shape sums unchanged, the tube
models' share of continue-learning, the weight sync timed only where it
copies, and nothing recorded with tracing off."""

import collections
import copy
import time

import numpy as np
import pytest
import torch

from paule_tpu_torch import tracing
from paule_tpu_torch.api import Paule
from paule_tpu_torch.models.blocks import init_random
from paule_tpu_torch.models.embedder import EmbeddingModel
from paule_tpu_torch.models.forward import ForwardModel
from paule_tpu_torch.models.inverse import InverseModelMelTimeSmoothResidual
from paule_tpu_torch.ops import lstm_kernels as K
from paule_tpu_torch.parallel import batched as TB
from paule_tpu_torch.parallel import mesh as TM
from paule_tpu_torch.planning.trainer import ModelTrainer
from portbench.plain import nets, plan
from portbench.plain import synth as plain_synth
from portbench.plain import train as plain_train
from portbench.program import ref_key
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HIDDEN = 16
T_CP = 24
BATCH = 4
N_INNER = 3
#: the seed of the tube embedder's dropout masks
MASK_SEED = 5
PLAN = dict(n_outer=1, n_inner=N_INNER, objective="acoustic_semvec",
            continue_learning=True, continue_learning_tube=True, n_epochs=1,
            batch_size=2)
#: each planning model's attribute and release prefix
MODELS = (("pred_model", "predictive"), ("inv_model", "inverse"),
          ("embedder", "embedder"), ("cp_tube_model", "cp_tube"),
          ("tube_mel_model", "tube_mel"), ("tube_embedder", "tube_embedder"))
TOL = 1e-10


@pytest.fixture(scope="module")
def paule():
    """A CPU float64 somatosensory ``Paule`` whose six planning models are
    seeded at H=16."""
    p = Paule(seed=1, pretrained_dir="random", device="cpu",
              dtype=torch.float64, use_somatosensory_feedback=True)
    gen = torch.Generator().manual_seed(2)
    for name, module in (
            ("pred_model", ForwardModel(num_lstm_layers=1,
                                        hidden_size=HIDDEN)),
            ("inv_model", InverseModelMelTimeSmoothResidual(
                num_lstm_layers=1, hidden_size=HIDDEN)),
            ("embedder", EmbeddingModel(num_lstm_layers=2,
                                        hidden_size=HIDDEN)),
            ("cp_tube_model", ForwardModel(
                input_size=30, output_size=10, hidden_size=HIDDEN,
                num_lstm_layers=1, apply_half_sequence=False)),
            ("tube_mel_model", ForwardModel(
                input_size=10, output_size=60, hidden_size=HIDDEN,
                num_lstm_layers=1, apply_half_sequence=True)),
            ("tube_embedder", EmbeddingModel(
                input_size=10, num_lstm_layers=2, hidden_size=HIDDEN,
                dropout=0.7))):
        module.to(torch.float64)
        init_random(module, gen)
        setattr(p, name, module.eval())
    p.embedder.requires_grad_(False)
    p.tube_embedder.requires_grad_(False)
    p.pred_trainer = ModelTrainer(p.pred_model, loss="rmse",
                                  name="predictive")
    p.inv_trainer = ModelTrainer(p.inv_model, loss="cp_trajectory",
                                 name="inverse")
    p.tube_trainer = ModelTrainer(p.cp_tube_model, loss="rmse",
                                  name="cp_tube")
    p.tube_mel_trainer = ModelTrainer(p.tube_mel_model, loss="rmse",
                                      name="tube_mel")
    yield p
    p.close()


@pytest.fixture
def traced():
    tracing.enable()
    yield
    tracing.enable(False)


def _mels():
    return np.stack([np.random.default_rng(i).normal(size=(T_CP // 2, 60))
                     for i in range(BATCH)]) * 0.3


def _weights(p):
    """Copies of the six models' weights by release path, as the plain
    reference takes them (``predictive.lstm[0].w_ih``)."""
    return {ref_key(prefix, name): w.detach().clone()
            for attr, prefix in MODELS
            for name, w in getattr(p, attr).named_parameters()}


def _first_step(trainer, kept):
    """Wrap ``trainer.train_batch`` until the test ends: its first call's
    input, target, loss and weights after it go to ``kept``."""
    train = trainer.train_batch

    def first(batch_in, batch_out, **kw):
        loss = train(batch_in, batch_out, **kw)
        if not kept:
            kept.update(x=batch_in.clone(), y=batch_out.clone(),
                        loss=float(loss), after={
                            k: w.detach().clone() for k, w in
                            trainer.model.named_parameters()})
        return loss
    return first


@pytest.fixture(scope="module")
def planned(paule):
    """One batched plan of 4 utterances of 24 cp frames from known weights
    and mask seed: -> (weights before, its result, each step's
    trajectories, the first training step of each tube model)."""
    weights = _weights(paule)
    paule.tube_generator.manual_seed(MASK_SEED)
    pre, firsts = [], {"cp_tube": {}, "tube_mel": {}}
    shards = TB.plan_shards
    mp = pytest.MonkeyPatch()

    def shards_kept(*a, **k):
        logs = shards(*a, **k)
        pre.append(logs["xx_pre"])
        return logs

    mp.setattr(TB, "plan_shards", shards_kept)
    mp.setattr(paule.tube_trainer, "train_batch",
               _first_step(paule.tube_trainer, firsts["cp_tube"]),
               raising=False)
    mp.setattr(paule.tube_mel_trainer, "train_batch",
               _first_step(paule.tube_mel_trainer, firsts["tube_mel"]),
               raising=False)
    try:
        out = TB.plan_batch_resynth(paule, _mels(), **PLAN)
    finally:
        mp.undo()
    return weights, out, pre[0].detach().clone(), firsts


def test_planning_steps_follow_the_plain_reference(planned):
    """The plain criterion at the program's start, its own Adam and clamp
    from there, the masks drawn again from the seed: every loss and every
    trajectory agrees."""
    weights, out, xx_pre, _firsts = planned
    mels = torch.as_tensor(_mels())
    semvecs = nets.embedder(weights, "embedder", mels)
    gen = torch.Generator().manual_seed(MASK_SEED)
    x = xx_pre[0].clone()
    m = v = torch.zeros_like(x)
    losses, steps = [], [x]
    for k in range(N_INNER):
        keep = [torch.rand((BATCH, T_CP, HIDDEN), generator=gen)
                >= plan.TUBE_DROPOUT]
        xk = x.clone().requires_grad_(True)
        total = plan.criterion(weights, xk, mels, semvecs, True, keep)
        g, = torch.autograd.grad(total.sum(), xk)
        losses.append(total.detach())
        x, m, v = plan.adam(x, g, m, v, k + 1, 0.01)
        x = x.clamp(-plan.CLAMP, plan.CLAMP)
        steps.append(x)
    np.testing.assert_allclose(out["sub_losses"][0].total,
                               torch.stack(losses).numpy(), rtol=TOL, atol=0)
    for k in range(1, N_INNER):
        np.testing.assert_allclose(xx_pre[k].numpy(), steps[k].numpy(),
                                   rtol=0, atol=TOL)
    np.testing.assert_allclose(out["planned_cp"], steps[-1].numpy(), rtol=0,
                               atol=TOL)


def test_produced_tubes_are_the_plain_synthesizers(planned):
    _weights_, out, _pre, _firsts = planned
    tubes = np.stack([plain_synth.speak_twice(c, True)[2]
                      for c in out["planned_cp"]])
    np.testing.assert_allclose(out["prod_tubes"], tubes, rtol=0, atol=TOL)


@pytest.mark.parametrize("prefix,half", [("cp_tube", False),
                                         ("tube_mel", True)])
def test_each_tube_models_first_training_step_is_the_plain_one(
        planned, prefix, half):
    """The first batch of each tube model holds rows of the plan and of
    what it produced; its loss and the weights after one Adam step from
    the weights before the plan agree with the plain step."""
    weights, out, _pre, firsts = planned
    first = firsts[prefix]
    tubes = np.asarray(out["prod_tubes"])
    source = out["planned_cp"] if prefix == "cp_tube" else tubes
    for row, target in zip(first["x"].numpy(), first["y"].numpy()):
        i = int(np.nonzero((source == row).all(axis=(1, 2)))[0][0])
        expect = tubes[i] if prefix == "cp_tube" else out["prod_mels"][i]
        np.testing.assert_array_equal(target, expect)
    losses, _first, after = plain_train.train_steps(
        weights, [(first["x"], first["y"])], prefix=prefix, half=half)
    assert first["loss"] == pytest.approx(losses[0], rel=TOL)
    assert {ref_key(prefix, k) for k in first["after"]} == set(after[0])
    for name, w in first["after"].items():
        np.testing.assert_allclose(w.numpy(),
                                   after[0][ref_key(prefix, name)].numpy(),
                                   rtol=0, atol=TOL)
    assert len(out["tube_model_loss"]) == len(out["tube_mel_model_loss"]) == 2


def _expected_ops(tube_learning=True):
    """{(model, family, direction, T, B): count} of one plan of ``PLAN``:
    the prelude, 3 inner steps, the produced-audio metrics, 2 training
    steps per trained model; every layer H=16."""
    f, t, b = T_CP // 2, T_CP, BATCH
    n = collections.Counter()
    n["embedder", "pair", "fwd", f, b] += 2      # targets, produced
    n["inverse", "single", "fwd", f, b] += 1
    for d in ("fwd", "bwd"):
        n["embedder", "pair", d, f, b] += N_INNER
        for model in ("predictive", "cp_tube", "tube_mel"):
            n[model, "single", d, t, b] += N_INNER
        # dropout between its layers: one by one
        n["tube_embedder", "single", d, t, b] += 2 * N_INNER
        for model in ("predictive",) + (("cp_tube", "tube_mel")
                                        if tube_learning else ()):
            n[model, "single", d, t, 2] += 2
    n["cp_tube", "single", "fwd", t, b] += 1
    n["tube_mel", "single", "fwd", t, b] += 2    # produced, predicted
    n["tube_embedder", "pair", "fwd", t, b] += 1  # eval: no dropout
    return n


def test_each_op_record_names_the_model_that_launched_it(paule, traced,
                                                         monkeypatch):
    """The op records' per-model parts are the budget's counts, and they
    sum to each shape's count, which the wrappers' own calls give as
    before."""
    seen = collections.Counter()
    for name, key in (("lstm_fwd_plain", ("single", "fwd")),
                      ("lstm_bwd_plain", ("single", "bwd")),
                      ("lstm_stack2_fwd_plain", ("pair", "fwd")),
                      ("lstm_stack2_bwd_plain", ("pair", "bwd"))):
        def wrapped(x, *rest, _fn=getattr(K, name), _key=key):
            seen[(*_key, x.shape[0], x.shape[1], x.shape[2] // 4)] += 1
            return _fn(x, *rest)
        monkeypatch.setattr(K, name, wrapped)
    TB.plan_batch_resynth(paule, _mels(), **PLAN)
    rec = tracing.calls()[-1]
    assert rec["scope"] == "plan_batch_resynth"
    shapes = {(o["family"], o["direction"], o["T"], o["B"], o["H"]):
              o["count"] for o in rec["ops"]}
    assert shapes == dict(seen)
    parts = collections.Counter()
    for o in rec["ops"]:
        assert sum(p["count"] for p in o["models"].values()) == o["count"]
        assert all(p["device_ms"] is None for p in o["models"].values())
        for model, p in o["models"].items():
            parts[model, o["family"], o["direction"], o["T"], o["B"]] += (
                p["count"])
    assert parts == _expected_ops()
    assert tracing.MODEL is None


def test_the_tube_models_share_of_continue_learning(paule):
    TB.plan_batch_resynth(paule, _mels(), **PLAN)
    t = paule.last_planning_timings
    assert 0 < t["continue_learning_tube"] < t["continue_learning"]
    TB.plan_batch_resynth(paule, _mels(),
                          **dict(PLAN, continue_learning_tube=False))
    assert paule.last_planning_timings["continue_learning_tube"] == 0.0


def _copying_replicate(mesh, module):
    """``replicate`` with a copy of ``module`` for every shard but the
    first, as on a second card."""
    if module is None:
        return [None] * len(mesh.devices)
    return [module] + [copy.deepcopy(module) for _ in mesh.devices[1:]]


@pytest.mark.parametrize("layout", ["one", "shared", "copies"])
def test_a_sync_is_counted_and_timed_only_where_it_copies(
        paule, traced, layout, monkeypatch):
    """Without a mesh, and over a mesh whose replicas are the models
    themselves, nothing is copied: no count, no span.  With copies, every
    Adam step of the three trained models syncs once (2 each); on the CPU
    the span has no device time."""
    mesh = None
    if layout != "one":
        mesh = TM.make_mesh(devices=["cpu", "cpu"])
    if layout == "copies":
        monkeypatch.setattr(TM, "replicate", _copying_replicate)
    TB.plan_batch_resynth(paule, _mels(), mesh=mesh, **PLAN)
    rec = tracing.calls()[-1]
    leaves = {s["name"].split(".")[-1] for s in rec["spans"]
              if s["kind"] == "leaf" and ".continue_learning." in s["name"]}
    # the leaf marks where the host is, whether or not the call copies
    assert {"tube_batch", "tube_step", "sync_replicas"} <= leaves
    if layout == "copies":
        assert rec["device_spans"] == {
            "sync_replicas": {"count": 6, "device_ms": None}}
        assert rec["counters"]["sync_replicas"] == 6
        assert rec["counters"]["sync_replicas_bytes"] > 0
    else:
        assert rec["device_spans"] == {}
        assert rec["counters"]["sync_replicas"] == 0
        assert rec["counters"]["sync_replicas_bytes"] == 0


def test_off_a_call_records_nothing(paule, monkeypatch):
    """No record, no event, no ``perf_counter_ns``, no model name set; the
    clock read only for the phases and the tube models' share."""
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
    monkeypatch.setattr(torch.cuda, "Event",
                        counting("event", torch.cuda.Event))
    monkeypatch.setattr(time, "perf_counter_ns",
                        counting("perf_counter_ns", time.perf_counter_ns))
    monkeypatch.setattr(time, "perf_counter",
                        counting("perf_counter", time.perf_counter))
    monkeypatch.setattr(tracing, "set_model", counting("set_model",
                                                       tracing.set_model))
    monkeypatch.setattr(tracing, "phase", phase_counted)
    TB.plan_batch_resynth(paule, _mels(), **PLAN)
    monkeypatch.undo()
    assert len(tracing.calls()) == before
    assert used["event"] == used["perf_counter_ns"] == used["set_model"] == 0
    assert used["perf_counter"] == 2 * used["phase"] + 2
