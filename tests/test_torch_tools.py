"""The port's measurement and corpus-quality tools
(``paule_tpu_torch/tools/``) against the JAX tools of ``tools/``, on the
CPU in float64 at narrow widths (H=16): the FLOP counts and the slope fit
equal the JAX tools' (loaded by path; they import no JAX at top level);
each rung of the step decomposition's ladder gives the value and
gradient, and its loop the trajectory, of its JAX counterpart built from
``paule_tpu.planning.engine``; the corpus recipes give the JAX recipe's
cp arrays bit for bit; ``prod_loss_of`` agrees with the JAX recipe through
the smooth stand-in plant; the launch probe's chain equals the JAX tool's,
and its fit and the variants' and the synthesis breakdown's summaries equal
what the JAX tools' ``main`` prints from the same timings; each tool's
``run(device="cpu")`` at a tiny budget returns the JAX tool's keys with
finite numbers and no device metric; and each ``main`` raises without a
card instead of running on the CPU."""

import importlib.util
import io
import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paule_tpu import pretrain as JP
from paule_tpu.dsp.mel import librosa_melspec as j_melspec
from paule_tpu.models import embedder as JE
from paule_tpu.models import forward as JF
from paule_tpu.ops import losses as JL
from paule_tpu.ops import lstm as JLS
from paule_tpu.ops import pallas_lstm as PL
from paule_tpu.ops.normalize import inv_normalize_cp as j_inv_cp
from paule_tpu.ops.normalize import normalize_mel as j_norm_mel
from paule_tpu.planning import engine as JEng
from paule_tpu_torch.api import Paule
from paule_tpu_torch.models.blocks import init_random
from paule_tpu_torch.models.embedder import EmbeddingModel
from paule_tpu_torch.models.forward import ForwardModel
from paule_tpu_torch.models.inverse import InverseModelMelTimeSmoothResidual
from paule_tpu_torch.planning import engine as TEng
from paule_tpu_torch.planning.trainer import ModelTrainer
from paule_tpu_torch.release import load_into
from paule_tpu_torch.tools import (batch_scaling, bench_serve,
                                   bench_variants, corpus_quality_run,
                                   hot_timing, launch_overhead_probe,
                                   profile_device, release_quality_run,
                                   roofline, step_decomposition,
                                   synthesis_breakdown, timing)
from torch_parity import SmoothPlant
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: the criterion's tolerance (tests/test_torch_planning.py)
ATOL = 1e-8
HIDDEN = 16
SEQ = 16
F64 = {"device": "cpu", "dtype": torch.float64}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """The JAX tool ``tools/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# helpers copied from the JAX tools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (402, 30, 720, 1), (201, 60, 720, 2), (7, 3, 5, 3), (1, 1, 1, 1)])
def test_lstm_flops_equal_the_jax_tools(args):
    jax_tool = _jax_tool("profile_device")
    assert profile_device.lstm_flops(*args) == jax_tool.lstm_flops(*args)


@pytest.mark.parametrize("t_cp,batch", [(402, 1), (402, 8), (201, 32),
                                        (9, 3)])
def test_planning_step_flops_equal_the_jax_tools(t_cp, batch):
    jax_tool = _jax_tool("profile_device")
    assert (profile_device.planning_step_flops(t_cp, batch)
            == jax_tool.planning_step_flops(t_cp, batch))


@pytest.mark.parametrize("t_cp,batch", [(402, 1), (402, 8), (9, 3)])
def test_acoustic_step_flops_leave_out_the_embedder(t_cp, batch):
    """The batched row's ``acoustic`` step is the JAX tool's step less its
    embedder part, which that criterion never runs."""
    jax_tool = _jax_tool("profile_device")
    hidden = profile_device.HIDDEN
    embedder = batch * 3 * (jax_tool.lstm_flops(t_cp // 2, 60, hidden, 2)
                            + 2 * hidden * 300)
    assert (profile_device.acoustic_step_flops(t_cp, batch)
            == jax_tool.planning_step_flops(t_cp, batch) - embedder)


def test_fit_slope_equals_the_jax_tools():
    jax_tool = _jax_tool("roofline")
    ts = [51, 201, 402, 804]
    walls = [0.00071, 0.0021, 0.0043, 0.0081]
    assert roofline._fit_slope(ts, walls) == jax_tool._fit_slope(ts, walls)


# ---------------------------------------------------------------------------
# the step decomposition's ladder
# ---------------------------------------------------------------------------

def _ladder_setup(seed=0):
    """Port models loaded with JAX's weights (H=16), a trajectory and
    targets from a seed; JAX's models as the JAX tool assembles them."""
    jf = JF.ForwardModel(num_lstm_layers=1, hidden_size=HIDDEN)
    je = JE.EmbeddingModel(num_lstm_layers=2, hidden_size=HIDDEN)
    pf = jf.init(jax.random.PRNGKey(seed), jnp.float64)
    pe = je.init(jax.random.PRNGKey(seed + 1), jnp.float64)
    bundle = JEng.ModelBundle(pred_model=jf, pred_params=pf, embedder=je,
                              embedder_params=pe)
    dyn, static = JEng.split_bundle(bundle)
    jmodels = static._replace(**dyn)
    models = TEng.Models(
        load_into(ForwardModel(num_lstm_layers=1, hidden_size=HIDDEN),
                  jax.tree.map(np.asarray, pf), **F64).requires_grad_(False),
        load_into(EmbeddingModel(num_lstm_layers=2, hidden_size=HIDDEN),
                  jax.tree.map(np.asarray, pe), **F64).requires_grad_(False))
    rng = np.random.default_rng(seed)
    xx = np.clip(rng.normal(0, 0.05, (1, SEQ, 30)).cumsum(1), -1, 1)
    tmel = rng.normal(size=(1, SEQ // 2, 60)) * 0.3
    tsem = rng.normal(size=(1, 300)) * 0.3
    return models, (jmodels, dyn, static), xx, tmel, tsem


def _jax_ladder(jmodels, tmel, tsem):
    """The ``vg_*`` rungs' losses of ``tools/step_decomposition.py:118-147``
    (``x, k -> loss``)."""
    pp = jmodels.pred_params["lstm"][0]
    h0 = jnp.zeros((1, HIDDEN), dtype=jnp.float64)

    def loss_criterion(x, k):
        total, _aux = JEng.criterion(
            jmodels, x, tmel, tsem, objective="acoustic_semvec",
            use_speech_classifier=False, use_somatosensory=False,
            log_semantics=True, rng=k)
        return total

    def loss_models(x, k):
        pm = jmodels.pred_model.apply(jmodels.pred_params, x)
        sv = jmodels.embedder.apply(jmodels.embedder_params, pm, None,
                                    deterministic=False, rng=k)
        return (JEng.MEL_WEIGHT * JL.rmse(pm, tmel)
                + JEng.SEMANTIC_WEIGHT * JL.rmse(sv, tsem))

    def loss_models_sum(x, k):
        pm = jmodels.pred_model.apply(jmodels.pred_params, x)
        sv = jmodels.embedder.apply(jmodels.embedder_params, pm, None,
                                    deterministic=False, rng=k)
        return jnp.sum(pm) + jnp.sum(sv)

    def loss_pred_only(x, k):
        # the JAX tool runs the input projection and the Pallas lstm_core,
        # which is float32 only; in float64 the JAX package runs the same
        # function through lstm_layer's scan, the kernel's plain reference
        # (tests/test_pallas_lstm.py holds one against the other)
        hs, _ = JLS.lstm_layer(pp, x, h0, h0)
        return jnp.sum(hs)

    return {"vg_criterion": loss_criterion, "vg_models": loss_models,
            "vg_models_sum": loss_models_sum, "vg_pred_only": loss_pred_only}


@pytest.mark.parametrize("rung", ["vg_criterion", "vg_models",
                                  "vg_models_sum", "vg_pred_only"])
def test_ladder_rung_matches_jax(rung):
    """A rung's value and gradient, and its loop of 2 steps of ``x -= 1e-4
    g``, against the JAX tool's."""
    models, (jmodels, _dyn, _static), xx, tmel, tsem = _ladder_setup()
    loss_t = step_decomposition.ladder_losses(
        models, torch.tensor(tmel), torch.tensor(tsem))[rung]
    loss_j = _jax_ladder(jmodels, jnp.asarray(tmel), jnp.asarray(tsem))[rung]
    key = jax.random.PRNGKey(1)

    value, grad = step_decomposition.value_and_grad(loss_t, torch.tensor(xx))
    value_j, grad_j = jax.value_and_grad(loss_j)(jnp.asarray(xx), key)
    np.testing.assert_allclose(value.numpy(), np.asarray(value_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), rtol=0,
                               atol=ATOL)

    x_j = jnp.asarray(xx)
    for _ in range(2):
        x_j = x_j - step_decomposition.STEP * jax.grad(loss_j)(x_j, key)
    x_t = step_decomposition.descend(loss_t, torch.tensor(xx), 2)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=ATOL)


def test_ladder_full_rung_matches_jax():
    """The ``full`` rung: 3 real planning steps from the zero trajectory
    (``roofline.planning_run``) against JAX's ``plan_segment`` as the JAX
    tool calls it."""
    models, (_jm, dyn, static), _xx, _tmel, _tsem = _ladder_setup()
    x_t = roofline.planning_run(models, 1, 3, SEQ, "cpu", torch.float64)()
    zeros = [jnp.zeros(s, dtype=jnp.float64)
             for s in ((1, SEQ, 30), (1, SEQ // 2, 60), (1, 300))]
    x_j = JEng.plan_segment(
        dyn, static, zeros[0], JEng.init_opt_state(zeros[0], 0.01),
        zeros[1], zeros[2], jax.random.PRNGKey(1), n_steps=3,
        objective="acoustic_semvec", use_speech_classifier=False,
        use_somatosensory=False, log_semantics=True,
        constraints=JEng.Constraints(), lr=0.01, log_every=1)[0]
    np.testing.assert_allclose(x_t.detach().numpy(), np.asarray(x_j),
                               rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the corpus tools' recipes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool,jax_name,n_utt", [
    (corpus_quality_run, "corpus_quality_run", 50),
    (release_quality_run, "release_quality_run", 64)])
def test_corpus_cps_equal_the_jax_recipe(tool, jax_name, n_utt):
    """``rng(42)``, ``LENGTHS`` in turn, ``random_cp_trajectory``: bit for
    bit, and the generator left where JAX's is (the long utterance)."""
    jax_tool = _jax_tool(jax_name)
    assert tool.LENGTHS == jax_tool.LENGTHS
    assert tool.settings({})["n_utt"] == n_utt
    rng = np.random.default_rng(42)
    ref = [JP.random_cp_trajectory(rng, jax_tool.LENGTHS[i % 4])
           for i in range(n_utt)]
    cps, rng_t = tool.corpus_cps(n_utt)
    assert len(cps) == n_utt
    for a, b in zip(cps, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(JP.random_cp_trajectory(rng, 400),
                          corpus_quality_run.pretrain.random_cp_trajectory(
                              rng_t, 400))


def test_prod_loss_of_matches_the_jax_recipe():
    """``prod_loss_of`` of a fixed planned trajectory against the JAX
    tool's recipe (``tools/corpus_quality_run.py:86-95``), both through
    the smooth stand-in plant."""
    plant = SmoothPlant()
    rng = np.random.default_rng(5)
    target = plant.speak(j_inv_cp(JP.random_cp_trajectory(rng, 120)))
    planned = JP.random_cp_trajectory(rng, 120)

    tmel = np.asarray(j_norm_mel(j_melspec(*target)))
    tmel = tmel - tmel.min()
    psig, psr = plant.speak(j_inv_cp(np.asarray(planned)))
    pmel = np.asarray(j_norm_mel(j_melspec(psig, psr)))
    n = min(len(tmel), len(pmel))
    ref = 5.0 * float(np.sqrt(np.mean((pmel[:n] - tmel[:n]) ** 2)))

    got = corpus_quality_run.prod_loss_of(planned, target, plant.speak, **F64)
    assert got == pytest.approx(ref, rel=0, abs=1e-10)
    assert ref > 0.1


# ---------------------------------------------------------------------------
# the launch probe's chain and fit
# ---------------------------------------------------------------------------

def _f64_lstm_core():
    """The Pallas ``lstm_core``'s contract in float64, which the kernel
    (float32 only) cannot run: ``(gates_x, w_hh, h0, c0) -> (hs, cs)`` by
    the JAX package's scan step, its gradient exact through ``hs`` and
    blind to the cotangent of ``cs`` (``pallas_lstm.py:203-210``).  The
    port's ``LSTMCore`` is held against the kernel itself in interpret mode
    by ``tests/test_torch_lstm.py``."""
    def scan(gates_x, w_hh, h0, c0):
        def step(carry, gx):
            h, c = carry
            i, f, g, o = jnp.split(gx + h @ w_hh, 4, axis=-1)
            c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
            h = jax.nn.sigmoid(o) * jnp.tanh(c)
            return (h, c), (h, c)
        return jax.lax.scan(step, (h0, c0), gates_x)[1]

    @jax.custom_vjp
    def core(gates_x, w_hh, h0, c0):
        return scan(gates_x, w_hh, h0, c0)

    def core_fwd(*args):
        return scan(*args), args

    def core_bwd(args, cts):
        ghs, _gcs = cts
        return jax.vjp(lambda *a: scan(*a)[0], *args)[1](ghs)

    core.defvjp(core_fwd, core_bwd)
    return core


@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "fwdbwd"])
@pytest.mark.parametrize("k_calls", [1, 3])
def test_launch_chain_matches_the_jax_tool(k_calls, grad, monkeypatch):
    """``chain_fn``'s scalar against the JAX tool's ``chain_fn`` (its
    ``H=16``, ``B=1``) on the same seeded gates and ``w_hh``, float64."""
    jax_tool = _jax_tool("launch_overhead_probe")
    monkeypatch.setattr(jax_tool, "H", HIDDEN)
    monkeypatch.setattr(jax_tool, "B", 1)
    monkeypatch.setattr(PL, "lstm_core", _f64_lstm_core())
    rng = np.random.default_rng(k_calls)
    gates = rng.normal(0, 0.3, (10, 1, 4 * HIDDEN))
    w_hh = rng.normal(0, 0.2, (HIDDEN, 4 * HIDDEN))
    ref = float(jax_tool.chain_fn(k_calls, grad)(jnp.asarray(gates),
                                                 jnp.asarray(w_hh)))
    got = launch_overhead_probe.chain_fn(
        k_calls, grad, hidden=HIDDEN, batch=1, device="cpu")(
        torch.tensor(gates), torch.tensor(w_hh))
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(ref, rel=0, abs=1e-8)
    assert abs(ref) > 1e-2


def test_fit_launch_cost_equals_the_jax_tools(monkeypatch, capsys):
    """``fit_launch_cost`` and the walls' table against what the JAX
    tool's ``main`` prints from the same walls (its timing and chains
    replaced, nothing written)."""
    rng = np.random.default_rng(3)
    walls = {tag: {(t, k): float(rng.uniform(2e-4, 6e-4)
                                 + k * (rng.uniform(5e-6, 3e-5)
                                        + t * rng.uniform(2e-6, 8e-6)))
                   for t in (64, 256) for k in (1, 8)}
             for tag in ("fwd", "fwdbwd")}
    jax_tool = _jax_tool("launch_overhead_probe")
    monkeypatch.setattr(jax_tool, "H", HIDDEN)
    monkeypatch.setattr(jax_tool, "chain_fn", lambda k, grad: (
        "fwdbwd" if grad else "fwd", k))
    monkeypatch.setattr(jax_tool, "timed", lambda fn, gates, _w: walls[
        fn[0]][(gates.shape[0], fn[1])])
    monkeypatch.setattr(jax_tool, "open", lambda *a, **k: io.StringIO(),
                        raising=False)
    jax_tool.main()
    ref = json.loads(capsys.readouterr().out)
    for tag, w in walls.items():
        assert launch_overhead_probe.fit_launch_cost(w) == (
            ref["per_launch"][tag])
        assert launch_overhead_probe.walls_ms(w) == ref["walls_ms"][tag]


# ---------------------------------------------------------------------------
# the variants and the synthesis breakdown against the JAX tools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", range(3))
def test_variants_build_as_the_jax_tool(variant, monkeypatch):
    """``build``'s instance keywords and plan keywords against the JAX
    ``build``'s (its ``Paule`` a stub)."""
    import paule_tpu.api as JA

    made = []
    monkeypatch.setattr(JA, "Paule", lambda **kw: made.append(kw))
    jax_tool = _jax_tool("bench_variants")
    name, kwargs = bench_variants.VARIANTS[variant]
    assert jax_tool.VARIANTS[variant] == (name, kwargs)
    target = object()
    _p, kw_ref = jax_tool.build(kwargs, target)
    got = []
    _p, kw = bench_variants.build(kwargs, target,
                                  lambda **k: got.append(k) or "paule")
    assert kw == kw_ref and kw["target_acoustic"] is target
    assert made == [dict(seed=1, **kwargs)] and got == [kwargs]


class _Clock:
    """A stand-in for a tool's ``time``: ``perf_counter`` returns 0 at each
    start and the next scripted duration at each end."""

    def __init__(self, durations):
        self._durations = iter(durations)
        self._started = False

    def perf_counter(self):
        self._started = not self._started
        return 0.0 if self._started else next(self._durations)


def _scripted_rounds(names, reps, seed):
    """Seeded walls (for 2 outers) and phase splits of ``reps`` rounds over
    ``names``, in the order the JAX tools take them."""
    rng = np.random.default_rng(seed)
    order = [(rep, n) for rep in range(reps) for n in names]
    durations = [float(rng.uniform(0.5, 2.5)) for _ in order]
    splits = [{k: float(rng.uniform(0.01, 0.9)) for k in (
        "planning", "synthesis", "metrics", "continue_learning")}
        for _ in order]
    return order, durations, splits


def _stub_jax_side(monkeypatch, tmp_path, splits):
    """The JAX package's ``Paule`` a stub whose 2-outer calls report the
    scripted ``splits`` in turn, ``SynthPool`` a stub, the backend "tpu",
    and the working directory ``tmp_path``."""
    import paule_tpu.api as JA
    from paule_tpu import synth as JS

    scripted = iter(splits)

    class StubPaule:
        def __init__(self, **kw):
            self._synth_pool = None

        def plan_resynth(self, n_outer, **kw):
            if n_outer == 2:
                self.last_planning_timings = next(scripted)

    class StubPool:
        def __init__(self, size):
            del size

        def speak_batch(self, cps):
            del cps

    monkeypatch.setattr(JA, "Paule", StubPaule)
    monkeypatch.setattr(JS, "SynthPool", StubPool)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.chdir(tmp_path)


def _per_outer(order, durations, splits, names):
    walls = {n: [] for n in names}
    per_outer = {n: [] for n in names}
    for (_rep, n), d, split in zip(order, durations, splits):
        walls[n].append(d / 2)
        per_outer[n].append({k: v / 2 for k, v in split.items()})
    return walls, per_outer


def _run_jax_main(jax_tool, monkeypatch, capsys, durations):
    monkeypatch.setattr(jax_tool, "REPS", 3)
    monkeypatch.setattr(jax_tool, "time", _Clock(durations))
    monkeypatch.setattr(jax_tool, "open", lambda *a, **k: io.StringIO(),
                        raising=False)
    assert jax_tool.main() == 0
    return json.loads(capsys.readouterr().out)


def test_variants_summary_equals_the_jax_tools(monkeypatch, capsys,
                                               tmp_path):
    names = [n for n, _ in bench_variants.VARIANTS]
    order, durations, splits = _scripted_rounds(names, 3, seed=4)
    _stub_jax_side(monkeypatch, tmp_path, splits)
    ref = _run_jax_main(_jax_tool("bench_variants"), monkeypatch, capsys,
                        durations)
    walls, per_outer = _per_outer(order, durations, splits, names)
    got = bench_variants.summarize(walls, per_outer, 3, 2,
                                   timing.budget_line(25, 10, 3, 8))
    assert got == ref
    assert ref["somatosensory"]["vs_acoustic_semvec_iqr"][0] > 0
    assert not any((tmp_path / "docs" / "measurements").iterdir())


def test_breakdown_summary_equals_the_jax_tools(monkeypatch, capsys,
                                                tmp_path):
    names = list(synthesis_breakdown.STRATEGIES)
    order, durations, splits = _scripted_rounds(names, 3, seed=5)
    floors = [0.151, 0.1234567, 0.133]
    _stub_jax_side(monkeypatch, tmp_path, splits)
    ref = _run_jax_main(_jax_tool("synthesis_breakdown"), monkeypatch,
                        capsys, floors + durations)
    walls, per_outer = _per_outer(order, durations, splits, names)
    got = synthesis_breakdown.summarize(
        walls, per_outer, min(floors), 25, 3, 2,
        timing.budget_line(25, 10, 3, 8) + ", T=402")
    del ref["notes"]
    for name in names:
        assert set(got[name]) - set(ref[name]) == {"s_per_outer_iqr"}
        del got[name]["s_per_outer_iqr"]
    assert got == ref
    assert ref["batch"]["overhead_vs_cpp_floor_ms"] != 0
    assert not any((tmp_path / "docs" / "measurements").iterdir())


@pytest.mark.parametrize("name,overlap,calls", [
    ("per_snapshot", False, {"speak": 1 + 3, "speak_batch": 0}),
    ("batch", False, {"speak": 1, "speak_batch": 1}),
    ("batch_overlap", 2, {"speak": 1, "speak_batch": 2})])
def test_breakdown_strategies_and_their_plant_calls(name, overlap, calls):
    """The strategies' ``plan_overlap`` and the plant calls of one outer
    iteration of 3 inner steps (counted on the smooth stand-in plant): one
    ``speak`` for the initial trajectory, then the snapshots one by one
    without the batch entry, else one batch call per chunk."""
    made = []

    def make(plan_overlap):
        made.append(plan_overlap)
        return _narrow_paule(1, plant=SmoothPlant(),
                             plan_overlap=plan_overlap)

    strategies = synthesis_breakdown.build_strategies(make)
    try:
        assert made == [False, False, 2]
        model = strategies[name]
        assert model.plan_overlap == overlap
        target = SmoothPlant().speak(j_inv_cp(
            JP.random_cp_trajectory(np.random.default_rng(6), 24)))
        model.plan_resynth(n_outer=1, **timing.plan_kwargs(
            target, n_inner=3, n_epochs=1, n_batches=1, batch_size=2))
        assert dict(model.plant.calls) == calls
    finally:
        for model in strategies.values():
            model.close()


# ---------------------------------------------------------------------------
# each tool's run on the CPU, and its main without a card
# ---------------------------------------------------------------------------

def _narrow_paule(seed, pretrained_dir="random", **kw):
    """A CPU float64 ``Paule`` (``kw`` its further keywords) whose forward,
    inverse and embedder models are seeded at H=16, with trainers for
    them."""
    p = Paule(seed=seed, pretrained_dir=pretrained_dir, **F64, **kw)
    gen = torch.Generator().manual_seed(seed)
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
    p.pred_trainer = ModelTrainer(p.pred_model, loss="rmse")
    p.inv_trainer = ModelTrainer(p.inv_model, loss="cp_trajectory")
    return p


def _with(seed, tool_run, **kw):
    p = _narrow_paule(seed)
    try:
        return tool_run(device="cpu", paule=p, **kw)
    finally:
        p.close()


#: the JAX tools' output keys (``tools/<tool>.py``), and what each run
#: returns on the CPU; renamed keys: the port's profile counts the
#: kernels' launches (``pallas_lstm_active`` -> ``lstm_kernels_active``)
#: and rates against the card's float32 peak (``mfu_vs_bf16_peak_B1`` ->
#: ``mfu_vs_f32_peak_B1``); the release tool drops the JAX run's own
#: babble median (``r4_babble_bootstrap_median``); the launch probe's
#: projection measures its gap in the same process (``r4_gap_ms`` ->
#: ``measured_minus_floor_ms``)
SMALL = dict(hidden=HIDDEN, t_cp=SEQ)
ROOF_SMALL = dict(t_cp=SEQ, t_lens=(4, 16, 64), step_counts=(1, 3, 6),
                  reps=2, step_reps=2)
TINY_PLAN = dict(reps=2, outers_per_rep=1, t=24, n_inner=2, n_epochs=1,
                 n_batches=1, batch_size=2)
RUNS = {
    "hot_timing": (
        {"hot_wall_s", "timings", "final_prod_loss", "n_outer", "t_frames"},
        lambda: _with(7, hot_timing.run, n_outer=1, t=24, n_inner=2,
                      n_epochs=1, n_batches=1, batch_size=2)),
    "roofline": (
        {"backend", "hidden", "t_cp", "per_step_us", "derived_vs_measured",
         "method"},
        lambda: roofline.run(device="cpu", batches=(1, 3), t_lens=(4, 16, 64),
                             step_counts=(1, 3, 6), reps=2, step_reps=2,
                             **SMALL)),
    "batch_scaling": (
        {"backend", "shape", "method", "batches"},
        lambda: batch_scaling.run(device="cpu", batches=(1, 2),
                                  step_counts=(1, 3, 6), reps=2, **SMALL)),
    "step_decomposition": (
        {"backend", "hidden", "t_cp", "method", "per_inner_step_ms",
         "walls_ms"},
        lambda: step_decomposition.run(device="cpu", step_counts=(1, 3, 6),
                                       reps=2, **SMALL)),
    "profile_device": (
        {"backend", "lstm_kernels_active", "budget", "wall_s",
         "phase_split_s", "phase_split_pct", "planning_flops_analytic",
         "planning_flops_per_s", "mfu_vs_f32_peak_B1", "batched_B8",
         "profiler_trace", "notes"},
        lambda: _with(1, profile_device.run, t_cp=24, n_inner=2, n_outer=1,
                      n_epochs=1, n_batches=1, batch_size=2)),
    "bench_serve": (
        {"host", "metrics"},
        lambda: _with(9, bench_serve.run, n=2, plan_n=1)),
    "corpus_quality_run": (
        {"n_utterances", "budget", "babble", "corpus_wall_s",
         "final_prod_loss", "outer1_prod_loss_median",
         "preplan_prod_loss_median", "fraction_better_than_preplan",
         "long_utterance", "total_wall_s"},
        lambda: _with(2, corpus_quality_run.run, n_utt=4, n_outer=1,
                      n_inner=2, babble_n=4, babble_epochs=1, n_long=80)),
    "release_quality_run": (
        {"n_utterances", "budget", "release_version", "release_sha256",
         "rows", "winning_max_batch_by_corpus_wall", "total_wall_s"},
        lambda: release_quality_run.run(
            device="cpu", make_paule=lambda d: _narrow_paule(2, d), n_utt=4,
            n_outer=1, n_inner=2, max_batches=(2, 4))),
    "launch_overhead_probe": (
        {"backend", "hidden", "batch", "reps", "walls_ms", "per_launch",
         "projection"},
        lambda: launch_overhead_probe.run(device="cpu", hidden=HIDDEN,
                                          reps=2, roofline_kw=ROOF_SMALL)),
    "synthesis_breakdown": (
        {"budget", "method", "standalone_cpp_ms_per_snapshot",
         "per_snapshot", "batch", "batch_overlap", "notes"},
        lambda: synthesis_breakdown.run(
            device="cpu", make_paule=lambda overlap: _narrow_paule(
                1, plan_overlap=overlap), **TINY_PLAN)),
    "bench_variants": (
        {"budget", "method", "acoustic_semvec", "speech_classifier",
         "somatosensory"},
        lambda: bench_variants.run(
            device="cpu", make_paule=lambda **kw: _narrow_paule(1, **kw),
            **TINY_PLAN)),
}
#: device metrics, ``None`` on the CPU
DEVICE_METRICS = {"card", "planning_flops_per_s", "mfu_vs_f32_peak_B1",
                  "flops_per_s", "mfu_vs_f32_peak", "device_busy_s",
                  "device_busy_share", "device_busy_share_of_untraced",
                  "per_launch_device", "device_walls_ms",
                  "device_fixed_cost_bill_ms"}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_on_the_cpu_gives_the_jax_keys(name):
    keys, call = RUNS[name]
    out = call()
    assert keys <= set(out), keys - set(out)
    assert out["device"] == "cpu" and out["card"] is None
    for key, value in timing.leaf_numbers(out):
        if key in DEVICE_METRICS:
            assert value is None, key
        else:
            assert value is not None and math.isfinite(value), key
    if name == "step_decomposition":
        assert list(out["per_inner_step_ms"]) == [
            "full", "vg_criterion", "vg_models", "vg_models_sum",
            "vg_pred_only"]
    if name == "bench_serve":
        assert set(out["metrics"]) == {
            "health", "synthesize_T201", "synthesize_T403", "embed_F100",
            "plan_2x10", "synthesize_T201_concurrent4"}
    if name == "profile_device":
        assert set(out["profiler_trace"]) == {
            "planning", "synthesis", "metrics", "continue_learning"}
        assert out["lstm_kernels_active"] is False
    if name == "launch_overhead_probe":
        assert set(out["per_launch"]) == {"fwd", "fwdbwd"}
        assert out["projection"]["launch_pairs_per_inner_step"] == 2
    if name == "synthesis_breakdown":
        # 3 plan_resynth calls of 1 outer iteration, 2 snapshots each
        assert out["per_snapshot"]["native_calls"] == {
            "speak": 3 + 3 * 2, "speak_batch": 0}
        assert out["batch_overlap"]["native_calls"] == {
            "speak": 3, "speak_batch": 3 * 2}
    if name == "bench_variants":
        for variant in ("speech_classifier", "somatosensory"):
            assert len(out[variant]["vs_acoustic_semvec_all"]) == 2
    if name == "release_quality_run":
        assert set(out["rows"]) == {"release_mb2", "release_mb4",
                                    "random_init"}
        for row in out["rows"].values():
            assert {"weights", "max_batch", "corpus_wall_s",
                    "median_final_prod_loss", "p10", "p90"} <= set(row)


@pytest.mark.parametrize("tool", [
    hot_timing, roofline, batch_scaling, step_decomposition, profile_device,
    bench_serve, corpus_quality_run, release_quality_run,
    launch_overhead_probe, synthesis_breakdown, bench_variants],
    ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_without_a_card_raises(tool, monkeypatch):
    """``main`` measures on the card only; it never falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
