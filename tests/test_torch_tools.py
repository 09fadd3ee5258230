"""The port's measurement and corpus-quality tools
(``paule_tpu_torch/tools/``) against the JAX tools of ``tools/``, on the
CPU in float64 at narrow widths (H=16): the FLOP counts and the slope fit
equal the JAX tools' (loaded by path; they import no JAX at top level);
each rung of the step decomposition's ladder gives the value and
gradient, and its loop the trajectory, of its JAX counterpart built from
``paule_tpu.planning.engine``; the corpus recipes give the JAX recipe's
cp arrays bit for bit; ``prod_loss_of`` agrees with the JAX recipe through
the smooth stand-in plant; each tool's ``run(device="cpu")`` at a tiny
budget returns the JAX tool's keys with finite numbers and no device
metric; and each ``main`` raises without a card instead of running on the
CPU."""

import importlib.util
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
                                   corpus_quality_run, hot_timing,
                                   profile_device, release_quality_run,
                                   roofline, step_decomposition, timing)
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
# each tool's run on the CPU, and its main without a card
# ---------------------------------------------------------------------------

def _narrow_paule(seed, pretrained_dir="random"):
    """A CPU float64 ``Paule`` whose forward, inverse and embedder models
    are seeded at H=16, with trainers for them."""
    p = Paule(seed=seed, pretrained_dir=pretrained_dir, **F64)
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
#: babble median (``r4_babble_bootstrap_median``)
SMALL = dict(hidden=HIDDEN, t_cp=SEQ)
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
}
#: device metrics, ``None`` on the CPU
DEVICE_METRICS = {"card", "planning_flops_per_s", "mfu_vs_f32_peak_B1",
                  "flops_per_s", "mfu_vs_f32_peak", "device_busy_s",
                  "device_busy_share", "device_busy_share_of_untraced"}


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
    if name == "release_quality_run":
        assert set(out["rows"]) == {"release_mb2", "release_mb4",
                                    "random_init"}
        for row in out["rows"].values():
            assert {"weights", "max_batch", "corpus_wall_s",
                    "median_final_prod_loss", "p10", "p90"} <= set(row)


@pytest.mark.parametrize("tool", [
    hot_timing, roofline, batch_scaling, step_decomposition, profile_device,
    bench_serve, corpus_quality_run, release_quality_run],
    ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_without_a_card_raises(tool, monkeypatch):
    """``main`` measures on the card only; it never falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
