"""The port's planning engine against ``paule_tpu.planning.engine``: a
3-step segment from the same trajectory with the same (small, H=16) models
in float64 gives the same trajectory, sub-loss series, snapshots and
gradients under each objective; the criterion also under the
speech-classifier and somatosensory variants (the tube embedder's dropout
masks those JAX draws); the constraint projections match."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paule_tpu.models import classifier as JC
from paule_tpu.models import embedder as JE
from paule_tpu.models import forward as JF
from paule_tpu.planning import engine as JEng
from paule_tpu_torch.models.classifier import LinearClassifier
from paule_tpu_torch.models.embedder import EmbeddingModel
from paule_tpu_torch.models.forward import ForwardModel
from paule_tpu_torch.planning import engine as TEng
from paule_tpu_torch.release import load_into
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-8
F64 = {"device": "cpu", "dtype": torch.float64}


def _setup(seed=0, seq=16):
    jf = JF.ForwardModel(num_lstm_layers=1, hidden_size=16)
    je = JE.EmbeddingModel(num_lstm_layers=2, hidden_size=16)
    pf = jf.init(jax.random.PRNGKey(seed), jnp.float64)
    pe = je.init(jax.random.PRNGKey(seed + 1), jnp.float64)
    rng = np.random.default_rng(seed)
    xx = np.clip(rng.normal(0, 0.05, (1, seq, 30)).cumsum(1), -1, 1)
    target_mel = rng.normal(size=(1, seq // 2, 60)) * 0.3
    target_semvec = rng.normal(size=(1, 300)) * 0.3
    models = TEng.Models(
        load_into(ForwardModel(num_lstm_layers=1, hidden_size=16),
                  jax.tree.map(np.asarray, pf), **F64),
        load_into(EmbeddingModel(num_lstm_layers=2, hidden_size=16),
                  jax.tree.map(np.asarray, pe), **F64))
    bundle = JEng.ModelBundle(pred_model=jf, pred_params=pf, embedder=je,
                              embedder_params=pe)
    return models, bundle, xx, target_mel, target_semvec


@pytest.mark.parametrize("objective,log_every", [
    ("acoustic_semvec", 1), ("acoustic", 1), ("acoustic_semvec", 2),
    ("semvec", 1)])
def test_segment_matches_jax(objective, log_every):
    models, bundle, xx, tmel, tsem = _setup()
    lr, n_steps = 0.01, 3
    dyn, static = JEng.split_bundle(bundle)
    xx_j, _state, logs_j = JEng.plan_segment(
        dyn, static, jnp.asarray(xx), JEng.init_opt_state(
            jnp.asarray(xx), lr), jnp.asarray(tmel), jnp.asarray(tsem),
        jax.random.PRNGKey(0), n_steps=n_steps, objective=objective,
        use_speech_classifier=False, use_somatosensory=False,
        log_semantics=True, constraints=JEng.Constraints(), lr=lr,
        log_every=log_every)

    xt = torch.tensor(xx, requires_grad=True)
    logs_t = TEng.plan_segment(
        models, xt, TEng.make_optimizer(xt, lr), torch.tensor(tmel),
        torch.tensor(tsem), n_steps=n_steps, objective=objective,
        log_semantics=True, constraints=TEng.Constraints(),
        log_every=log_every)

    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xx_j),
                               rtol=0, atol=ATOL)
    for field in TEng.SubLosses._fields:
        np.testing.assert_allclose(
            getattr(logs_t["sub_losses"], field).numpy(),
            np.asarray(getattr(logs_j["sub_losses"], field)), rtol=0,
            atol=ATOL, err_msg=field)
    for key in ("xx_pre", "pred_mel", "pred_semvec", "grads", "grad_max",
                "grad_min"):
        np.testing.assert_allclose(logs_t[key].numpy(),
                                   np.asarray(logs_j[key]), rtol=0,
                                   atol=ATOL, err_msg=key)


def _variant(models, bundle, variant, seed=5):
    """Add a variant's (small) models to both sides: the linear speech
    classifier, or cp->tube (H=12), tube->mel (H=12) and the tube embedder
    (two layers, H=16, dropout 0.7)."""
    if variant == "plain":
        return models, bundle
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 3))
    if variant == "speech_classifier":
        jc = JC.LinearClassifier(input_dim=60, output_dim=1)
        pc = jc.init(next(keys), jnp.float64)
        return (models._replace(speech_classifier=load_into(
                    LinearClassifier(), jax.tree.map(np.asarray, pc), **F64)),
                bundle._replace(speech_classifier=jc,
                                speech_classifier_params=pc))
    shapes = {"cp_tube": dict(num_lstm_layers=1, hidden_size=12,
                              output_size=10, input_size=30,
                              apply_half_sequence=False),
              "tube_mel": dict(num_lstm_layers=1, hidden_size=12,
                               output_size=60, input_size=10,
                               apply_half_sequence=True)}
    jtube = {k: JF.ForwardModel(**v) for k, v in shapes.items()}
    ptube = {k: m.init(next(keys), jnp.float64) for k, m in jtube.items()}
    je = JE.EmbeddingModel(input_size=10, num_lstm_layers=2, hidden_size=16,
                           dropout=0.7)
    pe = je.init(next(keys), jnp.float64)
    port = {k: load_into(ForwardModel(**shapes[k]),
                         jax.tree.map(np.asarray, ptube[k]), **F64)
            for k in shapes}
    return (models._replace(
                cp_tube_model=port["cp_tube"],
                tube_mel_model=port["tube_mel"],
                tube_embedder=load_into(
                    EmbeddingModel(input_size=10, num_lstm_layers=2,
                                   hidden_size=16, dropout=0.7),
                    jax.tree.map(np.asarray, pe), **F64).eval()),
            bundle._replace(
                cp_tube_model=jtube["cp_tube"],
                cp_tube_params=ptube["cp_tube"],
                tube_mel_model=jtube["tube_mel"],
                tube_mel_params=ptube["tube_mel"], tube_embedder=je,
                tube_embedder_params=pe))


@pytest.mark.parametrize("objective,variant", [
    # the plain criterion's cases keep their ids
    pytest.param(objective, variant, id=objective if variant == "plain"
                 else f"{objective}-{variant}")
    for variant in ("plain", "speech_classifier", "somatosensory")
    for objective in TEng.OBJECTIVES])
def test_criterion_value_and_grad_match_jax(objective, variant):
    """The total, every sub-loss (the mel loss is logged under ``"semvec"``
    although it is left out of the total) and the trajectory's gradient.
    The port's criterion runs the embedder only when the objective needs
    it, as JAX's ``plan_segment`` calls its criterion
    (``log_semantics=False``, the semantics logged after the segment).
    Under the somatosensory variant the tube embedder runs in train mode
    with the keep mask JAX draws from ``fold_in(rng, 1)``."""
    models, bundle, xx, tmel, tsem = _setup(seed=3)
    models, bundle = _variant(models, bundle, variant)
    rng = jax.random.PRNGKey(0)

    def loss_j(x):
        return JEng.criterion(bundle, x, jnp.asarray(tmel),
                              jnp.asarray(tsem), objective=objective,
                              use_speech_classifier=(
                                  variant == "speech_classifier"),
                              use_somatosensory=variant == "somatosensory",
                              log_semantics=False, rng=rng)

    (vj, (subs_j, *_)), gj = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(xx))
    masks = None
    if variant == "somatosensory":
        _, sub = jax.random.split(jax.random.fold_in(rng, 1))
        masks = [torch.tensor(np.asarray(jax.random.bernoulli(
            sub, 0.3, (1, xx.shape[1], 16))))]
    xt = torch.tensor(xx, requires_grad=True)
    vt, (subs_t, _mel, pred_semvec) = TEng.criterion(
        models, xt, torch.tensor(tmel), torch.tensor(tsem),
        objective=objective, tube_keep_masks=masks)
    vt.backward()
    np.testing.assert_allclose(vt.item(), float(vj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=ATOL)
    for field in TEng.SubLosses._fields:
        np.testing.assert_allclose(
            getattr(subs_t, field).item(), float(getattr(subs_j, field)),
            rtol=0, atol=ATOL, err_msg=field)
    assert subs_t.mel_loss.item() > 0
    assert (pred_semvec is None) == (objective == "acoustic")
    assert (subs_t.speech_classifier_loss.item() > 0) == (
        variant == "speech_classifier")
    assert (subs_t.tube_semvec_loss.item() > 0) == (
        variant == "somatosensory")
    if models.tube_embedder is not None:
        assert not models.tube_embedder.training


@pytest.mark.parametrize("cons", [
    {}, {"smiling": True}, {"past_len": 3}, {"clamp": 0.5, "smiling": True}])
def test_constraints_match_jax(cons):
    rng = np.random.default_rng(4)
    xx = rng.normal(size=(1, 8, 30)) * 1.5
    init = rng.normal(size=(1, 8, 30))
    ref = JEng.apply_constraints(jnp.asarray(xx), jnp.asarray(init),
                                 JEng.Constraints(**cons))
    xt = torch.tensor(xx)
    TEng.apply_constraints(xt, torch.tensor(init), TEng.Constraints(**cons))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(ref))
