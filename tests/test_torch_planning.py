"""The port's planning engine against ``paule_tpu.planning.engine``: a
3-step segment from the same trajectory with the same (small, H=16) models
in float64 gives the same trajectory, sub-loss series, snapshots and
gradients under each objective; the constraint projections match."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paule_tpu.models import embedder as JE
from paule_tpu.models import forward as JF
from paule_tpu.planning import engine as JEng
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


@pytest.mark.parametrize("objective", TEng.OBJECTIVES)
def test_criterion_value_and_grad_match_jax(objective):
    """The total, every sub-loss (the mel loss is logged under ``"semvec"``
    although it is left out of the total) and the trajectory's gradient.
    The port's criterion runs the embedder only when the objective needs
    it, as JAX's ``plan_segment`` calls its criterion
    (``log_semantics=False``, the semantics logged after the segment)."""
    models, bundle, xx, tmel, tsem = _setup(seed=3)

    def loss_j(x):
        return JEng.criterion(bundle, x, jnp.asarray(tmel),
                              jnp.asarray(tsem), objective=objective,
                              use_speech_classifier=False,
                              use_somatosensory=False, log_semantics=False,
                              rng=jax.random.PRNGKey(0))

    (vj, (subs_j, *_)), gj = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(xx))
    xt = torch.tensor(xx, requires_grad=True)
    vt, (subs_t, _mel, pred_semvec) = TEng.criterion(
        models, xt, torch.tensor(tmel), torch.tensor(tsem),
        objective=objective)
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
