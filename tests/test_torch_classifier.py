"""The speech-classifier variant of the port against the JAX package
(float64 on the CPU): ``bce_with_logits``, ``LinearClassifier`` with and
without ``src_lens``, its converter, and
``Paule(use_speech_classifier=True).plan_resynth`` with the release
weights, without and with continue-learning."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paule_tpu import synth as JS
from paule_tpu.models import classifier as JC
from paule_tpu.models import torch_convert as JTC
from paule_tpu.ops import losses as JL
from paule_tpu.ops.normalize import inv_normalize_cp
from paule_tpu_torch.models import torch_convert as TTC
from paule_tpu_torch.models.classifier import LinearClassifier
from paule_tpu_torch.ops import losses as TL
from paule_tpu_torch.release import load_into
from torch_parity import SERIES, compare, plan_both
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-12
SC = {"use_speech_classifier": True}
SC_SERIES = ("pred_speech_classifier_loss_steps",
             "prod_speech_classifier_loss_steps")


@pytest.mark.parametrize("targets", ["zeros", "ones", "mixed"])
def test_bce_with_logits_matches_jax(targets):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 7)) * 3
    z = {"zeros": np.zeros_like(logits), "ones": np.ones_like(logits),
         "mixed": (rng.random(logits.shape) > 0.5).astype(float)}[targets]
    ref = JL.bce_with_logits(jnp.asarray(logits), jnp.asarray(z))
    ref_g = jax.grad(lambda x: JL.bce_with_logits(x, jnp.asarray(z)))(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    out = TL.bce_with_logits(x, torch.tensor(z))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), rtol=0,
                               atol=ATOL)
    rows = TL.bce_with_logits(torch.tensor(logits), torch.tensor(z), dim=1)
    for i in range(logits.shape[0]):
        np.testing.assert_allclose(
            rows[i].item(), float(JL.bce_with_logits(
                jnp.asarray(logits[i]), jnp.asarray(z[i]))), rtol=0,
            atol=ATOL)


@pytest.mark.parametrize("src_lens", [None, [5, 9, 1]])
def test_linear_classifier_matches_jax(src_lens):
    jc = JC.LinearClassifier(input_dim=60, output_dim=1)
    params = jc.init(jax.random.PRNGKey(3), jnp.float64)
    x = np.random.default_rng(1).normal(size=(3, 9, 60))
    ref = jc.apply(params, jnp.asarray(x), src_lens=src_lens)
    model = load_into(LinearClassifier(), jax.tree.map(np.asarray, params),
                      device="cpu", dtype=torch.float64)
    out = model(torch.tensor(x), src_lens=src_lens)
    assert out.shape == (3,)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=ATOL)


def test_convert_linear_classifier_matches_jax():
    rng = np.random.default_rng(2)
    sd = {"linear.weight": torch.tensor(rng.normal(size=(1, 60))),
          "linear.bias": torch.tensor(rng.normal(size=(1,)))}
    got = TTC.convert("linear_classifier", sd)
    want = JTC.convert("linear_classifier", sd)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def target():
    """~0.1 s of audio from a seeded smooth cp trajectory (as
    tests/test_torch_slice.py)."""
    rng = np.random.default_rng(0)
    cp = np.clip(rng.normal(0, 0.05, (41, 30)).cumsum(0) * 0.2, -1, 1)
    return JS.speak(inv_normalize_cp(cp))


@pytest.mark.parametrize("objective,continue_learning", [
    ("acoustic_semvec", False), ("semvec", False), ("acoustic", True)])
def test_plan_resynth_matches_jax(target, objective, continue_learning):
    kw = dict(target_acoustic=target, initialize_from="acoustic",
              objective=objective, n_outer=2 if continue_learning else 1,
              n_inner=3, log_ii=1, continue_learning=continue_learning,
              continue_learning_inv=continue_learning, n_batches=1,
              batch_size=2, n_epochs=2, verbose=False)
    out, ref, port, _noises = plan_both(kw, SC, SC)
    assert type(out).__name__ == type(ref).__name__ == (
        "PlanningResultsWithSpeechClassifier")
    compare(out, ref, series=SERIES + SC_SERIES)
    assert len(out.prod_speech_classifier_loss_steps) == (
        3 * (2 if continue_learning else 1))
    assert not any(p.requires_grad
                   for p in port.speech_classifier.parameters())
