"""Batched planning of the port against the JAX package (float64 on the
CPU): ``engine.criterion_batched`` (value, gradient and sub-losses under
each objective, plain and under both variants, with small models),
its rows against ``engine.criterion`` of each utterance, and
``parallel.batched.plan_batch`` / ``plan_batch_resynth`` with the release
weights on three utterances of 24 cp frames, without and with
continue-learning and under each variant.

For the whole plans the tube embedder's dropout is set to 0 on both sides
right after construction (the JAX package reads it when it traces); the
criterion holds the dropout path with JAX's keep mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paule_tpu import synth as JS
from paule_tpu.api import Paule as JPaule
from paule_tpu.dsp.targets import normalized_target_mel
from paule_tpu.ops.normalize import inv_normalize_cp
from paule_tpu.parallel import batched as JB
from paule_tpu.planning import engine as JEng
from paule_tpu_torch.api import Paule
from paule_tpu_torch.parallel import batched as TB
from paule_tpu_torch.parallel import mesh as TMesh
from paule_tpu_torch.planning import engine as TEng
from test_torch_planning import ATOL, _setup, _variant
from torch_parity import CP_ATOL, LOSS_RTOL
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B = 3


def _batch(seed=6, seq=16):
    """B trajectories and targets from a seed."""
    rng = np.random.default_rng(seed)
    xx = np.clip(rng.normal(0, 0.05, (B, seq, 30)).cumsum(1), -1, 1)
    return (xx, rng.normal(size=(B, seq // 2, 60)) * 0.3,
            rng.normal(size=(B, 300)) * 0.3)


def _masks(rng, shape):
    """The tube embedder's keep mask that JAX draws from ``fold_in(rng,
    1)`` (dropout 0.7 between its two H=16 layers)."""
    _, sub = jax.random.split(jax.random.fold_in(rng, 1))
    return [torch.tensor(np.asarray(jax.random.bernoulli(sub, 0.3, shape)))]


@pytest.mark.parametrize("objective,variant", [
    (objective, variant)
    for variant in ("plain", "speech_classifier", "somatosensory")
    for objective in TEng.OBJECTIVES])
def test_criterion_batched_value_and_grad_match_jax(objective, variant):
    """The per-utterance totals and sub-losses, the predicted semvecs
    (``log_semantics=True``: the embedder runs under every objective) and
    the gradient of the summed total."""
    models, bundle, *_ = _setup(seed=3)
    models, bundle = _variant(models, bundle, variant)
    xx, tmel, tsem = _batch()
    rng = jax.random.PRNGKey(0)

    def loss_j(x):
        total, aux = JEng.criterion_batched(
            bundle, x, jnp.asarray(tmel), jnp.asarray(tsem),
            objective=objective,
            use_speech_classifier=variant == "speech_classifier",
            use_somatosensory=variant == "somatosensory", log_semantics=True,
            rng=rng)
        return jnp.sum(total), (total, aux)

    (_, (tj, (subs_j, _pm, ps_j, _pt))), gj = jax.value_and_grad(
        loss_j, has_aux=True)(jnp.asarray(xx))
    masks = (_masks(rng, (B, xx.shape[1], 16)) if variant == "somatosensory"
             else None)
    xt = torch.tensor(xx, requires_grad=True)
    tt, (subs_t, _mel, ps_t) = TEng.criterion_batched(
        models, xt, torch.tensor(tmel), torch.tensor(tsem),
        objective=objective, log_semantics=True, tube_keep_masks=masks)
    tt.sum().backward()
    assert tt.shape == (B,)
    np.testing.assert_allclose(tt.detach().numpy(), np.asarray(tj), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=ATOL)
    for field in TEng.SubLosses._fields:
        np.testing.assert_allclose(
            getattr(subs_t, field).detach().numpy(),
            np.asarray(getattr(subs_j, field)), rtol=0, atol=ATOL,
            err_msg=field)
    np.testing.assert_allclose(ps_t.detach().numpy(), np.asarray(ps_j),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("objective", TEng.OBJECTIVES)
def test_criterion_batched_rows_equal_criterion(objective):
    """Row b of the batch, and its gradient, is ``criterion`` of utterance
    b alone: no reduction mixes two utterances."""
    models, bundle, *_ = _setup(seed=4)
    models, _bundle = _variant(models, bundle, "speech_classifier")
    xx, tmel, tsem = (torch.tensor(a) for a in _batch(8))
    xb = xx.clone().requires_grad_(True)
    total, (subs, _mel, _semvec) = TEng.criterion_batched(
        models, xb, tmel, tsem, objective=objective)
    total.sum().backward()
    for b in range(B):
        x1 = xx[b:b + 1].clone().requires_grad_(True)
        t1, (s1, _m, _s) = TEng.criterion(models, x1, tmel[b:b + 1],
                                          tsem[b:b + 1], objective=objective)
        t1.backward()
        torch.testing.assert_close(total[b], t1, rtol=1e-12, atol=0)
        for field in TEng.SubLosses._fields:
            torch.testing.assert_close(getattr(subs, field)[b],
                                       getattr(s1, field), rtol=1e-12,
                                       atol=0)
        torch.testing.assert_close(xb.grad[b], x1.grad[0], rtol=1e-10,
                                   atol=1e-14)


@pytest.fixture(scope="module")
def target_mels():
    """Normalised mels ``(B, 12, 60)`` of the audio of three seeded cp
    trajectories of 24 frames (the JAX package's target convention)."""
    rng = np.random.default_rng(3)
    mels = []
    for _ in range(B):
        cp = np.clip(rng.normal(0, 0.1, (24, 30)).cumsum(0) * 0.1, -1, 1)
        mels.append(normalized_target_mel(*JS.speak(inv_normalize_cp(cp))))
    return np.stack(mels)


def _both(init=None):
    """A JAX and a port instance (float64, CPU, seed 7) built with
    ``init``, the tube embedders' dropout at 0."""
    jpaule = JPaule(seed=7, **(init or {}))
    port = Paule(device="cpu", dtype=torch.float64, seed=7, **(init or {}))
    for p in (jpaule, port):
        if p.tube_embedder is not None:
            p.tube_embedder.dropout = 0.0
    return jpaule, port


def _compare_sub_losses(out, ref):
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        for field in TEng.SubLosses._fields:
            np.testing.assert_allclose(getattr(a, field),
                                       np.asarray(getattr(b, field)),
                                       rtol=LOSS_RTOL, atol=1e-12,
                                       err_msg=field)


def test_plan_batch_matches_jax(target_mels):
    jpaule, port = _both()
    kw = dict(n_steps=3, objective="acoustic_semvec", log_semantics=True)
    ref = JB.plan_batch(jpaule, target_mels, **kw)
    try:
        out = TB.plan_batch(port, target_mels, **kw)
    finally:
        port.close()
    np.testing.assert_allclose(out["planned_cp"], ref["planned_cp"], rtol=0,
                               atol=CP_ATOL)
    _compare_sub_losses([out["sub_losses"]], [ref["sub_losses"]])
    assert out["sub_losses"].total.shape == (3, B)
    for a, b in zip(out["prod_sigs"], ref["prod_sigs"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


#: case -> (Paule keywords, plan_batch_resynth keywords)
CASES = {
    "produced": ({}, dict(continue_learning=False)),
    "continue_learning": ({}, dict(continue_learning=True)),
    "speech_classifier": ({"use_speech_classifier": True},
                          dict(continue_learning=True)),
    "somatosensory": ({"use_somatosensory_feedback": True},
                      dict(continue_learning=True,
                           continue_learning_tube=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_batch_resynth_matches_jax(target_mels, case):
    """Two outer iterations of three steps: the plans, every produced
    curve, the planned sub-losses of every step, the produced audio and
    mels and the models' training losses (2 epochs of batches of 2 over
    the 3 utterances, the orders drawn from the instance's ``random``)."""
    init, extra = CASES[case]
    jpaule, port = _both(init)
    kw = dict(n_outer=2, n_inner=3, objective="acoustic_semvec",
              n_epochs=2, batch_size=2, **extra)
    ref = JB.plan_batch_resynth(jpaule, target_mels, **kw)
    try:
        out = TB.plan_batch_resynth(port, target_mels, **kw)
    finally:
        port.close()
    assert sorted(out) == sorted(ref)
    np.testing.assert_allclose(out["planned_cp"], ref["planned_cp"], rtol=0,
                               atol=CP_ATOL)
    for key in out:
        if key.endswith("_curve") or key.endswith("model_loss"):
            np.testing.assert_allclose(out[key], np.asarray(ref[key]),
                                       rtol=LOSS_RTOL, atol=0, err_msg=key)
    assert out["prod_loss_curve"].shape == (2, B)
    _compare_sub_losses(out["sub_losses"], ref["sub_losses"])
    np.testing.assert_allclose(out["prod_mels"], ref["prod_mels"], rtol=0,
                               atol=CP_ATOL)
    for a, b in zip(out["prod_sigs"], ref["prod_sigs"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    n_steps = 2 * 2 * 2 if extra["continue_learning"] else 0
    assert len(out["pred_model_loss"]) == n_steps
    assert port.pred_trainer.steps == n_steps
    if case == "somatosensory":
        np.testing.assert_allclose(out["prod_tubes"], ref["prod_tubes"],
                                   rtol=0, atol=CP_ATOL)
        assert len(out["tube_model_loss"]) == n_steps
    assert set(port.last_planning_timings) == {
        "planning", "synthesis", "metrics", "continue_learning",
        "continue_learning_tube"}


def test_a_mesh_raises(target_mels):
    """``mesh=`` takes a ``parallel.mesh.Mesh``: another object raises
    ``TypeError``; a mesh with ``tp > 1`` is made, and a ``tp`` that does
    not divide the models' gate axes (4H) raises ``ValueError`` when the
    planner splits them."""
    port = Paule(device="cpu", dtype=torch.float64)
    try:
        for fn in (TB.plan_batch, TB.plan_batch_resynth):
            with pytest.raises(TypeError, match="Mesh"):
                fn(port, target_mels, mesh=object())
        mesh = TMesh.make_mesh(devices=["cpu"] * 7, dp=1, tp=7)
        assert mesh.shape == {"dp": 1, "tp": 7}
        with pytest.raises(ValueError, match="tp=7"):
            TB.plan_batch(port, target_mels, mesh=mesh, n_steps=1,
                          synthesize=False)
    finally:
        port.close()
