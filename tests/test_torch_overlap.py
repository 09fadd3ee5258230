"""Synthesis overlapped with planning (``Paule(plan_overlap=...)``): the
port's chunked outer iteration, its synthesis on a host thread, the
non-blocking chunk fetches and the deferred metrics change no result.
With 1 (``False``), 2 and 3 chunks, and with an unlogged remainder
``n_inner % log_ii``, every series of the port's ``plan_resynth`` equals
the single-segment run's bit for bit, and JAX's ``plan_resynth`` (float64,
CPU) to 1e-6 (cp) and 1e-5 (losses); also with continue-learning,
``defer_metrics_fetch`` on and off, and under the somatosensory variant.
``engine.plan_segment(xx_start=)`` anchors the past frames of a chunk to
the iteration's start, as JAX's ``plan_segment_keys``."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paule_tpu import synth as JS
from paule_tpu.api import Paule as JPaule
from paule_tpu.ops.normalize import inv_normalize_cp
from paule_tpu.planning import engine as JEng
from paule_tpu_torch import synth as TS
from paule_tpu_torch.api import Paule, overlap_chunks
from paule_tpu_torch.planning import engine as TEng
from test_torch_planning import ATOL, _setup
from torch_parity import CP_ATOL, LOSS_RTOL, SERIES
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: the chunk settings held against one segment
CHUNKS = (2, 3)
SOMATO_SERIES = ("prod_tube_loss_steps", "pred_tube_mel_loss_steps",
                 "prod_tube_mel_loss_steps", "pred_tube_semvec_loss_steps",
                 "prod_tube_semvec_loss_steps", "tube_model_loss",
                 "tube_mel_model_loss")


@pytest.fixture(scope="module")
def target():
    """~0.1 s of audio from a seeded smooth cp trajectory."""
    rng = np.random.default_rng(0)
    cp = np.clip(rng.normal(0, 0.05, (41, 30)).cumsum(0) * 0.2, -1, 1)
    return JS.speak(inv_normalize_cp(cp))


def assert_bit_equal(a, b, where="results"):
    """``a`` and ``b`` (results, lists, arrays, numbers) equal bit for
    bit."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bit_equal(x, y, f"{where}[{i}]")
    elif a is None:
        assert b is None, where
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)


def assert_results_equal(a, b):
    for field in a._fields:
        assert_bit_equal(getattr(a, field), getattr(b, field), field)


def compare_to_jax(out, ref, series):
    np.testing.assert_allclose(out.planned_cp, ref.planned_cp, rtol=0,
                               atol=CP_ATOL)
    for key in series:
        assert len(getattr(out, key)) == len(getattr(ref, key)), key
        np.testing.assert_allclose(getattr(out, key), getattr(ref, key),
                                   rtol=LOSS_RTOL, atol=0, err_msg=key)


class ThreadPlant:
    """The port's synthesizer, recording the thread and batch size of
    each batch call."""

    def __init__(self):
        self.pool = TS.SynthPool(size=2)
        self.calls = []

    def speak(self, cp):
        return self.pool.speak(cp)

    def speak_batch(self, cps):
        self.calls.append((threading.current_thread().name, len(cps)))
        return self.pool.speak_batch(cps)

    def close(self):
        self.pool.close()


def plan_port(kw, plan_overlap, init=None, setup=None):
    port = Paule(device="cpu", dtype=torch.float64, seed=7,
                 plan_overlap=plan_overlap, **(init or {}))
    if setup is not None:
        setup(port)
    try:
        return port.plan_resynth(**kw), port
    finally:
        port.close()


@pytest.mark.parametrize("n_chunks,n_inner,log_ii,bounds", [
    (2, 6, 2, [(0, 4), (4, 6)]), (3, 6, 2, [(0, 2), (2, 4), (4, 6)]),
    (2, 7, 2, [(0, 4), (4, 7)]), (3, 24, 1, [(0, 8), (8, 16), (16, 24)]),
    (3, 5, 1, [(0, 2), (2, 4), (4, 5)]), (2, 3, 2, [(0, 3)]),
    (1, 6, 1, [(0, 6)])])
def test_chunks_are_log_ii_aligned(n_chunks, n_inner, log_ii, bounds):
    """The chunks of ``paule_tpu/api.py:1004-1020``: whole logging
    segments, the remainder in the last; one chunk for one logged step."""
    assert overlap_chunks(n_inner, log_ii, n_chunks) == bounds


@pytest.mark.parametrize("n_inner,log_ii", [(6, 2), (7, 2)])
def test_overlap_equals_one_segment_and_jax(target, n_inner, log_ii):
    """The plan and every series (planned, produced, semantic, snapshots,
    mels, signals) equal the single segment's bit for bit with 2 and 3
    chunks, also with an unlogged remainder (7 % 2), and JAX's."""
    kw = dict(target_acoustic=target, objective="acoustic", n_outer=1,
              n_inner=n_inner, log_ii=log_ii, log_semantics=True,
              log_cps=True, log_signals=True, continue_learning=False,
              verbose=False)
    one, _ = plan_port(kw, False)
    assert len(one.planned_loss_steps) == n_inner // log_ii
    for n_chunks in CHUNKS:
        assert_results_equal(plan_port(kw, n_chunks)[0], one)
    ref = JPaule(seed=7).plan_resynth(**kw)
    compare_to_jax(one, ref, SERIES)


@pytest.mark.parametrize("defer", [True, False])
def test_overlap_with_continue_learning(target, defer):
    """Continue-learning of both models, the metrics fetched after the next
    iteration's planning (``defer_metrics_fetch``) or at once: every series
    and the replay buffer equal the single segment's bit for bit, and JAX's
    to 1e-6 / 1e-5; the chunks synthesise on the executor's thread, one
    batch per chunk."""
    kw = dict(target_acoustic=target, objective="acoustic_semvec",
              initialize_from="acoustic", n_outer=2, n_inner=4, log_ii=1,
              continue_learning=True, continue_learning_inv=True,
              n_batches=1, batch_size=2, n_epochs=1, verbose=False)

    def setup(port):
        port.defer_metrics_fetch = defer

    init = {"continue_data": {"cp_norm": []}}
    one, p1 = plan_port(kw, False, init, setup)
    plant = ThreadPlant()
    try:
        for n_chunks in CHUNKS:
            plant.calls.clear()
            out, port = plan_port(kw, n_chunks, dict(init, plant=plant),
                                  setup)
            assert_results_equal(out, one)
            assert_bit_equal(port.continue_data.data["cp_norm"],
                             p1.continue_data.data["cp_norm"])
            assert port._py_rng.getstate() == p1._py_rng.getstate()
            assert [n for _t, n in plant.calls] == [
                c1 - c0 for c0, c1 in overlap_chunks(4, 1, n_chunks)] * 2
            assert {t for t, _n in plant.calls} == {"paule-synthesis_0"}
    finally:
        plant.close()
    ref = JPaule(seed=7).plan_resynth(**kw)
    compare_to_jax(one, ref, SERIES)


def test_overlap_under_the_somatosensory_variant(target):
    """Tube extraction on the synthesis thread: with the tube embedder's
    dropout 0 on both sides every series equals the single segment's bit
    for bit and JAX's; with its dropout 0.7 (masks drawn from
    ``Paule.tube_generator`` while planning) the chunks draw the masks in
    the single segment's order, so the results are bit-equal too."""
    kw = dict(target_acoustic=target, objective="acoustic_semvec",
              n_outer=2, n_inner=3, log_ii=1, continue_learning=True,
              continue_learning_tube=True, n_batches=1, batch_size=2,
              n_epochs=1, verbose=False)
    init = {"use_somatosensory_feedback": True}

    def no_dropout(port):
        port.tube_embedder.dropout = 0.0

    one, _ = plan_port(kw, False, init, no_dropout)
    for n_chunks in CHUNKS:
        assert_results_equal(plan_port(kw, n_chunks, init, no_dropout)[0],
                             one)
    jpaule = JPaule(seed=7, **init)
    jpaule.tube_embedder.dropout = 0.0
    compare_to_jax(one, jpaule.plan_resynth(**kw), SERIES + SOMATO_SERIES)
    drop = plan_port(dict(kw, continue_learning=False), False, init)[0]
    for n_chunks in CHUNKS:
        assert_results_equal(plan_port(dict(kw, continue_learning=False),
                                       n_chunks, init)[0], drop)


def test_plan_segment_xx_start_across_a_chunk_boundary():
    """Two chunks of 2 and 3 steps with ``past_len=4`` and ``xx_start`` the
    trajectory before the first: the trajectory and the logs equal one
    5-step segment's bit for bit, and JAX's ``plan_segment_keys`` chunks
    to 1e-8."""
    models, bundle, xx, tmel, tsem = _setup()
    lr, cons = 0.01, TEng.Constraints(past_len=4)
    kw = dict(objective="acoustic_semvec", log_semantics=False,
              constraints=cons)
    x1 = torch.tensor(xx, requires_grad=True)
    one = TEng.plan_segment(models, x1, TEng.make_optimizer(x1, lr),
                            torch.tensor(tmel), torch.tensor(tsem),
                            n_steps=5, **kw)
    x2 = torch.tensor(xx, requires_grad=True)
    opt, start = TEng.make_optimizer(x2, lr), x2.detach().clone()
    chunks = [TEng.plan_segment(models, x2, opt, torch.tensor(tmel),
                                torch.tensor(tsem), n_steps=n,
                                xx_start=start, **kw) for n in (2, 3)]
    assert torch.equal(x1, x2)
    np.testing.assert_array_equal(x2.detach().numpy()[:, :4], xx[:, :4])
    for key in ("xx_pre", "pred_mel", "grads"):
        assert torch.equal(one[key], torch.cat([c[key] for c in chunks]))

    dyn, static = JEng.split_bundle(bundle)
    jcons = JEng.Constraints(past_len=4)
    jx = jnp.asarray(xx)
    state = JEng.init_opt_state(jx, lr)
    rngs = jax.random.split(jax.random.PRNGKey(0), 5)
    pre = []
    for c0, c1 in ((0, 2), (2, 5)):
        jx, state, logs = JEng.plan_segment_keys(
            dyn, static, jx, state, jnp.asarray(xx), jnp.asarray(tmel),
            jnp.asarray(tsem), rngs[c0:c1], objective="acoustic_semvec",
            use_speech_classifier=False, use_somatosensory=False,
            log_semantics=False, constraints=jcons, lr=lr)
        pre.append(np.asarray(logs["xx_pre"]))
    np.testing.assert_allclose(x2.detach().numpy(), np.asarray(jx), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(one["xx_pre"].numpy(), np.concatenate(pre),
                               rtol=0, atol=ATOL)
