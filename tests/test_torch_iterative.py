"""``Paule.plan_iterative``, the chunked planner of long utterances, against
``paule_tpu.api.Paule.plan_iterative`` (float64 on the CPU, the release
weights): an acoustic target in chunks, the last one absorbing a short
tail, and semvec-only words, each conditioned on the last ``overlap`` cp
frames of the plan before it.  The words' target mels come from the mel
generator, whose noise the port is handed from the JAX instance
(``torch_parity.replay_noise``); their produced side is held through
``torch_parity.SmoothPlant``, as the semvec paths' are
(``tests/test_torch_semvec.py``)."""

import numpy as np
import pytest
import torch

from paule_tpu import synth as JS
from paule_tpu.api import Paule as JPaule
from paule_tpu.ops.normalize import inv_normalize_cp
from paule_tpu_torch.api import Paule
from paule_tpu_torch.planning.iterative import _chunks
from torch_parity import (CP_ATOL, LOSS_RTOL, PLANNED, SmoothPlant, compare,
                          record_noise, replay_noise, seeded_semvec)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KW = dict(n_outer=1, n_inner=2, log_ii=1, continue_learning=False)


def test_chunks_absorb_a_short_tail():
    """Chunks of ``chunk_size`` mel frames; a rest shorter than a quarter
    chunk joins the last chunk, a longer one is a chunk of its own."""
    assert _chunks(40, 19) == [(0, 19), (19, 40)]
    assert _chunks(40, 16) == [(0, 16), (16, 32), (32, 40)]
    assert _chunks(10, 64) == [(0, 10)]


def _plan_both(n_noises=None, init=None, **kw):
    """``plan_iterative(**kw)`` through a JAX and a port instance (seed 7,
    built with ``init``), the port given the generators' noise JAX drew."""
    init = init or {}
    jpaule = JPaule(seed=7, **init)
    noises = record_noise(jpaule)
    ref_cp, ref = jpaule.plan_iterative(**kw)
    if n_noises is not None:
        assert len(noises) == n_noises
    port = Paule(device="cpu", dtype=torch.float64, seed=7, **init)
    replay_noise(port, noises)
    try:
        out_cp, out = port.plan_iterative(**kw)
    finally:
        port.close()
    np.testing.assert_allclose(out_cp, ref_cp, rtol=0, atol=CP_ATOL)
    assert len(out) == len(ref)
    return out_cp, out, ref


def test_acoustic_chunks_match_jax():
    """~0.2 s of audio (41 mel frames) in chunks of 19 frames: two chunks,
    the second absorbing the last 3 frames; each chunk's plan and losses as
    JAX's, and the stitched plan twice the mel frames long."""
    rng = np.random.default_rng(0)
    cp = np.clip(rng.normal(0, 0.05, (41, 30)).cumsum(0) * 0.2, -1, 1)
    sig, sr = JS.speak(inv_normalize_cp(cp))
    target = (np.tile(sig, 2), sr)
    planned, out, ref = _plan_both(
        target_acoustic=target, chunk_size=19, overlap=4,
        objective="acoustic_semvec", initialize_from="semvec", **KW)
    assert [r.target_mel.shape[0] for r in out] == [19, 22 + 2]
    assert planned.shape == (2 * 41, 30)
    for a, b in zip(out, ref):
        compare(a, b, series=PLANNED + ("prod_loss_steps",
                                        "prod_semvec_loss_steps"),
                arrays=("initial_cp", "target_mel", "pred_mel", "prod_mel"))
    # the second chunk starts from the first one's last 4 cp frames
    np.testing.assert_array_equal(out[1].planned_cp[:4],
                                  out[0].planned_cp[-4:])


def test_semvec_only_words_match_jax():
    """Two words of 12 and 16 mel frames: each plans against the mel
    generator's target under ``"acoustic_semvec"``, the second conditioned
    on the first."""
    semvecs = np.stack([seeded_semvec(3), seeded_semvec(4)])
    planned, out, ref = _plan_both(
        n_noises=2, init={"plant": SmoothPlant()}, target_semvecs=semvecs,
        target_seq_lengths=[12, 16], overlap=4, **KW)
    assert planned.shape == (2 * (12 + 16), 30)
    assert out[1].target_mel.shape[0] == 16 + 2
    for a, b in zip(out, ref):
        compare(a, b, series=PLANNED + ("prod_loss_steps",),
                arrays=("initial_cp", "target_mel", "pred_mel"))
        np.testing.assert_allclose(a.pred_semvec_loss_steps,
                                   b.pred_semvec_loss_steps, rtol=LOSS_RTOL)


def test_bad_arguments_raise():
    port = Paule(device="cpu", dtype=torch.float64)
    try:
        with pytest.raises(ValueError, match="target_seq_lengths"):
            port.plan_iterative(target_semvecs=seeded_semvec(), overlap=4)
        with pytest.raises(ValueError, match="even"):
            port.plan_iterative(target_semvecs=seeded_semvec(), overlap=3)
        with pytest.raises(ValueError, match="not None"):
            port.plan_iterative()
    finally:
        port.close()
