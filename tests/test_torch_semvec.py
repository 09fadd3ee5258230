"""The semvec paths and the rest of the facade: the port's
``Paule.plan_resynth`` against ``paule_tpu.api.Paule.plan_resynth`` with the
same release weights, float64 on the CPU on both sides.

JAX draws the generators' noise from ``jax.random``, which the port cannot
reproduce: each test records the noise the JAX instance's generators are
given and hands it to the port through ``Paule._noise``.

The cp generator's trajectories drive the articulatory synthesizer into a
regime where its audio is not continuous in the cp: the trajectory it
makes here gives audio with a peak of 60, and multiplying any one of its 30
parameters by 1 + 1e-12 moves the audio by 0.27-0.45 (the port's
synthesizer, which is bit-identical to the JAX package's).  The two
packages' generators differ by 1e-14, so what is computed from the
produced audio (the produced losses, and the models continue-learning
trains on it) differs by up to 1e-3 relative.  The semvec paths are
therefore held against JAX twice: through ``torch_parity.SmoothPlant``, a
stand-in synthesizer that is smooth in the cp, everything at the slice's
tolerances; through the real synthesizer, the planning side."""

import numpy as np
import pytest
import torch

from paule_tpu import synth as JS
from paule_tpu.api import Paule as JPaule
from paule_tpu.ops.normalize import inv_normalize_cp
from paule_tpu_torch import synth as TS
from paule_tpu_torch.api import Paule
from torch_parity import (CP_ATOL, PLANNED, SIG_RTOL_PEAK, SmoothPlant,
                          compare, plan_both, seeded_semvec)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def target():
    """~0.1 s of audio from a seeded smooth cp trajectory."""
    rng = np.random.default_rng(0)
    cp = np.clip(rng.normal(0, 0.05, (41, 30)).cumsum(0) * 0.2, -1, 1)
    return JS.speak(inv_normalize_cp(cp))


@pytest.mark.parametrize("continue_learning", [False, True])
def test_semvec_only_target_matches_jax(continue_learning):
    """``target_acoustic=None``: the mel generator makes the target mel,
    Griffin-Lim its signal, the cp generator the initial trajectory, and
    planning follows the semvec objective."""
    kw = dict(target_acoustic=None, target_semvec=seeded_semvec(),
              target_seq_length=21, initialize_from="semvec",
              objective="semvec", n_outer=2 if continue_learning else 1,
              n_inner=3, log_ii=1, continue_learning=continue_learning,
              continue_learning_inv=continue_learning, n_batches=1,
              batch_size=2, n_epochs=2, verbose=False)
    plant = {"plant": SmoothPlant()}
    out, ref, _port, _noises = plan_both(kw, plant, plant, n_noises=2)
    compare(out, ref)
    assert out.planned_cp.shape == (42, 30)
    assert out.target_sr == ref.target_sr == 44100
    assert len(out.target_sig) == len(ref.target_sig) == 220 * 21 - 110
    np.testing.assert_allclose(
        out.target_sig, ref.target_sig, rtol=0,
        atol=SIG_RTOL_PEAK * np.abs(ref.target_sig).max())
    assert len(out.pred_model_loss) == (4 if continue_learning else 0)


@pytest.mark.parametrize("objective,initialize_from",
                         [("semvec", "acoustic"), ("acoustic", "semvec")])
def test_semvec_options_on_an_acoustic_target_match_jax(
        target, objective, initialize_from):
    kw = dict(target_acoustic=target, initialize_from=initialize_from,
              objective=objective, n_outer=2, n_inner=3, log_ii=1,
              continue_learning=True, n_batches=1, batch_size=2, n_epochs=1,
              verbose=False)
    plant = {"plant": SmoothPlant()}
    out, ref, _port, _noises = plan_both(
        kw, plant, plant, n_noises=int(initialize_from == "semvec"))
    compare(out, ref)
    np.testing.assert_array_equal(out.target_sig, ref.target_sig)


def test_semvec_planning_with_the_synthesizer_matches_jax():
    """The default synthesizer: the semvec-only plan itself, the target
    and the initial baseline match; the produced series are only as close
    as the synthesizer's discontinuity allows (module docstring)."""
    kw = dict(target_acoustic=None, target_semvec=seeded_semvec(),
              target_seq_length=21, initialize_from="semvec",
              objective="semvec", n_outer=1, n_inner=3, log_ii=1,
              continue_learning=False, verbose=False)
    out, ref, _port, _noises = plan_both(kw, n_noises=2)
    compare(out, ref, series=PLANNED,
             arrays=("initial_cp", "target_mel", "pred_mel",
                     "initial_pred_semvec", "pred_semvec"))
    np.testing.assert_allclose(out.initial_sig, ref.initial_sig, rtol=0,
                               atol=CP_ATOL)
    for key in ("prod_loss_steps", "prod_semvec_loss_steps"):
        assert len(getattr(out, key)) == len(getattr(ref, key)) == 3
        assert np.isfinite(getattr(out, key)).all()


def test_semvec_target_needs_its_length(target):
    port = Paule(device="cpu", dtype=torch.float64)
    try:
        for kw in ({"target_semvec": seeded_semvec()},
                   {"target_seq_length": 21}):
            with pytest.raises(ValueError, match="target_seq_length|"
                               "target_semvec"):
                port.plan_resynth(target_acoustic=None, n_outer=1,
                                  n_inner=1, verbose=False, **kw)
    finally:
        port.close()


def test_smiling_matches_jax(target):
    kw = dict(target_acoustic=target, objective="acoustic_semvec",
              n_outer=1, n_inner=3, log_ii=1, continue_learning=False,
              verbose=False)
    out, ref, _port, _noises = plan_both(kw, jax_init={"smiling": True},
                                          port_init={"smiling": True})
    compare(out, ref)
    np.testing.assert_array_equal(out.planned_cp[:, 4], -1.0)
    np.testing.assert_array_equal(out.planned_cp[:, 1], 1.0)


class FlakyPlant:
    """A synthesizer whose first batch reports snapshot 1 as failed."""

    def __init__(self, pool):
        self.pool = pool
        self.batches = 0

    def speak(self, cp):
        return self.pool.speak(cp)

    def speak_batch(self, cps):
        audio, sr, errors = self.pool.speak_batch(cps)
        errors = errors.copy()
        if self.batches == 0:
            errors[1] = 3
        self.batches += 1
        return audio, sr, errors


class SpeakOnlyPlant:
    """A synthesizer with ``speak`` only: planning calls it per
    trajectory."""

    def __init__(self, speak):
        self.speak = speak


def test_synthesis_error_skip_matches_jax(target, capsys):
    """A failed snapshot becomes silence on both sides, which the produced
    losses and continue-learning then see; ``"raise"`` raises."""
    kw = dict(target_acoustic=target, objective="acoustic", n_outer=2,
              n_inner=3, log_ii=1, continue_learning=True,
              continue_learning_inv=True, n_batches=1, batch_size=2,
              n_epochs=1, verbose=False)
    jpool, pool = JS.SynthPool(size=2), TS.SynthPool(size=2)
    try:
        # one batch per outer iteration on the JAX side too
        out, ref, _port, _noises = plan_both(
            kw, jax_init={"synthesis_error": "skip", "plan_overlap": False,
                          "plant": FlakyPlant(jpool)},
            port_init={"synthesis_error": "skip", "plant": FlakyPlant(pool)})
        assert "snapshot 1 failed" in capsys.readouterr().out
        compare(out, ref)
        port = Paule(device="cpu", dtype=torch.float64,
                     plant=FlakyPlant(pool))
        try:
            with pytest.raises(ValueError, match="snapshot 1 failed"):
                port.plan_resynth(**kw)
        finally:
            port.close()
    finally:
        jpool.close()
        pool.close()
    with pytest.raises(ValueError, match="synthesis_error"):
        Paule(device="cpu", synthesis_error="ignore")


def test_speak_only_plant_matches_jax(target):
    kw = dict(target_acoustic=target, objective="acoustic_semvec",
              n_outer=1, n_inner=4, log_ii=2, continue_learning=False,
              verbose=False)
    out, ref, _port, _noises = plan_both(
        kw, jax_init={"plant": SpeakOnlyPlant(JS.speak)},
        port_init={"plant": SpeakOnlyPlant(TS.speak)})
    compare(out, ref)
    np.testing.assert_array_equal(out.prod_mel, ref.prod_mel)


def test_create_epoch_batches_matches_jax():
    lengths = {3: [0, 4, 5], 7: [1, 2, 6, 7, 8], 9: [3]}
    jpaule, port = JPaule(seed=11), Paule(device="cpu", seed=11)
    try:
        for kw in ({"shuffle": True}, {"shuffle": False},
                   {"same_size_batching": True,
                    "training_length_dict": lengths}):
            for _ in range(2):
                ref = jpaule.create_epoch_batches(9, 2, **kw)
                assert port.create_epoch_batches(9, 2, **kw) == [
                    [int(i) for i in batch] for batch in ref], kw
    finally:
        port.close()
