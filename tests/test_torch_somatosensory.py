"""The somatosensory variant of the port against the JAX package (float64
on the CPU, the release weights): the tube normalisation, tube extraction
bit for bit, the synthesis of a failed snapshot, and
``Paule(use_somatosensory_feedback=True).plan_resynth`` without and with
``continue_learning_tube``.

For the whole plan the tube embedder's dropout is set to 0 on both sides
right after construction (the JAX package reads it when it traces); the
dropout path itself is held with JAX's keep mask handed to the port
(``tests/test_torch_lstm.py``, ``tests/test_torch_planning.py``)."""

import threading

import numpy as np
import pandas as pd
import pytest
import torch

from paule_tpu import synth as JS
from paule_tpu.api import Paule as JPaule
from paule_tpu.ops import normalize as JN
from paule_tpu.ops.normalize import inv_normalize_cp
from paule_tpu_torch import synth as TS
from paule_tpu_torch.api import Paule
from paule_tpu_torch.ops import normalize as TN
from torch_parity import CP_ATOL, LOSS_RTOL, SERIES, compare
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SOMATO = {"use_somatosensory_feedback": True}
#: the variant's loss series (beside torch_parity.SERIES)
TUBE_SERIES = ("prod_tube_loss_steps", "pred_tube_mel_loss_steps",
               "prod_tube_mel_loss_steps", "pred_tube_semvec_loss_steps",
               "prod_tube_semvec_loss_steps", "tube_model_loss",
               "tube_mel_model_loss")
#: the variant's arrays, held to CP_ATOL
TUBE_ARRAYS = ("initial_prod_tube", "initial_pred_tube",
               "initial_prod_tube_mel", "initial_pred_tube_mel", "prod_tube",
               "pred_tube", "prod_tube_mel", "pred_tube_mel",
               "initial_prod_tube_semvec", "initial_pred_tube_semvec",
               "prod_tube_semvec", "pred_tube_semvec")
TUBE_STEPS = ("prod_tube_steps", "pred_tube_steps", "prod_tube_mel_steps",
              "pred_tube_mel_steps", "prod_tube_semvec_steps",
              "pred_tube_semvec_steps")


def _cps(n_frames, seed):
    rng = np.random.default_rng(seed)
    return inv_normalize_cp(np.clip(
        rng.normal(0, 0.05, (n_frames, 30)).cumsum(0) * 0.2, -1, 1))


@pytest.fixture(scope="module")
def target():
    """~0.1 s of audio from a seeded smooth cp trajectory (as
    tests/test_torch_slice.py)."""
    rng = np.random.default_rng(0)
    cp = np.clip(rng.normal(0, 0.05, (41, 30)).cumsum(0) * 0.2, -1, 1)
    return JS.speak(inv_normalize_cp(cp))


def test_tube_tables_match_jax():
    for name in ("tube_mins", "tube_maxs", "tube_theoretical_means",
                 "tube_theoretical_stds"):
        np.testing.assert_array_equal(getattr(TN, name), getattr(JN, name))


@pytest.mark.parametrize("name", ["normalize_tube", "inv_normalize_tube"])
def test_normalize_tube_matches_jax(name):
    x = np.random.default_rng(1).normal(size=(7, 10)) * 5
    ref = getattr(JN, name)(x)
    np.testing.assert_allclose(getattr(TN, name)(x), ref, rtol=0,
                               atol=1e-12)
    out = getattr(TN, name)(torch.tensor(x))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)


def _assert_tube_infos_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_speak_and_extract_matches_jax_bit_for_bit():
    cp = _cps(30, 0)
    audio, sr, info = TS.speak_and_extract_tube_information(cp)
    ref, ref_sr, ref_info = JS.speak_and_extract_tube_information(cp)
    assert sr == ref_sr
    np.testing.assert_array_equal(audio, ref)
    _assert_tube_infos_equal(info, ref_info)
    assert info["tube_length_cm"].shape == (30, TS.N_TUBE_SECTIONS)
    assert set(np.unique(info["tube_articulator"])) <= set(
        TS.ARTICULATOR.values())
    # the batch path gives what the one-trajectory path gives
    np.testing.assert_array_equal(TS.speak(cp)[0], audio)


def test_speak_and_extract_batch_matches_jax_bit_for_bit():
    """Tube extraction of a batch with a non-finite row: the same audio,
    tubes and error codes as the JAX package's pool."""
    batch = np.stack([_cps(25, s) for s in range(3)])
    batch[1, 4, 7] = np.nan
    pool = TS.SynthPool(size=2)
    jpool = JS.SynthPool(size=2)
    try:
        audio, sr, errors, infos = pool.speak_and_extract_batch(batch)
        ref, ref_sr, ref_errors, ref_infos = jpool.speak_and_extract_batch(
            batch)
        one = pool.speak_and_extract_tube_information(batch[2])
    finally:
        pool.close()
        jpool.close()
    assert sr == ref_sr
    np.testing.assert_array_equal(errors, ref_errors)
    assert list(errors) == [0, -1, 0]
    np.testing.assert_array_equal(audio[[0, 2]], ref[[0, 2]])
    for i in (0, 2):
        _assert_tube_infos_equal(infos[i], ref_infos[i])
    np.testing.assert_array_equal(one[0], ref[2])
    _assert_tube_infos_equal(one[2], ref_infos[2])


@pytest.mark.parametrize("calculate", ["min", "mean", "binary"])
def test_area_info_matches_jax(calculate):
    _audio, _sr, info = JS.speak_and_extract_tube_information(_cps(20, 3))
    args = (info["tube_length_cm"], info["tube_area_cm2"])
    np.testing.assert_array_equal(
        TS.get_area_info_within_oral_cavity(*args, calculate=calculate),
        JS.get_area_info_within_oral_cavity(*args, calculate=calculate))


def _plan_both(kw, init=None):
    """``plan_resynth(**kw)`` through the JAX package and the port (float64,
    CPU) under the somatosensory variant, the tube embedders' dropout set
    to 0.  -> (port results, JAX results, port, JAX instance)."""
    init = dict(SOMATO, **(init or {}))
    jpaule = JPaule(seed=7, **init)
    jpaule.tube_embedder.dropout = 0.0
    ref = jpaule.plan_resynth(**kw)
    port = Paule(device="cpu", dtype=torch.float64, seed=7, **init)
    port.tube_embedder.dropout = 0.0
    try:
        out = port.plan_resynth(**kw)
    finally:
        port.close()
    return out, ref, port, jpaule


def _compare_somato(out, ref):
    assert type(out).__name__ == type(ref).__name__ == (
        "PlanningResultsWithSomatosensory")
    compare(out, ref, series=SERIES + TUBE_SERIES)
    for key in TUBE_ARRAYS:
        np.testing.assert_allclose(getattr(out, key), getattr(ref, key),
                                   rtol=0, atol=CP_ATOL, err_msg=key)
    for key in TUBE_STEPS:
        a, b = getattr(out, key), getattr(ref, key)
        assert [len(x) for x in a] == [len(x) for x in b], key
        for x, y in zip(a, b):
            if len(y):
                np.testing.assert_allclose(np.stack(x), np.stack(y), rtol=0,
                                           atol=CP_ATOL, err_msg=key)


def _compare_best(port, jpaule):
    a = port.best_synthesis_somatosensory
    b = jpaule.best_synthesis_somatosensory
    for key in ("tube_loss", "tube_mel_loss", "tube_semvec_loss"):
        np.testing.assert_allclose(getattr(a, key), getattr(b, key),
                                   rtol=LOSS_RTOL, atol=0, err_msg=key)
    for key in ("planned_cp", "prod_sig", "prod_tube", "pred_tube",
                "prod_tube_mel", "pred_tube_mel", "prod_tube_semvec"):
        if getattr(b, key) is None:  # no semvec logged
            assert getattr(a, key) is None, key
            continue
        np.testing.assert_allclose(getattr(a, key), getattr(b, key), rtol=0,
                                   atol=CP_ATOL, err_msg=key)
    assert a.pred_tube_semvec is None and b.pred_tube_semvec is None


@pytest.mark.parametrize("objective,log_ii", [("acoustic_semvec", 1),
                                              ("acoustic", 2)])
def test_plan_resynth_matches_jax(target, objective, log_ii):
    kw = dict(target_acoustic=target, initialize_from="acoustic",
              objective=objective, n_outer=1, n_inner=2, log_ii=log_ii,
              log_semantics=objective != "acoustic", continue_learning=False,
              verbose=False)
    out, ref, port, jpaule = _plan_both(kw)
    _compare_somato(out, ref)
    _compare_best(port, jpaule)
    assert len(out.pred_tube_mel_loss_steps) == 2 // log_ii
    if objective == "acoustic":
        assert out.prod_tube_semvec_loss_steps == []
        assert port.best_synthesis_somatosensory.tube_semvec_loss == np.inf


def _replay_rows(n_rows, mel_frames, seed):
    """Replay rows with tubes, of another length than the produced ones,
    so that mixed batches are padded."""
    rng = np.random.default_rng(seed)

    def walk(channels):
        return np.clip(rng.normal(0, 0.05, (2 * mel_frames, channels))
                       .cumsum(0), -1, 1)

    return pd.DataFrame({
        "vector": [rng.normal(size=300) for _ in range(n_rows)],
        "cp_norm": [walk(30) for _ in range(n_rows)],
        "melspec_norm_synthesized": [rng.normal(0, 0.3, (mel_frames, 60))
                                     for _ in range(n_rows)],
        "tube_norm": [walk(10) for _ in range(n_rows)],
        "segment_data": [False] * n_rows})


@pytest.mark.parametrize("replay", [False, True])
def test_plan_resynth_continue_learning_tube_matches_jax(target, replay):
    """``continue_learning_tube``: the cp->tube and tube->mel models train
    on the predictive model's rows (half of them replay rows with their
    tubes, with ``replay``), their losses and the plan as JAX's."""
    kw = dict(target_acoustic=target, initialize_from="acoustic",
              objective="acoustic_semvec", n_outer=2, n_inner=4, log_ii=1,
              continue_learning=True, continue_learning_inv=True,
              continue_learning_tube=True, n_batches=1, batch_size=4,
              n_epochs=2, verbose=False)
    init = {}
    if replay:
        kw.update(add_training_data_pred=True, add_training_data_inv=True)
        init["continue_data"] = _replay_rows(3, 15, seed=5)
    out, ref, port, jpaule = _plan_both(kw, init)
    _compare_somato(out, ref)
    _compare_best(port, jpaule)
    for key in ("pred_model_loss", "tube_model_loss", "tube_mel_model_loss",
                "inv_model_loss"):
        assert len(getattr(out, key)) == 2 * 2, key
    assert port.tube_trainer.steps == port.tube_mel_trainer.steps == 2 * 2
    if replay:
        assert len(port.continue_data) == 3 + 2 * 4
        assert port.continue_data.data["tube_norm"][-1].shape == (42, 10)


class _FailingPlant:
    """Tube extraction through the port's pool, with row 1 of every batch
    failing."""

    def __init__(self):
        self.pool = TS.SynthPool(size=1)

    def speak_and_extract_tube_information(self, cp):
        return self.pool.speak_and_extract_tube_information(cp)

    def speak_and_extract_batch(self, cps):
        audio, sr, errors, infos = self.pool.speak_and_extract_batch(cps)
        errors[1] = 7
        return audio, sr, errors, infos


def test_failed_snapshot_becomes_silence_and_a_zero_tube():
    plant = _FailingPlant()
    port = Paule(device="cpu", dtype=torch.float64, plant=plant,
                 synthesis_error="skip", **SOMATO)
    snapshots = np.clip(np.random.default_rng(2).normal(
        0, 0.05, (3, 20, 30)).cumsum(1), -1, 1)
    try:
        sigs, sr, tubes = port._synthesize(snapshots)
        port.synthesis_error = "raise"
        with pytest.raises(ValueError, match="snapshot 1"):
            port._synthesize(snapshots)
    finally:
        port.close()
        plant.pool.close()
    assert sr == 44100 and sigs.shape == (3, 19 * 110)
    assert tubes.shape == (3, 20, 10)
    assert not sigs[1].any() and not tubes[1].any()
    for i in (0, 2):
        _audio, _sr, info = JS.speak_and_extract_tube_information(
            inv_normalize_cp(snapshots[i]))
        np.testing.assert_array_equal(sigs[i], _audio)
        assert np.isfinite(tubes[i]).all() and tubes[i].any()


class _SpeakOnlyPlant:
    """A plant without a batch entry: one call per trajectory, on the
    synthesizer's default instance (the JAX package calls it from several
    threads, hence the lock)."""

    def __init__(self):
        self.calls = 0
        self.lock = threading.Lock()

    def speak_and_extract_tube_information(self, cp):
        with self.lock:
            self.calls += 1
            return JS.speak_and_extract_tube_information(cp)

    def speak_batch(self, cps):
        raise AssertionError("the somatosensory variant needs tubes")


def test_plant_without_tube_batch_is_called_per_trajectory(target):
    """``_plant_has_batch`` follows the variant: a plant with
    ``speak_batch`` but no ``speak_and_extract_batch`` is driven one
    trajectory at a time, and plans as the JAX package plans with it."""
    kw = dict(target_acoustic=target, objective="acoustic_semvec",
              n_outer=1, n_inner=2, log_ii=1, continue_learning=False,
              verbose=False)
    plant = _SpeakOnlyPlant()
    out, ref, _port, _j = _plan_both(kw, {"plant": plant})
    # one initial and two logged syntheses per package
    assert plant.calls == 2 * 3
    _compare_somato(out, ref)
