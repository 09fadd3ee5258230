"""The slice as a whole: the port's ``Paule.plan_resynth`` against
``paule_tpu.api.Paule.plan_resynth`` with the same release weights on a
short synthesised target (float64 on the CPU on both sides), without and
with continue-learning, and the guards of the port's boundaries."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from paule_tpu import synth as JS
from paule_tpu.api import Paule as JPaule
from paule_tpu.ops.normalize import inv_normalize_cp
from paule_tpu_torch.api import Paule
from paule_tpu_torch.dsp.audio import read, write
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def target():
    """~0.1 s of audio from a seeded smooth cp trajectory."""
    rng = np.random.default_rng(0)
    cp = np.clip(rng.normal(0, 0.05, (41, 30)).cumsum(0) * 0.2, -1, 1)
    return JS.speak(inv_normalize_cp(cp))


@pytest.mark.parametrize("objective,log_ii", [("acoustic_semvec", 1),
                                              ("acoustic", 2)])
def test_plan_resynth_matches_jax(target, objective, log_ii):
    kw = dict(target_acoustic=target, initialize_from="acoustic",
              objective=objective, n_outer=1, n_inner=2, log_ii=log_ii,
              continue_learning=False, verbose=False)
    ref = JPaule(seed=7).plan_resynth(**kw)
    port = Paule(device="cpu", dtype=torch.float64, seed=7)
    try:
        out = port.plan_resynth(**kw)
    finally:
        port.close()

    np.testing.assert_allclose(out.planned_cp, ref.planned_cp, rtol=0,
                               atol=1e-6)
    for key in ("planned_loss_steps", "prod_loss_steps",
                "prod_semvec_loss_steps", "pred_semvec_loss_steps",
                "planned_mel_loss_steps"):
        np.testing.assert_allclose(getattr(out, key), getattr(ref, key),
                                   rtol=1e-5, atol=0, err_msg=key)
    for key in ("initial_cp", "target_mel", "prod_mel", "pred_mel",
                "initial_pred_semvec", "prod_semvec", "pred_semvec"):
        np.testing.assert_allclose(getattr(out, key), getattr(ref, key),
                                   rtol=0, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(out.initial_sig, ref.initial_sig)
    assert len(out.prod_mel_steps) == len(ref.prod_mel_steps) == 1


def _replay_rows(n_rows, mel_frames, seed):
    """Replay-buffer rows of another length than the produced ones, so that
    mixed batches are padded."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "vector": [rng.normal(size=300) for _ in range(n_rows)],
        "cp_norm": [np.clip(rng.normal(0, 0.05, (2 * mel_frames, 30))
                            .cumsum(0), -1, 1) for _ in range(n_rows)],
        "melspec_norm_synthesized": [rng.normal(0, 0.3, (mel_frames, 60))
                                     for _ in range(n_rows)],
        "tube_norm": [None] * n_rows, "segment_data": [False] * n_rows})


@pytest.mark.parametrize("case", ["produced", "replay", "past_cp"])
def test_plan_resynth_continue_learning_matches_jax(target, case):
    kw = dict(target_acoustic=target, initialize_from="acoustic",
              objective="acoustic_semvec", n_outer=2, n_inner=4, log_ii=1,
              continue_learning=True, continue_learning_inv=True,
              n_batches=1, batch_size=4, n_epochs=2, verbose=False)
    init = {}
    if case == "replay":
        kw.update(add_training_data_pred=True, add_training_data_inv=True)
        init["continue_data"] = _replay_rows(3, 15, seed=5)
    if case == "past_cp":
        kw["past_cp"] = np.clip(np.random.default_rng(6).normal(
            0, 0.05, (6, 30)).cumsum(0), -1, 1)
    ref = JPaule(seed=7, **init).plan_resynth(**kw)
    port = Paule(device="cpu", dtype=torch.float64, seed=7, **init)
    try:
        out = port.plan_resynth(**kw)
    finally:
        port.close()

    np.testing.assert_allclose(out.planned_cp, ref.planned_cp, rtol=0,
                               atol=1e-6)
    assert len(out.pred_model_loss) == len(out.inv_model_loss) == 4
    for key in ("planned_loss_steps", "prod_loss_steps",
                "prod_semvec_loss_steps", "pred_model_loss",
                "inv_model_loss"):
        np.testing.assert_allclose(getattr(out, key), getattr(ref, key),
                                   rtol=1e-5, atol=0, err_msg=key)
    for key in ("initial_cp", "target_mel", "pred_mel"):
        np.testing.assert_allclose(getattr(out, key), getattr(ref, key),
                                   rtol=0, atol=1e-6, err_msg=key)
    if case == "replay":
        assert len(port.continue_data) == 3 + 2 * 4


def test_replay_rows_own_their_memory(target):
    """Every produced row that continue-learning keeps in the replay buffer
    owns its storage: a view would keep its outer iteration's whole batch
    of snapshots (or mels) alive, so the memory held would grow with the
    outer iterations instead of being bounded by the buffer's cap."""
    port = Paule(device="cpu", dtype=torch.float64, seed=7,
                 continue_data={"cp_norm": []})
    try:
        port.plan_resynth(target_acoustic=target, objective="acoustic",
                          n_outer=2, n_inner=2, log_ii=1,
                          continue_learning=True, n_batches=1, batch_size=2,
                          n_epochs=1, verbose=False)
    finally:
        port.close()
    for col in ("cp_norm", "melspec_norm_synthesized"):
        rows = port.continue_data.data[col]
        assert len(rows) == 2 * 2
        for row in rows:
            assert torch.is_tensor(row)
            assert row.untyped_storage().nbytes() == row.nbytes, col


def test_wav_path_target_matches_sig_sr(target, tmp_path):
    """A WAV path plans like the ``(sig, sr)`` it holds after the 16-bit
    round trip."""
    path = str(tmp_path / "target.wav")
    write(path, *target)
    sig, sr = read(path)
    port = Paule(device="cpu", dtype=torch.float64, seed=7)
    kw = dict(objective="acoustic", n_outer=1, n_inner=1,
              continue_learning=False, verbose=False)
    try:
        a = port.plan_resynth(target_acoustic=path, **kw)
        b = port.plan_resynth(target_acoustic=(sig, sr), **kw)
    finally:
        port.close()
    np.testing.assert_array_equal(a.target_mel, b.target_mel)
    np.testing.assert_allclose(a.planned_cp, b.planned_cp, rtol=0,
                               atol=1e-12)


def test_options_outside_the_slice_raise(target, monkeypatch):
    """Nothing raises for being outside the port: a mesh's ``tp`` axis
    makes a ``dp x tp`` mesh; ``mesh=`` of the batched planners
    takes a ``Mesh`` and raises ``TypeError`` for anything else.
    ``plot`` and ``physical_forward``, which raised naming item 12 until
    they were ported, now run: ``plot=True`` hands the mel panels to
    ``visualize.plot_mels`` to show."""
    from paule_tpu_torch import visualize
    from paule_tpu_torch.parallel.batched import plan_batch_resynth
    from paule_tpu_torch.parallel.mesh import make_mesh

    calls = []
    monkeypatch.setattr(visualize, "plot_mels",
                        lambda *args: calls.append(args))
    port = Paule(device="cpu", dtype=torch.float64)
    try:
        mesh = make_mesh(devices=["cpu"] * 4, dp=2, tp=2)
        assert mesh.shape == {"dp": 2, "tp": 2} and len(mesh.leads) == 2
        with pytest.raises(TypeError, match="Mesh"):
            plan_batch_resynth(port, np.zeros((1, 4, 60)), mesh=object())
        port.plan_resynth(target_acoustic=target, n_outer=1, n_inner=1,
                          continue_learning=False, plot=True, verbose=False)
    finally:
        port.close()
    assert len(calls) == 1 and calls[0][0] is True
    Paule(device="cpu", physical_forward=True).close()


def test_both_variants_together_raise():
    """The speech-classifier and somatosensory variants exclude each other,
    with the JAX package's message."""
    with pytest.raises(ValueError, match="either to use"):
        Paule(device="cpu", use_speech_classifier=True,
              use_somatosensory_feedback=True)


def test_paule_without_cuda_raises(monkeypatch):
    """The default device is the card; without one, Paule() raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Paule()


def test_import_leaves_no_jax():
    """The port imports neither JAX, optax, pandas nor any module of the
    JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import paule_tpu_torch\n"
        "for m in pkgutil.walk_packages(paule_tpu_torch.__path__, "
        "'paule_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'pandas', 'paule_tpu'))\n"
        "for name in ('api', 'checkpoint', 'models.generative', "
        "'models.torch_convert', 'dsp.griffinlim', 'models.classifier', "
        "'parallel.batched', 'planning.iterative', 'experiments', "
        "'serve', '__main__', 'pretrain', 'models.baselines', "
        "'tools.train_release_weights', 'spectral', 'visualize', 'util', "
        "'synth.speaker_import', 'synth.vtl_plant', 'dsp.formants', "
        "'parallel.mesh', 'reference_bridge', "
        "'tools.launch_overhead_probe', 'tools.synthesis_breakdown', "
        "'tools.bench_variants'):\n"
        "    assert 'paule_tpu_torch.' + name in sys.modules, name\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
