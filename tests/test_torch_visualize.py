"""The port's plots (``paule_tpu_torch/visualize.py``), ``plan_resynth(
plot=...)`` and the ``util`` facade, against the JAX package on the CPU.

``plot_mels`` is captured in both packages while the same short plan runs
(float64; the JAX instance's models are the port's): the same calls with
the same file names, and arrays within ``tests/torch_parity.py``'s
``CP_ATOL``.  The plot functions and ``visualize_results`` write their
files (matplotlib's Agg backend).  ``util`` offers the JAX facade's names,
each the port's own object, and its offline download returns ``None``."""

import os

import matplotlib
import numpy as np
import pytest
import torch

from paule_tpu import util as jutil
from paule_tpu import visualize as jvis
from paule_tpu.api import Paule as JPaule
from paule_tpu_torch import synth
from paule_tpu_torch import util
from paule_tpu_torch import visualize
from paule_tpu_torch.api import Paule
from paule_tpu_torch.ops.normalize import inv_normalize_cp
from torch_parity import CP_ATOL
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

matplotlib.use("Agg")


def _target(n_frames=16, seed=4):
    rng = np.random.default_rng(seed)
    cp = np.clip(rng.normal(0, 0.1, (n_frames, 30)).cumsum(0) * 0.1, -1, 1)
    return synth.speak(inv_normalize_cp(cp))


def _capture(module, monkeypatch):
    calls = []
    monkeypatch.setattr(module, "plot_mels",
                        lambda name, *mels: calls.append((name, mels)))
    return calls


@pytest.mark.parametrize("plot", ["prefix", True])
def test_plan_resynth_plot_hands_the_same_mels(plot, tmp_path, monkeypatch):
    """Two outer iterations, each logging two steps: one ``plot_mels``
    call each, with the target, the initial predicted and produced mels
    and the last logged step's predicted and produced mels."""
    prefix = str(tmp_path / "p") if plot == "prefix" else True
    kw = dict(target_acoustic=_target(), objective="acoustic",
              n_outer=2, n_inner=2, log_ii=1, continue_learning=False,
              plot=prefix, verbose=False)
    ref_calls = _capture(jvis, monkeypatch)
    JPaule(seed=7).plan_resynth(**kw)
    calls = _capture(visualize, monkeypatch)
    port = Paule(device="cpu", dtype=torch.float64, seed=7)
    try:
        port.plan_resynth(**kw)
    finally:
        port.close()
    assert len(calls) == len(ref_calls) == 2
    for (name, mels), (ref_name, ref_mels) in zip(calls, ref_calls):
        assert name == ref_name
        assert len(mels) == len(ref_mels) == 5
        for a, b in zip(mels, ref_mels):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=CP_ATOL)
    if plot == "prefix":
        assert [c[0] for c in calls] == [f"{prefix}_000.png",
                                         f"{prefix}_001.png"]


def test_plot_functions_write_their_files(tmp_path):
    rng = np.random.default_rng(0)
    mels = [rng.normal(size=(12, 60)) for _ in range(5)]
    visualize.plot_mels(str(tmp_path / "mels.png"), *mels)
    visualize.plot_cp(rng.normal(size=(20, 30)), str(tmp_path / "cp.png"))
    visualize.plot_mel(mels[0], str(tmp_path / "mel.png"))
    for name in ("mels.png", "cp.png", "mel.png"):
        assert (tmp_path / name).stat().st_size > 1000


def test_visualize_results_writes_every_file(tmp_path):
    """From a short plan's results, and again from their pickle file."""
    import pickle

    port = Paule(device="cpu", dtype=torch.float64, seed=7)
    try:
        res = port.plan_resynth(target_acoustic=_target(), n_outer=1,
                                n_inner=2, continue_learning=False,
                                objective="acoustic_semvec", verbose=False)
    finally:
        port.close()
    visualize.visualize_results(res, "word", str(tmp_path / "out"))
    files = set(os.listdir(tmp_path / "out"))
    for name in ("mel.png", "planned.wav", "initial.wav", "target.wav",
                 "loss.png", "loss_mel.png", "loss_subloss.png",
                 "loss_semvec.png", "cps.png"):
        assert f"word_{name}" in files, name
    assert os.listdir(tmp_path / "out" / "word_planned_svgs")
    with open(tmp_path / "res.pkl", "wb") as fh:
        pickle.dump(res, fh)
    visualize.visualize_results(str(tmp_path / "res.pkl"), "again",
                                str(tmp_path / "out"))
    assert "again_mel.png" in os.listdir(tmp_path / "out")


#: the reference's ``paule.util`` names (tests/test_util_compat.py) and
#: the rest of the JAX facade's
UTIL_NAMES = (
    "cp_means", "cp_stds", "cp_theoretical_means", "cp_theoretical_stds",
    "tube_mins", "tube_maxs", "tube_theoretical_means",
    "tube_theoretical_stds", "mel_mean_librosa", "mel_std_librosa",
    "ARTICULATOR", "normalize_cp", "inv_normalize_cp", "normalize_tube",
    "inv_normalize_tube", "normalize_mel_librosa",
    "inv_normalize_mel_librosa", "librosa_melspec", "mel_to_sig",
    "stereo_to_mono", "audio_padding", "add_and_pad", "pad_batch_online",
    "pad_same_to_even_seq_length", "half_seq_by_average_pooling",
    "array_to_tensor", "speak", "speak_and_extract_tube_information",
    "export_svgs", "cps_to_ema", "cps_to_ema_and_mesh", "seg_to_cps",
    "ges_to_cps", "read_cp", "get_area_info_within_oral_cavity",
    "calculate_five_point_stencil_without_padding", "numeric_derivative",
    "local_linear", "get_vel_acc_jerk", "rmse_loss", "cp_trajectory_loss",
    "download_pretrained_weights", "get_pretrained_weights_version",
    "plot_cp", "plot_mel", "velocity_jerk_loss", "RMSELoss", "min_area",
    "max_area", "min_length", "max_length", "min_incisor", "max_incisor",
    "min_tongue", "max_tongue", "min_velum", "max_velum", "pad_batch",
    "mel_mean", "mel_std", "normalize_mel", "inv_normalize_mel",
    "SPEAKER_FILE_NAME", "FAILURE", "PRETRAINED_DIR",
    "REFERENCE_WEIGHTS_URL")


@pytest.mark.parametrize("name", UTIL_NAMES)
def test_util_names_are_the_ports(name):
    assert hasattr(jutil, name)
    obj = getattr(util, name)
    if callable(obj) and not isinstance(obj, type):
        module = getattr(obj, "__module__", None) or type(obj).__module__
        assert module.startswith("paule_tpu_torch."), (name, module)
    elif isinstance(obj, np.ndarray):
        np.testing.assert_array_equal(obj, getattr(jutil, name))
    elif isinstance(obj, (int, float)):
        assert obj == getattr(jutil, name)


def test_util_numpy_helpers_match_jax():
    rng = np.random.default_rng(1)
    seqs = [rng.normal(size=(n, 4)) for n in (3, 6, 5)]
    for onset in (False, True):
        np.testing.assert_array_equal(
            util.pad_batch_online([3, 6, 5], seqs, with_onset_dim=onset),
            jutil.pad_batch_online([3, 6, 5], seqs, with_onset_dim=onset))
    np.testing.assert_array_equal(util.half_seq_by_average_pooling(seqs[0]),
                                  jutil.half_seq_by_average_pooling(seqs[0]))
    sig = rng.normal(size=100)
    np.testing.assert_array_equal(util.audio_padding(sig, 44100),
                                  jutil.audio_padding(sig, 44100))
    traj = rng.normal(size=(20, 3))
    np.testing.assert_allclose(util.numeric_derivative(traj),
                               jutil.numeric_derivative(traj), rtol=0,
                               atol=1e-12)
    t = util.array_to_tensor(traj)
    assert torch.is_tensor(t) and t.shape == (1, 20, 3)
    a, b = torch.tensor(traj), torch.zeros(20, 3, dtype=torch.float64)
    assert float(util.rmse_loss(a, b)) == pytest.approx(
        float(jutil.rmse_loss(traj, np.zeros((20, 3)))), rel=1e-12)


def test_util_lazy_library_and_offline_download(tmp_path, capsys):
    assert util.VERSION == synth.version()
    assert util.VTL is synth._lib
    assert os.path.exists(util.SPEAKER_FILE_NAME)
    assert "No version file" in util.get_pretrained_weights_version()
    # nothing reaches the network: a file URL that does not exist
    url = (tmp_path / "missing.zip").as_uri()
    assert util.download_pretrained_weights(url=url) is None
    assert "could not download" in capsys.readouterr().out
    assert not os.path.exists(util.PRETRAINED_DIR)
