"""The port's reference bridge (``paule_tpu_torch.reference_bridge``)
against ``paule_tpu.reference_bridge``: each librosa stand-in on the same
float64 input as the JAX package's, the port's built from its own DSP
modules with no ``transformers``; ``reference_hidden`` shared with
``synth.vtl_plant``; no installed package shadowed; no JAX imported.

The JAX stand-in's ``melspectrogram`` runs ``transformers``' numpy STFT,
whose FFT is complex64, so the port's amplitude mel is held to it at
1e-6 relative to the peak (float32 resolution) and, at 1e-9, to a float64
STFT through the JAX package's own window and filterbank.  The JAX
stand-in's ``mel_to_audio`` imports a name its Griffin-Lim module does not
have, so the port's is held to the port's Griffin-Lim."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from paule_tpu import reference_bridge as JRB
from paule_tpu.dsp import mel as JMEL
from paule_tpu_torch import reference_bridge as RB
from paule_tpu_torch.dsp import griffinlim as TGL
from paule_tpu_torch.dsp import mel as TMEL
from paule_tpu_torch.ops.normalize import inv_normalize_mel, normalize_mel
from paule_tpu_torch.synth import vtl_plant
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEL_KW = dict(sr=44100, n_fft=1024, hop_length=220, n_mels=60, power=1.0,
              fmin=10, fmax=12000)


@pytest.fixture(scope="module")
def librosas():
    """(the JAX package's librosa stand-in, the port's), not registered."""
    return JRB._make_librosa_module()[0], RB._make_librosa_module()[0]


@pytest.fixture(scope="module")
def signal():
    """0.3 s of a seeded chirp with noise at 44.1 kHz."""
    rng = np.random.default_rng(4)
    t = np.arange(13230) / 44100.0
    return (0.3 * np.sin(2 * np.pi * (200 + 900 * t) * t)
            + 0.05 * rng.normal(size=t.size))


def _float64_mel(y):
    """The amplitude mel ``(60, frames)`` by a float64 numpy STFT with the
    JAX package's periodic Hann window and Slaney filterbank."""
    pad = JMEL.N_FFT // 2
    frames = np.lib.stride_tricks.sliding_window_view(
        np.pad(y, (pad, pad)), JMEL.N_FFT)[::JMEL.HOP]
    spec = np.abs(np.fft.rfft(frames * JMEL._hann_periodic(), axis=-1))
    return (spec @ JMEL.mel_filterbank()).T


def test_melspectrogram(librosas, signal):
    jl, tl = librosas
    out = tl.feature.melspectrogram(y=signal, **MEL_KW)
    ref = jl.feature.melspectrogram(y=signal, **MEL_KW)
    exact = _float64_mel(signal)
    assert out.shape == ref.shape == (60, 1 + signal.size // 220)
    peak = np.abs(exact).max()
    assert np.abs(out - exact).max() <= 1e-9 * peak
    assert np.abs(out - ref).max() <= 1e-6 * peak
    with pytest.raises(NotImplementedError, match="configuration"):
        tl.feature.melspectrogram(y=signal, **dict(MEL_KW, n_mels=80))


def test_amplitude_to_db_and_back(librosas, signal):
    """The top-dB floor over the whole array; ``ref`` a number or a
    function of the magnitude, as librosa takes it."""
    jl, tl = librosas
    mel = _float64_mel(signal)
    for kw in ({"ref": 0.15}, {"ref": 1.0, "top_db": 40.0},
               {"ref": 0.15, "amin": 1e-3}):
        np.testing.assert_allclose(tl.amplitude_to_db(mel, **kw),
                                   jl.amplitude_to_db(mel, **kw), rtol=0,
                                   atol=1e-8)
    np.testing.assert_array_equal(
        tl.amplitude_to_db(mel, ref=np.max, top_db=None),
        tl.amplitude_to_db(mel, ref=float(mel.max()), top_db=None))
    db = jl.amplitude_to_db(mel, ref=0.15)
    np.testing.assert_allclose(tl.db_to_amplitude(db, ref=0.15),
                               jl.db_to_amplitude(db, ref=0.15), rtol=1e-15,
                               atol=0)


def test_the_stand_ins_give_the_main_paths_log_mel(librosas, signal):
    """``amplitude_to_db(melspectrogram(y), ref=0.15)`` is the main path's
    ``melspec_44100`` (transposed) bit for bit: both run the same amplitude
    step."""
    _jl, tl = librosas
    db = tl.amplitude_to_db(tl.feature.melspectrogram(y=signal, **MEL_KW),
                            ref=0.15)
    main = TMEL.melspec_44100(torch.as_tensor(signal)).numpy()
    np.testing.assert_array_equal(db.T, main)


def test_resample(librosas, signal):
    jl, tl = librosas
    for sr_in, sr_out in ((44100, 16000), (16000, 44100), (22050, 44100)):
        out = tl.resample(signal[:4000], orig_sr=sr_in, target_sr=sr_out)
        ref = jl.resample(signal[:4000], orig_sr=sr_in, target_sr=sr_out)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    with pytest.raises(NotImplementedError, match="kaiser_best"):
        tl.resample(signal, orig_sr=44100, target_sr=16000, res_type="fft")


def test_mel_to_audio_is_the_ports_griffin_lim(librosas, signal):
    """The amplitude mel ``(60, frames)`` to ``220 * (frames - 1)`` samples
    through the port's Griffin-Lim, the one ``mel_to_sig`` pads by 55
    zeros on each side."""
    _jl, tl = librosas
    mel = tl.feature.melspectrogram(y=signal[:4400], **MEL_KW)
    out = tl.feature.inverse.mel_to_audio(mel, sr=44100, n_fft=1024,
                                          hop_length=220, power=1.0)
    griffin_lim = TGL.mel_amplitude_to_audio(mel.T, device="cpu",
                                             dtype=torch.float64)
    assert out.shape == (220 * (mel.shape[1] - 1),)
    np.testing.assert_array_equal(out, griffin_lim)
    norm = normalize_mel(TMEL.amplitude_to_db(torch.as_tensor(mel.T)))
    sig, _sr = TGL.mel_to_sig(norm, device="cpu", dtype=torch.float64)
    amplitude = 10.0 ** (inv_normalize_mel(norm.numpy()) / 20.0)
    np.testing.assert_array_equal(sig[55:-55], TGL.mel_amplitude_to_audio(
        amplitude * TMEL.DB_REF, device="cpu", dtype=torch.float64))


def test_soundfile_and_toml_stand_ins(tmp_path):
    sf = RB._make_soundfile_module()
    with pytest.raises(NotImplementedError, match="signal, sr"):
        sf.read("x.wav")
    path = tmp_path / "p.toml"
    path.write_text('[project]\nname = "paule"\nversion = "0.4"\n')
    assert RB._make_toml_module().load(str(path)) == {
        "project": {"name": "paule", "version": "0.4"}}


def test_install_shims_shadows_nothing_installed(monkeypatch):
    """A stand-in registers only where the package is neither imported nor
    installed: ``librosa`` taken as imported and ``soundfile`` as installed
    here keep their places; ``toml`` gets one only if it is missing."""
    real_missing = RB._missing
    assert not real_missing("numpy")
    assert real_missing("a_module_that_is_not_installed")
    sentinel = types.ModuleType("librosa")
    monkeypatch.setitem(sys.modules, "librosa", sentinel)
    monkeypatch.setattr(RB, "_missing",
                        lambda name: name != "soundfile"
                        and real_missing(name))
    before = set(sys.modules)
    toml_missing = real_missing("toml")
    try:
        RB.install_shims()
        added = set(sys.modules) - before
    finally:
        for name in set(sys.modules) - before:
            del sys.modules[name]
    assert sys.modules["librosa"] is sentinel
    assert added == ({"toml"} if toml_missing else set())


def test_reference_is_not_here_and_hidden_is_shared(monkeypatch):
    assert not RB.reference_available()
    assert vtl_plant.reference_hidden is RB.reference_hidden
    assert vtl_plant.DEFAULT_LIB.startswith(RB.REFERENCE_ROOT)
    monkeypatch.setenv("PAULE_TPU_HIDE_REFERENCE", "1")
    assert RB.reference_hidden() and not vtl_plant.vtl_available()
    assert not RB.reference_available(REPO)
    with pytest.raises(FileNotFoundError, match="no reference checkout"):
        RB.import_reference(os.path.join(REPO, "no_such_checkout"))


def test_the_stand_ins_import_no_jax():
    """In a fresh process: install the stand-ins, import and call them; no
    module of JAX, transformers or the JAX package is imported."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from paule_tpu_torch import reference_bridge as RB\n"
        "RB.install_shims()\n"
        "import librosa, soundfile, toml\n"
        "y = np.random.default_rng(0).normal(size=4410)\n"
        "m = librosa.feature.melspectrogram(y=y, sr=44100, n_fft=1024, "
        "hop_length=220, n_mels=60, power=1.0, fmin=10, fmax=12000)\n"
        "librosa.amplitude_to_db(m, ref=0.15)\n"
        "librosa.resample(y, orig_sr=44100, target_sr=16000)\n"
        "librosa.feature.inverse.mel_to_audio(m[:, :4], sr=44100, "
        "n_fft=1024, hop_length=220)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'transformers', 'paule_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
