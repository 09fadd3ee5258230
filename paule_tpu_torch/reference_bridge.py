"""Run the upstream PyTorch reference (quantling/paule) beside the port
(the port's counterpart of ``paule_tpu/reference_bridge.py``).

The reference imports librosa, soundfile and toml, which need not be
installed.  :func:`install_shims` registers stand-ins in ``sys.modules``
before the reference package is imported, each from the port's own
modules (float64 on the CPU), and never in place of an installed package:

* ``librosa.resample`` -> :func:`paule_tpu_torch.dsp.resample.resample`
  (resampy's kaiser_best);
* ``librosa.feature.melspectrogram`` -> the amplitude mel ``(n_mels,
  frames)`` of :func:`paule_tpu_torch.dsp.mel.mel_amplitude_44100` (centred,
  zero padding), the main path's own first step;
* ``librosa.amplitude_to_db`` (the top-dB floor over the whole array) and
  ``librosa.db_to_amplitude``;
* ``librosa.feature.inverse.mel_to_audio`` -> the port's Griffin-Lim
  (:func:`paule_tpu_torch.dsp.griffinlim.mel_amplitude_to_audio`);
* ``soundfile``, which raises on use (pass ``(signal, sr)`` tuples);
* ``toml``, through the standard library's ``tomllib``.

The reference's own models, planning loop and native VocalTractLab
synthesizer are real.  Its checkout is ``PAULE_REFERENCE_ROOT`` (default:
``reference/`` in the checkout of this repo); ``PAULE_TPU_HIDE_REFERENCE=1``
makes every feature of a checkout report itself unavailable.
"""

import importlib.util
import os
import sys
import types

import numpy as np

#: a checkout of the reference package (``<root>/paule/``)
REFERENCE_ROOT = os.environ.get(
    "PAULE_REFERENCE_ROOT",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "reference"))


def _make_librosa_module():
    """-> the stand-in modules ``(librosa, librosa.feature,
    librosa.feature.inverse, librosa.display)``, not yet registered."""
    import torch

    from .dsp import griffinlim, mel
    from .dsp.resample import resample as _kaiser_best

    librosa = types.ModuleType("librosa")
    feature = types.ModuleType("librosa.feature")
    inverse = types.ModuleType("librosa.feature.inverse")
    display = types.ModuleType("librosa.display")

    config = {"sr": mel.SR, "n_fft": mel.N_FFT, "hop_length": mel.HOP,
              "power": 1.0, "n_mels": mel.N_MELS, "fmin": mel.FMIN,
              "fmax": mel.FMAX}

    def check(**given):
        wrong = {k: v for k, v in given.items() if v != config[k]}
        if wrong:
            raise NotImplementedError(
                "the librosa stand-in computes the reference's one mel "
                f"configuration {config}, got {wrong}")

    def resample(y, *, orig_sr, target_sr, res_type="kaiser_best", fix=True,
                 scale=False, **_):
        if res_type != "kaiser_best" or not fix or scale:
            raise NotImplementedError(
                "the stand-in resamples with res_type='kaiser_best', "
                "fix=True, scale=False only")
        return _kaiser_best(np.asarray(y, np.float64), orig_sr, target_sr)

    def melspectrogram(*, y, sr, n_fft, hop_length, n_mels, power, fmin,
                       fmax, **_):
        check(sr=sr, n_fft=n_fft, hop_length=hop_length, power=power,
              n_mels=n_mels, fmin=fmin, fmax=fmax)
        amp = mel.mel_amplitude_44100(torch.as_tensor(
            np.asarray(y, np.float64)))
        return amp.numpy().T

    def amplitude_to_db(S, ref=1.0, amin=1e-5, top_db=80.0):
        magnitude = np.abs(np.asarray(S, np.float64))
        ref = ref(magnitude) if callable(ref) else abs(ref)
        return mel.amplitude_to_db(
            torch.as_tensor(magnitude), ref=float(ref), amin=float(amin),
            top_db=top_db, per_item=False).numpy()

    def db_to_amplitude(S_db, ref=1.0):
        return float(ref) * np.power(10.0, np.asarray(S_db, np.float64)
                                     / 20.0)

    def mel_to_audio(M, *, sr, n_fft, hop_length, power=1.0, fmin=mel.FMIN,
                     fmax=mel.FMAX, **_):
        check(sr=sr, n_fft=n_fft, hop_length=hop_length, power=power,
              n_mels=len(M), fmin=fmin, fmax=fmax)
        return griffinlim.mel_amplitude_to_audio(
            np.asarray(M, np.float64).T, device="cpu", dtype=torch.float64)

    def specshow(*_args, **_kwargs):
        raise NotImplementedError("the librosa.display stand-in does not "
                                  "plot")

    librosa.resample = resample
    librosa.amplitude_to_db = amplitude_to_db
    librosa.db_to_amplitude = db_to_amplitude
    feature.melspectrogram = melspectrogram
    inverse.mel_to_audio = mel_to_audio
    feature.inverse = inverse
    librosa.feature = feature
    display.specshow = specshow
    librosa.display = display
    librosa.__version__ = "0.0-paule_tpu_torch-stand-in"
    return librosa, feature, inverse, display


def _make_soundfile_module():
    sf = types.ModuleType("soundfile")

    def unavailable(*_args, **_kwargs):
        raise NotImplementedError(
            "the soundfile stand-in reads and writes nothing: pass (signal, "
            "sr) tuples instead of paths")

    sf.read = unavailable
    sf.write = unavailable
    return sf


def _make_toml_module():
    import tomllib

    toml = types.ModuleType("toml")

    def load(path):
        with open(path, "rb") as fh:
            return tomllib.load(fh)

    toml.load = load
    return toml


def _missing(name):
    """Whether ``name`` is neither imported nor installed: only then may a
    stand-in take its place."""
    if name in sys.modules:
        return False
    try:
        return importlib.util.find_spec(name) is None
    except (ImportError, ValueError):
        return True


def install_shims():
    """Register the stand-ins of librosa, soundfile and toml in
    ``sys.modules``, each only where the package is missing (idempotent)."""
    if _missing("librosa"):
        librosa, feature, inverse, display = _make_librosa_module()
        sys.modules["librosa"] = librosa
        sys.modules["librosa.feature"] = feature
        sys.modules["librosa.feature.inverse"] = inverse
        sys.modules["librosa.display"] = display
    if _missing("soundfile"):
        sys.modules["soundfile"] = _make_soundfile_module()
    if _missing("toml"):
        sys.modules["toml"] = _make_toml_module()


def import_reference(reference_root=REFERENCE_ROOT):
    """Import the upstream ``paule`` package of the checkout
    ``reference_root`` (which holds ``paule/``) with the stand-ins
    installed, and return it; its import loads the VocalTractLab library."""
    if not os.path.isdir(os.path.join(reference_root, "paule")):
        raise FileNotFoundError(
            f"no reference checkout at {reference_root}")
    install_shims()
    if reference_root not in sys.path:
        sys.path.insert(0, reference_root)
    import paule.models  # noqa: F401
    import paule.paule  # noqa: F401
    return sys.modules["paule"]


def reference_hidden():
    """True when ``PAULE_TPU_HIDE_REFERENCE=1``: every feature of a
    reference checkout reports itself unavailable."""
    return os.environ.get("PAULE_TPU_HIDE_REFERENCE", "0") == "1"


def reference_available(reference_root=REFERENCE_ROOT):
    """Whether ``reference_root`` holds the reference package (and the
    reference is not hidden)."""
    if reference_hidden():
        return False
    return os.path.isdir(os.path.join(reference_root, "paule"))
