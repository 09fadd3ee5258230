"""The port's DSP front end, Griffin-Lim, audio file IO and synthesizer
binding against the JAX package: log-mel to 1e-8 in float64, Griffin-Lim
to 1e-8 of the signal's peak; resampling, WAV IO and synthesis exact."""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paule_tpu import synth as JS
from paule_tpu.dsp import audio as JA
from paule_tpu.dsp import griffinlim as JGL
from paule_tpu.dsp import mel as JM
from paule_tpu.dsp import resample as JRS
from paule_tpu.dsp import targets as JT
from paule_tpu.ops.normalize import (inv_normalize_cp, inv_normalize_mel,
                                     normalize_mel)
from paule_tpu_torch import synth as TS
from paule_tpu_torch.dsp import audio as TA
from paule_tpu_torch.dsp import griffinlim as TGL
from paule_tpu_torch.dsp import mel as TM
from paule_tpu_torch.dsp import resample as TRS
from paule_tpu_torch.dsp import targets as TT
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-8
F64 = {"device": "cpu", "dtype": torch.float64}


def _sig(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.sin(np.arange(n) * 0.05) * 0.3 + rng.normal(size=n) * 0.05


def test_filterbank_and_basis_match_jax():
    np.testing.assert_array_equal(TM.mel_filterbank(), JM.mel_filterbank())
    np.testing.assert_array_equal(TM.rfft_basis(), JM._rfft_basis())


def test_melspec_matches_jax():
    y = _sig(4410)
    ref = np.asarray(JM.melspec_44100(jnp.asarray(y), dtype=jnp.float64))
    out = TM.melspec_44100(torch.tensor(y)).numpy()
    assert out.shape == ref.shape == (1 + 4410 // 220, 60)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_batched_melspec_matches_per_row():
    ys = np.stack([_sig(3300, seed=s) for s in range(3)])
    out = TM.melspec_44100(torch.tensor(ys)).numpy()
    for y, o in zip(ys, out):
        ref = np.asarray(JM.melspec_44100(jnp.asarray(y), dtype=jnp.float64))
        np.testing.assert_allclose(o, ref, rtol=0, atol=ATOL)


def test_resample_matches_jax_exactly():
    y = _sig(2205)
    for sr in (22050, 16000, 48000):
        np.testing.assert_array_equal(TRS.resample(y, sr, 44100),
                                      JRS.resample(y, sr, 44100))


def test_target_mel_matches_jax():
    y = _sig(8000, seed=3)
    for sr in (44100, 16000):
        ref = JT.normalized_target_mel(y, sr)
        out = TT.normalized_target_mel(y, sr, **F64)
        assert out.min() == 0.0
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    sig, sr, mel = TT.audio_target_to_mel((np.stack([y, y], 1), 44100), **F64)
    np.testing.assert_array_equal(sig, y)
    np.testing.assert_allclose(mel, JT.normalized_target_mel(y, 44100),
                               rtol=0, atol=ATOL)


def _raw_wav(path, frames, fmt_tag, bits, channels, sr=16000):
    """A RIFF/WAVE file holding ``frames`` (raw sample bytes) as written by
    another tool, with a ``LIST`` chunk before ``data``."""
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, sr,
                      sr * channels * bits // 8, channels * bits // 8, bits)
    chunks = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
              + b"LIST" + struct.pack("<I", 3) + b"abc\x00"
              + b"data" + struct.pack("<I", len(frames)) + frames)
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE"
                 + chunks)


@pytest.mark.parametrize("kind", ["pcm16_mono", "pcm16_stereo", "pcm8",
                                  "pcm24", "pcm32", "float32", "float64"])
def test_wav_io_matches_jax(kind, tmp_path):
    """A WAV round trip: the port writes the JAX package's bytes, and both
    read every supported encoding to the same signal."""
    rng = np.random.default_rng(4)
    path = str(tmp_path / f"{kind}.wav")
    if kind.startswith("pcm16"):
        sig = np.clip(rng.normal(0, 0.3, (300, 2 if "stereo" in kind
                                          else 1)), -1, 1).squeeze()
        assert TA.write(path, sig, 22050) == path
        ref_path = str(tmp_path / "ref.wav")
        JA.write(ref_path, sig, 22050)
        with open(path, "rb") as a, open(ref_path, "rb") as b:
            assert a.read() == b.read()
    else:
        bits = int(kind[-2:]) if kind[-2:].isdigit() else 8
        fmt_tag = 3 if kind.startswith("float") else 1
        n_bytes = 50 * bits // 8
        _raw_wav(path, rng.integers(0, 256, n_bytes, dtype=np.uint8)
                 .tobytes() if fmt_tag == 1 else
                 rng.normal(0, 0.3, 50).astype(f"<f{bits // 8}").tobytes(),
                 fmt_tag, bits, channels=1)
    out, sr = TA.read(path)
    ref, ref_sr = JA.read(path)
    assert sr == ref_sr and out.dtype == np.float64
    np.testing.assert_array_equal(out, ref)
    if out.ndim == 2:
        for which in ("left", "right", "both"):
            np.testing.assert_array_equal(TA.stereo_to_mono(out, which),
                                          JA.stereo_to_mono(ref, which))


def test_audio_path_target_matches_jax(tmp_path):
    y = _sig(8000, seed=5)
    path = str(tmp_path / "target.wav")
    TA.write(path, np.stack([y, -y], 1), 16000)
    sig, sr, mel = TT.audio_target_to_mel(path, **F64)
    ref_sig, ref_sr = JA.read(path)
    ref_sig = JA.stereo_to_mono(ref_sig)
    assert sr == ref_sr == 16000
    np.testing.assert_array_equal(sig, ref_sig)
    np.testing.assert_allclose(mel, JT.normalized_target_mel(ref_sig, sr),
                               rtol=0, atol=ATOL)


def _cps(n_frames, seed):
    rng = np.random.default_rng(seed)
    return inv_normalize_cp(np.clip(
        rng.normal(0, 0.05, (n_frames, 30)).cumsum(0) * 0.2, -1, 1))


def test_synth_matches_jax_bit_for_bit():
    cp = _cps(30, 0)
    audio, sr = TS.speak(cp)
    ref, ref_sr = JS.speak(cp)
    assert sr == ref_sr and audio.shape == ((30 - 1) * 110,)
    np.testing.assert_array_equal(audio, ref)

    batch = np.stack([_cps(25, s) for s in range(3)])
    pool = TS.SynthPool(size=2)
    jpool = JS.SynthPool(size=2)
    try:
        out, _, errors = pool.speak_batch(batch)
        ref, _, ref_errors = jpool.speak_batch(batch)
        np.testing.assert_array_equal(out, ref)
        assert not errors.any() and not ref_errors.any()
        np.testing.assert_array_equal(pool.speak(batch[1])[0], ref[1])
    finally:
        pool.close()
        jpool.close()


def test_synth_pool_flags_non_finite_rows():
    """A non-finite trajectory in a batch is flagged with error -1, as the
    JAX package's pool does, and the other rows are synthesised as
    usual."""
    batch = np.stack([_cps(25, s) for s in range(3)])
    batch[1, 4, 7] = np.nan
    pool = TS.SynthPool(size=2)
    jpool = JS.SynthPool(size=2)
    try:
        out, _, errors = pool.speak_batch(batch)
        ref, _, ref_errors = jpool.speak_batch(batch)
    finally:
        pool.close()
        jpool.close()
    np.testing.assert_array_equal(errors, ref_errors)
    assert list(errors) == [0, -1, 0]
    np.testing.assert_array_equal(out[[0, 2]], ref[[0, 2]])


def _seeded_mel(frames, seed=0):
    """A smooth normalised log-mel in [0, 1]."""
    rng = np.random.default_rng(seed)
    walk = rng.normal(0.5, 0.15, (frames, 60)).cumsum(0)
    return np.clip(walk / np.sqrt(np.arange(1, frames + 1))[:, None], 0, 1)


#: Griffin-Lim with momentum 0.99 is chaotic: at 201 frames the JAX package
#: run on a mel and on the same mel times (1 + 1e-15) gives signals 0.53 of
#: their peak apart.  Parity with JAX is therefore held where the
#: iteration has not yet amplified the two FFTs' last-bit differences:
#: mel_to_sig at 20 frames (measured 3.4e-10 of the peak), and the first
#: two iterations at 201 frames (measured 9e-11).
GL_RTOL_PEAK = 1e-8


def test_mel_to_sig_matches_jax():
    mel = _seeded_mel(20)
    sig, sr = TGL.mel_to_sig(mel, **F64)
    ref, ref_sr = JGL.mel_to_sig(mel)
    assert sr == ref_sr == 44100
    assert len(sig) == len(ref) == 220 * 20 - 110
    np.testing.assert_array_equal(sig[:55], 0.0)
    np.testing.assert_array_equal(sig[-55:], 0.0)
    np.testing.assert_allclose(sig, ref, rtol=0,
                               atol=GL_RTOL_PEAK * np.abs(ref).max())


@pytest.mark.parametrize("n_iter", [0, 2])
def test_griffin_lim_iterations_match_jax(n_iter):
    mel = _seeded_mel(201, seed=1)
    amplitude = 10.0 ** (inv_normalize_mel(mel) / 20.0) * TM.DB_REF
    lin = np.maximum(amplitude @ TGL._mel_pinv(), 0.0)
    length = 220 * 200
    ref = np.asarray(JGL.griffin_lim(jnp.asarray(lin), n_iter=n_iter,
                                     length=length, dtype=jnp.float64))
    out = TGL.griffin_lim(torch.tensor(lin), n_iter=n_iter,
                          length=length).numpy()
    assert out.shape == (length,)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=GL_RTOL_PEAK * np.abs(ref).max())


@pytest.mark.parametrize("frames", [1, 2, 20, 201])
def test_mel_to_sig_length_contract(frames):
    """``frames`` mel frames -> ``220 * frames - 110`` samples, the length
    the synthesizer gives for ``2 * frames`` cp frames."""
    sig, sr = TGL.mel_to_sig(np.zeros((frames, 60)), **F64)
    assert sr == 44100 and len(sig) == 220 * frames - 110
    assert np.isfinite(sig).all()


def test_griffin_lim_reconstructs_tone_mel():
    """A tone's mel, inverted and featurised again, correlates with the
    original mel (the JAX package's test, ``tests/test_dsp.py:108``)."""
    t = np.arange(22050) / 44100
    sig = 0.3 * np.sin(2 * np.pi * 800.0 * t) * np.hanning(len(t))
    mel = TM.librosa_melspec(sig, 44100, **F64)
    rec, sr = TGL.mel_to_sig(normalize_mel(mel), **F64)
    mel2 = TM.librosa_melspec(rec, sr, **F64)
    n = min(mel.shape[0], mel2.shape[0])
    assert np.corrcoef(mel[:n].ravel(), mel2[:n].ravel())[0, 1] > 0.85
