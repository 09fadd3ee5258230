"""The port's DSP front end and synthesizer binding against the JAX
package: log-mel to 1e-8 in float64, resampling and synthesis exact."""

import numpy as np
import torch

import jax.numpy as jnp

from paule_tpu import synth as JS
from paule_tpu.dsp import mel as JM
from paule_tpu.dsp import resample as JRS
from paule_tpu.dsp import targets as JT
from paule_tpu.ops.normalize import inv_normalize_cp
from paule_tpu_torch import synth as TS
from paule_tpu_torch.dsp import mel as TM
from paule_tpu_torch.dsp import resample as TRS
from paule_tpu_torch.dsp import targets as TT

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
