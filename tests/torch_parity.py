"""Helpers of the port's parity tests against ``paule_tpu.api.Paule``:
tolerances, a synthesizer stand-in that is smooth in the cp, and the noise
hand-over from a JAX instance's generators to the port's."""

import numpy as np
import torch

from paule_tpu.api import Paule as JPaule
from paule_tpu.ops.normalize import normalize_cp
from paule_tpu_torch.api import Paule

#: as tests/test_torch_slice.py: trajectories absolutely, loss series
#: relatively
CP_ATOL = 1e-6
LOSS_RTOL = 1e-5
#: Griffin-Lim's target signal, relative to its peak (tests/test_torch_dsp.py)
SIG_RTOL_PEAK = 1e-8
PLANNED = ("planned_loss_steps", "planned_mel_loss_steps", "vel_loss_steps",
           "jerk_loss_steps", "pred_semvec_loss_steps")
SERIES = PLANNED + ("prod_loss_steps", "prod_semvec_loss_steps",
                    "pred_model_loss", "inv_model_loss")
ARRAYS = ("initial_cp", "target_mel", "pred_mel", "prod_mel",
          "initial_pred_semvec", "prod_semvec", "pred_semvec")


def seeded_semvec(seed=3):
    """A semantic vector ``(300,)`` from a seed."""
    return np.random.default_rng(seed).normal(size=300) * 0.3


def record_noise(jpaule):
    """Wrap the JAX instance's generators so that each call appends the
    noise it is given, in call order, to the returned list."""
    noises = []
    for gen in (jpaule.mel_gen_model, jpaule.cp_gen_model):
        def apply(params, x, length, vector, _orig=gen.apply, **kw):
            noises.append(np.asarray(x, dtype=np.float64))
            return _orig(params, x, length, vector, **kw)
        gen.apply = apply
    return noises


def replay_noise(port, noises):
    """Make ``port._noise`` return the recorded noises in order."""
    it = iter(noises)
    port._noise = lambda: torch.tensor(next(it), dtype=port.dtype,
                                       device=port.device)


def compare(out, ref, series=SERIES, arrays=ARRAYS):
    """The port's results ``out`` against JAX's ``ref``: the plan and the
    ``arrays`` to :data:`CP_ATOL`, the loss ``series`` to
    :data:`LOSS_RTOL`."""
    np.testing.assert_allclose(out.planned_cp, ref.planned_cp, rtol=0,
                               atol=CP_ATOL)
    for key in series:
        assert len(getattr(out, key)) == len(getattr(ref, key)), key
        np.testing.assert_allclose(getattr(out, key), getattr(ref, key),
                                   rtol=LOSS_RTOL, atol=0, err_msg=key)
    for key in arrays:
        np.testing.assert_allclose(getattr(out, key), getattr(ref, key),
                                   rtol=0, atol=CP_ATOL, err_msg=key)


def plan_both(kw, jax_init=None, port_init=None, n_noises=None, seed=7):
    """``plan_resynth(**kw)`` through a JAX instance and a port instance
    (float64, CPU) made with ``jax_init`` and ``port_init``, the port given
    the noise JAX drew (``n_noises`` draws, if given).  -> (port results,
    JAX results, the closed port instance, the JAX noises)."""
    jpaule = JPaule(seed=seed, **(jax_init or {}))
    noises = record_noise(jpaule)
    ref = jpaule.plan_resynth(**kw)
    if n_noises is not None:
        assert len(noises) == n_noises
    port = Paule(device="cpu", dtype=torch.float64, seed=seed,
                 **(port_init or {}))
    replay_noise(port, noises)
    try:
        out = port.plan_resynth(**kw)
    finally:
        port.close()
    return out, ref, port, noises


class SmoothPlant:
    """A stand-in synthesizer, smooth in the cp: 110 samples per cp frame,
    30 sines whose amplitudes follow the normalised cp, interpolated."""

    def speak(self, cp):
        norm = normalize_cp(np.asarray(cp, dtype=np.float64))
        n = (norm.shape[0] - 1) * 110
        t = np.arange(n) / 44100.0
        frames = np.arange(n) / 110.0
        amp = np.stack([np.interp(frames, np.arange(norm.shape[0]), c)
                        for c in norm.T], axis=1)
        freqs = 150.0 + 97.0 * np.arange(30)
        return (0.02 * np.tanh(amp) * np.sin(2 * np.pi * t[:, None]
                                             * freqs)).sum(1), 44100

    def speak_batch(self, cps):
        audio = np.stack([self.speak(cp)[0] for cp in cps])
        return audio, 44100, np.zeros(len(cps), dtype=np.int32)
