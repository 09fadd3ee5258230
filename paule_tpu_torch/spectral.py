"""The differentiable physical forward model (counterpart of
``paule_tpu/spectral.py``): cp -> mel through the stationary acoustics of
the synthesizer's own tube, so that planning runs through the physics with
no trained predictive model (``Paule(physical_forward=True)``).

    cp (T, 30) --tract_to_tube--> areas (T, 40)
              --chain-matrix tube acoustics--> |H(f)| (T, K)
              --glottal source x radiation--> |P(f)| (T, K)
              --mel filterbank, dB, normalisation--> mel (T/2, 60)

Plain torch ops throughout, differentiable in the cp.  Two details follow
the JAX functions' gradients exactly:

* every ``clip`` and ``maximum`` of the JAX code is
  ``torch.minimum``/``torch.maximum`` against a tensor, which split the
  gradient half and half at a tie as ``jnp.clip``/``jnp.maximum`` do
  (``torch.clamp`` would pass all of it).  Ties happen: ``smiling=True``
  pins cp onto the tract bounds that :func:`tract_to_tube` clips to.
* the nasal branch's admittance table is rounded to complex64 before it
  is cast to the working dtype, as ``paule_tpu/spectral.py:202`` rounds it.

The chain product over the 40 sections is a Python loop of elementwise
complex ops on ``(..., K)`` tensors (the JAX package's ``lax.scan``).
"""

import functools

import numpy as np
import torch
from torch import nn

from . import synth
from .dsp.mel import N_FFT, SR, amplitude_to_db, mel_filterbank
from .ops.derivatives import half_sequence
from .ops.normalize import (cp_theoretical_means, cp_theoretical_stds,
                            normalize_mel)

N_TUBE = 40
SPEED_OF_SOUND = 35000.0  # cm/s
AIR_DENSITY = 1.14e-3     # g/cm^3

#: the waveguide delays one sample per section at 44.1 kHz and quantises
#: the tract length to 8-40 sections; the spectral model uses the smooth
#: equivalent, so that gradients flow through the length
CM_PER_WAVEGUIDE_SECTION = SPEED_OF_SOUND / 44100.0
MIN_TOTAL_LEN_CM = 8 * CM_PER_WAVEGUIDE_SECTION
MAX_TOTAL_LEN_CM = N_TUBE * CM_PER_WAVEGUIDE_SECTION

# the geometric tract model's profiles (paule_tpu/synth/csrc/model.cpp
# make_geometry)
_PX = np.array([0.00, 0.06, 0.12, 0.25, 0.40, 0.50, 0.62, 0.75, 0.85, 0.92,
                1.00])
_PD = np.array([0.40, 0.90, 1.30, 1.50, 1.40, 1.30, 1.20, 1.10, 0.90, 0.80,
                0.70])
_WX = np.array([0.00, 0.12, 0.45, 0.75, 0.92, 1.00])
_WW = np.array([1.20, 2.00, 3.20, 2.80, 2.00, 1.40])

#: section midpoints and the static profiles there
_X = (np.arange(N_TUBE) + 0.5) / N_TUBE
_D0 = np.interp(_X, _PX, _PD)   # resting sagittal distance
_W0 = np.interp(_X, _WX, _WW)   # lateral width
_LS = np.clip((_X - 0.90) / 0.07, 0.0, 1.0)      # lip blend
_TAPER = np.clip((_X - 0.55) / 0.35, 0.0, 1.0)   # jaw taper

BASE_LENGTH_CM = 16.0  # the default speaker's anatomy

#: the nasal branch's fixed area profile
_NASAL_AREAS = np.array([1.5, 2.2, 3.0, 3.6, 4.0, 4.0, 3.6, 3.0, 2.4, 2.0,
                         1.6, 1.3, 1.1, 1.0])
#: the section after which the nasal branch couples in
_VELAR_JUNCTION = int(0.48 * N_TUBE)

#: gain calibrating the model's dB range to the synthesizer's mel
CALIBRATION_GAIN = 0.645


def _const(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _maximum(x, lo):
    return torch.maximum(x, _const(lo, x))


def _minimum(x, hi):
    return torch.minimum(x, _const(hi, x))


def _clip(x, lo, hi):
    """``jnp.clip``: the gradient split half and half at a tie."""
    return _minimum(_maximum(x, lo), hi)


def _gauss(x, c, s):
    return torch.exp(-0.5 * ((x - c) / s) ** 2)


@functools.lru_cache(maxsize=1)
def _bounds():
    """The default speaker's tract parameter bounds (min, max)."""
    info = synth.get_param_info("tract")
    return np.asarray(info["mins"]), np.asarray(info["maxs"])


def velum_opening(tract):
    """Velum opening (cm^2, clipped as the C++ model clips it) of
    denormalised tract parameters ``(..., 19)`` -> ``(...)``."""
    mins, maxs = _bounds()
    vo = _clip(tract[..., 7], mins[7], maxs[7])
    return _clip(_maximum(vo, 0.0), 0.0, 1.0)


def tract_to_tube(tract):
    """Denormalised tract parameters ``(..., 19)`` -> ``(areas (..., 40) in
    cm^2, section length (...) in cm)``: the C++ ``tract_to_tube`` of the
    default speaker (``paule_tpu/spectral.py:105-166``)."""
    mins, maxs = _bounds()
    q = _clip(tract, mins, maxs)
    HX, HY, JX, JA, LP, LD, VS, _VO = (q[..., i] for i in range(8))
    TCX, TCY, TTX, TTY, TBX, TBY, TRX, TRY = (q[..., i]
                                              for i in range(8, 16))
    TS1, TS2, TS3 = q[..., 16], q[..., 17], q[..., 18]

    length_cm = (BASE_LENGTH_CM + 0.5 * HX - 0.6 * (HY + 4.75)
                 + 0.8 * _maximum(LP, 0.0) + 0.2 * _minimum(LP, 0.0))
    jaw_open = (-JA) / 7.0

    c_body = 0.60 + 0.030 * TCX + 0.008 * JX
    p_body = _clip((TCY + 3.0) / 4.0, 0.0, 1.1)
    c_blade = 0.72 + 0.020 * TBX + 0.008 * JX
    p_blade = _clip((TBY + 3.0) / 8.0, 0.0, 1.1)
    c_tip = 0.82 + 0.018 * TTX + 0.010 * JX
    p_tip = _clip((TTY + 3.0) / 5.5, 0.0, 1.1)
    c_root = 0.30
    p_root = _clip((2.0 - TRX) / 6.0, 0.0, 1.1)
    try_narrow = torch.maximum(_const(0.0, TRY), -(TRY + 3.0) / 3.0)
    ts1 = _clip(TS1, 0.0, 1.0)
    ts2 = _clip(TS2, 0.0, 1.0)
    ts3 = _clip(TS3, -1.0, 1.0)

    x = _const(_X, tract)

    def e(a):
        return a[..., None]

    body = 1.60 * e(p_body) ** 3.0 * _gauss(x, e(c_body), 0.12)
    blade = 1.50 * e(p_blade) ** 2.0 * _gauss(x, e(c_blade), 0.08)
    tip = 1.30 * e(p_tip) ** 2.0 * _gauss(x, e(c_tip), 0.05)
    root = (0.70 * e(p_root) ** 2 + 0.25 * e(try_narrow)) * \
        _gauss(x, c_root, 0.10)
    dist = _const(_D0, tract) - torch.maximum(torch.maximum(body, blade),
                                              torch.maximum(tip, root))
    dist = dist - 0.30 * e(VS) * _gauss(x, 0.50, 0.05)
    dist = dist + 0.9 * (e(jaw_open) - 2.0 / 7.0) * _const(_TAPER, tract)
    ls = _const(_LS, tract)
    dist = dist * (1.0 - ls) + 0.8 * e(LD) * ls

    dist = _maximum(dist, 0.0)
    area = _const(_W0, tract) * dist ** 1.3
    area = area * (1.0 - 0.45 * e(ts1) * _gauss(x, 0.58, 0.10))
    area = area * (1.0 - 0.45 * e(ts2) * _gauss(x, 0.72, 0.08))
    pos = _maximum(ts3, 0.0)
    neg = _maximum(-ts3, 0.0)
    area = area * (1.0 - 0.45 * e(pos) * _gauss(x, 0.83, 0.06)) \
        + 0.35 * e(neg) * _gauss(x, 0.83, 0.06)
    area = _clip(area, 0.0, 15.0)
    return area, length_cm / N_TUBE


def _radiation_impedance(area, freqs):
    """Piston-in-baffle radiation impedance (low-ka form); numpy arrays or
    tensors."""
    r = (area / np.pi) ** 0.5
    k = 2.0 * np.pi * freqs / SPEED_OF_SOUND
    ka = k * r
    return (AIR_DENSITY * SPEED_OF_SOUND / area) * \
        (0.25 * ka ** 2 + 1j * 0.61 * ka)


@functools.lru_cache(maxsize=4)
def nasal_input_admittance(n_freqs, f_max):
    """Input admittance ``(n_freqs,)`` complex64 of the fixed nasal tract
    (the chain matrix of its 14 sections, loaded by the nostrils'
    radiation) on ``linspace(0, f_max, n_freqs)``; host numpy, computed once
    per grid."""
    freqs = np.linspace(0.0, f_max, n_freqs)
    k = 2.0 * np.pi * freqs / SPEED_OF_SOUND
    sec = CM_PER_WAVEGUIDE_SECTION
    A = np.ones(n_freqs, complex)
    B = np.zeros(n_freqs, complex)
    C = np.zeros(n_freqs, complex)
    D = np.ones(n_freqs, complex)
    for a in _NASAL_AREAS:
        radius = (a / np.pi) ** 0.5
        alpha = 3.0e-5 * np.sqrt(np.maximum(freqs, 1.0)) / radius
        kl = (k - 1j * alpha) * sec
        z = AIR_DENSITY * SPEED_OF_SOUND / a
        c_, s_ = np.cos(kl), np.sin(kl)
        A, B, C, D = (A * c_ + B * (1j * s_ / z),
                      A * (1j * z * s_) + B * c_,
                      C * c_ + D * (1j * s_ / z),
                      C * (1j * z * s_) + D * c_)
    z_rad = _radiation_impedance(_NASAL_AREAS[-1], freqs)
    y = (C * z_rad + D) / (A * z_rad + B)
    return y.astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _nasal_table(n_freqs, f_max, cdtype, device):
    """:func:`nasal_input_admittance` as a ``cdtype`` tensor on
    ``device``, copied there once."""
    return torch.as_tensor(nasal_input_admittance(n_freqs, f_max),
                           device=device).to(cdtype)


def _complex_dtype(dtype):
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def tube_transfer_magnitude(areas, sec_len, freqs, *, velum_open=None,
                            f_max=SR / 2.0, min_area=1e-3):
    """``|U_lips / U_glottis|`` ``(..., K)`` of the 40-section tube
    (``areas (..., 40)``, ``sec_len (...)`` in cm) at ``freqs (K,)`` Hz:
    lossy transmission-line sections, glottis to lips, loaded by the lips'
    radiation impedance; with ``velum_open (...)`` (cm^2) the nasal tract
    couples in as a shunt admittance at the velar junction, scaled by the
    port's area."""
    cdtype = _complex_dtype(areas.dtype)
    a = _maximum(areas, min_area)                       # (..., 40)
    w = 2.0 * np.pi * freqs
    k = w / SPEED_OF_SOUND                              # (K,)
    # per section on the leading axis: (40, ..., K)
    a_s = a.movedim(-1, 0)[..., None]                   # (40, ..., 1)
    radius = torch.sqrt(a_s / np.pi)
    alpha = 3.0e-5 * torch.sqrt(_maximum(freqs, 1.0)) / radius
    kl = torch.complex(k.expand_as(alpha), -alpha) * sec_len[..., None]
    z = (AIR_DENSITY * SPEED_OF_SOUND / a_s).to(cdtype)
    s = torch.sin(kl)
    # per section (unbind, whose backward stacks the 40 gradients at once):
    # the cos, and the B/D and A/C entries of the section's matrix
    c = torch.cos(kl).unbind(0)
    p = (1j * s / z).unbind(0)
    q = (1j * z * s).unbind(0)

    y_shunt = None
    if velum_open is not None:
        y_n = _nasal_table(int(freqs.shape[0]), float(f_max), cdtype,
                           areas.device)
        y_shunt = y_n * (_maximum(velum_open, 0.0)
                         / _NASAL_AREAS[0])[..., None].to(cdtype)

    # [A, B; C, D] <- [A, B; C, D] @ [[c, q], [p, c]] per section, the rows
    # (A, C) and (B, D) stacked
    shape = kl.shape[1:]
    ones = torch.ones(shape, dtype=cdtype, device=areas.device)
    zeros = torch.zeros(shape, dtype=cdtype, device=areas.device)
    ac = torch.stack([ones, zeros])
    bd = torch.stack([zeros, ones])
    for i in range(N_TUBE):
        ac, bd = ac * c[i] + bd * p[i], ac * q[i] + bd * c[i]
        if y_shunt is not None and i == _VELAR_JUNCTION:
            # the nasal shunt, M <- M @ [[1, 0], [Y, 1]]; the JAX scan adds
            # it at every section times (i == junction), which is this for
            # finite values
            ac = ac + bd * y_shunt

    a_lip = _maximum(areas[..., -1], min_area)[..., None]
    z_rad = _radiation_impedance(a_lip, freqs).to(cdtype)
    # |H| = 1 / |C Z_rad + D|
    denom = ac[1] * z_rad + bd[1]
    return 1.0 / _maximum(torch.abs(denom), 1e-6)


def glottal_source_magnitude(glottis, freqs):
    """Magnitude spectrum ``(..., K)`` of the glottal flow from denormalised
    glottis parameters ``(..., 11)``: -12 dB/oct above three times F0,
    amplitude the square root of the pressure, and a broadband floor."""
    f0 = _clip(glottis[..., 0], 40.0, 600.0)[..., None]
    pressure = _maximum(glottis[..., 1], 0.0)[..., None]
    amp = torch.sqrt(pressure + 1e-6)
    roll = 1.0 / (1.0 + (freqs / (3.0 * f0)) ** 2)
    return amp * (roll + 1e-3)


class SpectralForwardModel(nn.Module):
    """The predictive model of ``Paule(physical_forward=True)``: normalised
    cp ``(B, T, 30)`` -> normalised mel ``(B, T/2, 60)``.  No parameters:
    nothing to train."""

    def __init__(self, n_freqs=1 + N_FFT // 2):
        super().__init__()
        self.n_freqs = n_freqs
        self._freqs = np.linspace(0.0, SR / 2.0, n_freqs)
        self._tables = {}

    def _consts(self, like):
        """The model's constant tensors in ``like``'s dtype and device,
        made once for each."""
        key = (like.dtype, like.device)
        if key not in self._tables:
            self._tables[key] = {
                "means": _const(cp_theoretical_means, like),
                "stds": _const(cp_theoretical_stds, like),
                "freqs": _const(self._freqs, like),
                "rad": _const(self._freqs / SR, like),
                "fb": _const(mel_filterbank(), like)}
        return self._tables[key]

    def forward(self, cp_norm):
        t = self._consts(cp_norm)
        cp = cp_norm * t["stds"] + t["means"]
        tract, glottis = cp[..., :19], cp[..., 19:]
        areas, geom_sec_len = tract_to_tube(tract)
        sec_len = _clip(geom_sec_len * N_TUBE, MIN_TOTAL_LEN_CM,
                        MAX_TOTAL_LEN_CM) / N_TUBE
        h = tube_transfer_magnitude(areas, sec_len, t["freqs"],
                                    velum_open=velum_opening(tract))
        s = glottal_source_magnitude(glottis, t["freqs"])
        # the lips' radiation differentiates the flow: |P| ~ f |U|
        power = CALIBRATION_GAIN * s * h * t["rad"]
        mel = _maximum(power, 0.0) @ t["fb"]
        out = normalize_mel(amplitude_to_db(mel))
        n = out.shape[-2]
        return half_sequence(out[..., : (n // 2) * 2, :])
