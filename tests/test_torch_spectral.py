"""The port's physical forward model (``paule_tpu_torch/spectral.py``)
against ``paule_tpu/spectral.py`` in float64 on the CPU: the tube geometry
(also against the native synthesizer), the velum opening, the nasal
admittance table, the tube's transfer magnitude with and without the nasal
branch, the glottal source, and ``SpectralForwardModel``'s mel and its
gradient ``d(sum(w * mel)) / d cp`` against ``jax.grad``, with cp inside
the ranges, exactly on the clip bounds (where ``jnp.clip`` splits the
gradient) and beyond +-1.  Values agree to :data:`ATOL` absolutely, the
gradient to :data:`GRAD_RTOL` of its largest element (resonances make
``1 / |C Z + D|`` amplify rounding)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paule_tpu import spectral as JS
from paule_tpu_torch import spectral as TS
from paule_tpu_torch import synth
from paule_tpu_torch.ops.normalize import (cp_theoretical_means,
                                           cp_theoretical_stds,
                                           inv_normalize_cp, normalize_cp)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-10
GRAD_RTOL = 1e-9


def _tensor(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float64,
                        requires_grad=grad)


def _cps(kind, shape=(2, 10), seed=0):
    """Normalised cp ``shape + (30,)``: ``"inside"`` the ranges,
    ``"bounds"``: every tract parameter exactly on one of the speaker's
    bounds that ``tract_to_tube`` clips to (and the LP and HY values that
    ``smiling=True`` pins), ``"beyond"``: up to 1.6 past +-1."""
    rng = np.random.default_rng(seed)
    if kind == "inside":
        return np.clip(rng.normal(0, 0.4, (*shape, 30)), -0.95, 0.95)
    if kind == "beyond":
        return rng.uniform(-1.6, 1.6, (*shape, 30))
    info = synth.get_param_info("tract")
    lo = normalize_cp(np.concatenate([info["mins"], cp_theoretical_means[
        19:]]))
    hi = normalize_cp(np.concatenate([info["maxs"], cp_theoretical_means[
        19:]]))
    pick = rng.integers(0, 2, (*shape, 30)).astype(bool)
    x = np.where(pick, hi, lo)
    x[..., 19:] = rng.uniform(-0.9, 0.9, (*shape, 11))
    x[..., 4] = -1.0   # LP pinned by smiling
    x[..., 1] = 1.0    # HY pinned by smiling
    # the source's clips too: F0 at 40 Hz, pressure at 0
    x[0, 0, 19:21] = normalize_cp(np.r_[np.zeros(19), 40.0, 0.0,
                                        np.zeros(9)])[19:21]
    return x


def test_bounds_cp_lies_on_the_clip_bounds():
    info = synth.get_param_info("tract")
    tract = inv_normalize_cp(_cps("bounds"))[..., :19]
    on = np.isclose(tract, info["mins"], rtol=0, atol=1e-12) | np.isclose(
        tract, info["maxs"], rtol=0, atol=1e-12)
    assert on.all()
    # and exactly: tract_to_tube's clip does not move them
    q = np.clip(tract, info["mins"], info["maxs"])
    assert (q == tract).mean() > 0.9


@pytest.mark.parametrize("kind", ["inside", "bounds", "beyond"])
def test_tract_to_tube_and_velum_match_jax(kind):
    tract = inv_normalize_cp(_cps(kind))[..., :19]
    areas, sec = TS.tract_to_tube(_tensor(tract))
    ref_areas, ref_sec = JS.tract_to_tube_jax(jnp.asarray(tract))
    np.testing.assert_allclose(areas.numpy(), ref_areas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(sec.numpy(), ref_sec, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        TS.velum_opening(_tensor(tract)).numpy(),
        JS.velum_opening_jax(jnp.asarray(tract)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["inside", "bounds"])
def test_tract_to_tube_gradient_matches_jax(kind):
    """Through the clips at the bounds: the half-and-half split of a tie."""
    tract = inv_normalize_cp(_cps(kind))[..., :19]
    w = np.random.default_rng(5).normal(size=(2, 10, 40))

    def jloss(t):
        areas, sec = JS.tract_to_tube_jax(t)
        return (jnp.sum(jnp.asarray(w) * areas) + jnp.sum(sec)
                + jnp.sum(JS.velum_opening_jax(t)))

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(tract)))
    t = _tensor(tract, grad=True)
    areas, sec = TS.tract_to_tube(t)
    (torch.sum(_tensor(w) * areas) + sec.sum()
     + TS.velum_opening(t).sum()).backward()
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0,
                               atol=GRAD_RTOL * np.abs(ref).max())


def test_tract_to_tube_matches_the_native_synthesizer():
    """As ``tests/test_spectral.py:21`` holds the JAX function."""
    rng = np.random.default_rng(0)
    for _ in range(8):
        dn = inv_normalize_cp(np.clip(rng.normal(0, 0.4, (1, 30)), -1, 1))[0]
        _tl, ta, *_ = synth.tract_to_tube(dn[:19])
        areas, _sec = TS.tract_to_tube(_tensor(dn[:19]))
        np.testing.assert_allclose(areas.numpy(), ta, atol=1e-5)


def test_nasal_table_is_rounded_as_in_jax():
    y = TS.nasal_input_admittance(513, 22050.0)
    ref = JS.nasal_input_admittance(513, 22050.0)
    assert y.dtype == np.complex64
    np.testing.assert_array_equal(y, ref)
    # the table enters the working dtype from complex64
    t = TS._nasal_table(513, 22050.0, torch.complex128, torch.device("cpu"))
    np.testing.assert_array_equal(t.numpy(), ref.astype(np.complex128))


@pytest.mark.parametrize("velum", [False, True])
def test_transfer_magnitude_matches_jax(velum):
    rng = np.random.default_rng(3)
    areas = rng.uniform(0.0, 5.0, (3, 40))
    areas[0, 5] = 0.0   # below min_area
    sec = rng.uniform(0.3, 0.5, 3)
    vo = np.array([0.0, 0.3, 1.0])
    freqs = np.linspace(0.0, 22050.0, 129)
    kw_t = {"velum_open": _tensor(vo)} if velum else {}
    kw_j = {"velum_open": jnp.asarray(vo)} if velum else {}
    out = TS.tube_transfer_magnitude(_tensor(areas), _tensor(sec),
                                     _tensor(freqs), **kw_t)
    ref = np.asarray(JS.tube_transfer_magnitude(
        jnp.asarray(areas), jnp.asarray(sec), jnp.asarray(freqs), **kw_j))
    assert out.shape == (3, 129)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=0)


def test_glottal_source_matches_jax():
    rng = np.random.default_rng(4)
    glottis = rng.uniform(-50.0, 700.0, (2, 5, 11))
    glottis[0, 0, :2] = (40.0, 0.0)   # on the clips
    freqs = np.linspace(0.0, 22050.0, 65)
    w = rng.normal(size=(2, 5, 65))
    g = _tensor(glottis, grad=True)
    out = TS.glottal_source_magnitude(g, _tensor(freqs))
    (out * _tensor(w)).sum().backward()
    ref, ref_grad = jax.value_and_grad(lambda x: jnp.sum(
        JS.glottal_source_magnitude(x, jnp.asarray(freqs)) * w))(
            jnp.asarray(glottis))
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(JS.glottal_source_magnitude(jnp.asarray(glottis),
                                               jnp.asarray(freqs))),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(g.grad.numpy(), ref_grad, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["inside", "bounds", "beyond"])
def test_spectral_forward_model_and_gradient_match_jax(kind):
    """The mel ``(2, 5, 60)`` and ``d(sum(w * mel)) / d cp``."""
    x = _cps(kind)
    w = np.random.default_rng(6).normal(size=(2, 5, 60))
    jmodel = JS.SpectralForwardModel()
    ref = np.asarray(jmodel.apply({}, jnp.asarray(x)))
    ref_grad = np.asarray(jax.grad(lambda c: jnp.sum(
        jnp.asarray(w) * jmodel.apply({}, c)))(jnp.asarray(x)))
    model = TS.SpectralForwardModel()
    assert list(model.parameters()) == [] and model.state_dict() == {}
    xt = _tensor(x, grad=True)
    out = model(xt)
    (_tensor(w) * out).sum().backward()
    assert out.shape == (2, 5, 60)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), ref_grad, rtol=0,
                               atol=GRAD_RTOL * np.abs(ref_grad).max())


def test_odd_length_and_float32():
    """An odd number of frames drops the last one, as in JAX; float32 runs
    in complex64 and stays within float32 rounding of float64."""
    x = _cps("inside", shape=(1, 9))
    model = TS.SpectralForwardModel()
    out64 = model(_tensor(x))
    assert out64.shape == (1, 4, 60)
    out32 = model(torch.tensor(x, dtype=torch.float32))
    assert out32.dtype == torch.float32
    np.testing.assert_allclose(out32.numpy(), out64.numpy(), rtol=0,
                               atol=1e-3)
    assert np.isfinite(cp_theoretical_stds).all()
