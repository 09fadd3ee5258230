"""paule_tpu_torch.ops (normalisation, derivatives, losses) against the JAX
package: the same numpy inputs, values and gradients in float64, to
1e-10 absolute."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paule_tpu.ops import derivatives as JD
from paule_tpu.ops import losses as JL
from paule_tpu.ops import normalize as JN
from paule_tpu_torch.ops import derivatives as TD
from paule_tpu_torch.ops import losses as TL
from paule_tpu_torch.ops import normalize as TN
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-10


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def _value_and_grad_jax(fn, x, r):
    def loss(a):
        return jnp.sum(fn(a) * r)
    val = fn(jnp.asarray(x))
    return np.asarray(val), np.asarray(jax.grad(loss)(jnp.asarray(x)))


def _value_and_grad_torch(fn, x, r):
    xt = torch.tensor(x, requires_grad=True)
    val = fn(xt)
    (val * torch.tensor(r)).sum().backward()
    return val.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("name", ["five_point_stencil", "local_linear",
                                  "add_vel_and_acc_info", "double_sequence",
                                  "half_sequence"])
def test_derivatives_match_jax(name):
    x = _x((2, 12, 3))
    out_shape = np.asarray(getattr(JD, name)(jnp.asarray(x))).shape
    r = _x(out_shape, seed=1)
    vj, gj = _value_and_grad_jax(getattr(JD, name), x, r)
    vt, gt = _value_and_grad_torch(getattr(TD, name), x, r)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=ATOL)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=ATOL)


def test_vel_acc_jerk_matches_jax():
    x = _x((1, 20, 4))
    for a, b in zip(TD.vel_acc_jerk(torch.tensor(x)),
                    JD.vel_acc_jerk(jnp.asarray(x))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)


def test_half_sequence_rejects_odd_length():
    with pytest.raises(ValueError):
        TD.half_sequence(torch.zeros(1, 5, 2))


def _loss_cases():
    return {
        "mse": (lambda m, a, b: m.mse(a, b)),
        "rmse": (lambda m, a, b: m.rmse(a, b)),
        "vel_jerk_mse": (lambda m, a, b: sum(
            m.velocity_jerk_loss(a, loss=m.mse))),
        "vel_jerk_rmse": (lambda m, a, b: sum(m.velocity_jerk_loss(a))),
        "vel_jerk_guided": (lambda m, a, b: sum(
            m.velocity_jerk_loss(a, guiding_factor=0.5))),
        "local_linear_loss": (lambda m, a, b: m.local_linear_loss(a)),
    }


@pytest.mark.parametrize("name", sorted(_loss_cases()))
def test_losses_match_jax(name):
    fn = _loss_cases()[name]
    a = _x((1, 30, 30))
    b = _x((1, 30, 30), seed=2)
    vj, gj = jax.value_and_grad(lambda u: fn(JL, u, jnp.asarray(b)))(
        jnp.asarray(a))
    at = torch.tensor(a, requires_grad=True)
    vt = fn(TL, at, torch.tensor(b))
    vt.backward()
    np.testing.assert_allclose(vt.item(), float(vj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=ATOL)


def test_guiding_factor_range():
    with pytest.raises(ValueError):
        TL.velocity_jerk_loss(torch.zeros(1, 20, 2), guiding_factor=1.5)


def test_normalization_tables_match_jax():
    np.testing.assert_array_equal(TN.CP_RANGES, JN.CP_RANGES)
    np.testing.assert_array_equal(TN.cp_theoretical_means,
                                  JN.cp_theoretical_means)
    np.testing.assert_array_equal(TN.cp_theoretical_stds,
                                  JN.cp_theoretical_stds)
    assert TN.mel_mean == JN.mel_mean and TN.mel_std == JN.mel_std
    assert (TN.N_TRACT, TN.N_GLOTTIS, TN.N_CP) == (JN.N_TRACT, JN.N_GLOTTIS,
                                                   JN.N_CP)


@pytest.mark.parametrize("name", ["normalize_cp", "inv_normalize_cp",
                                  "normalize_mel", "inv_normalize_mel"])
def test_normalize_functions_match_jax(name):
    x = _x((7, 30) if "cp" in name else (7, 60))
    ref = getattr(JN, name)(x)
    np.testing.assert_allclose(getattr(TN, name)(x), ref, rtol=0, atol=ATOL)
    out = getattr(TN, name)(torch.tensor(x))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
