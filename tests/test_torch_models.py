"""The port's model blocks, the three planning-path models and the release
reader against the JAX package.  Models run at small widths (H=16) with
parameters made by the JAX package's own init and carried across by
``params_from_jax``; float64, outputs and input gradients to 1e-8."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paule_tpu import release as JR
from paule_tpu.models import blocks as JB
from paule_tpu.models import embedder as JE
from paule_tpu.models import forward as JF
from paule_tpu.models import inverse as JI
from paule_tpu_torch import release as TR
from paule_tpu_torch.models import blocks as TB
from paule_tpu_torch.models.embedder import EmbeddingModel
from paule_tpu_torch.models.forward import ForwardModel
from paule_tpu_torch.models.inverse import InverseModelMelTimeSmoothResidual
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-8
F64 = {"device": "cpu", "dtype": torch.float64}


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def _port(module, jax_params):
    return TR.load_into(module, jax.tree.map(np.asarray, jax_params), **F64)


def _compare(apply_jax, apply_torch, x):
    """Values and the gradient of sum(sin(out) * r) with respect to x."""
    out_j = apply_jax(jnp.asarray(x))
    r = _x(np.shape(out_j), seed=99)
    g_j = jax.grad(lambda a: jnp.sum(jnp.sin(apply_jax(a)) * r))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out_t = apply_torch(xt)
    (torch.sin(out_t) * torch.tensor(r)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("groups,k", [(1, 3), (4, 5), (8, 4)])
def test_conv1d_same_padding(groups, k):
    params = JB.conv1d_init(jax.random.PRNGKey(k), 8, 8, k, groups=groups,
                            dtype=jnp.float64)
    conv = _port(TB.Conv1d(8, 8, k, groups=groups), params)
    _compare(lambda a: JB.conv1d(params, a, groups=groups), conv,
             _x((2, 11, 8)))


def test_mel_channel_conv_and_res_block():
    p_mel = JB.mel_channel_conv_init(jax.random.PRNGKey(1), 12, 3,
                                     jnp.float64)
    mel = _port(TB.MelChannelConv(12, 3), p_mel)
    _compare(lambda a: JB.mel_channel_conv(p_mel, a, filter_size_channel=3),
             mel, _x((2, 9, 12)))
    p_res = JB.time_conv_res_block_init(jax.random.PRNGKey(2), 6, 5,
                                        dtype=jnp.float64)
    res = _port(TB.TimeConvResBlock(6, 5), p_res)
    _compare(lambda a: JB.time_conv_res_block(p_res, a, channels=6), res,
             _x((1, 10, 6)))


def test_small_blocks():
    a, b = _x((2, 5, 3)), _x((2, 5, 3), seed=1)
    np.testing.assert_array_equal(
        TB.interleave_channels(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(JB.interleave_channels(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        TB.leaky_relu(torch.tensor(a)).numpy(),
        np.asarray(JB.leaky_relu(jnp.asarray(a))))
    out = _x((3, 6, 4))
    for lens in (None, [6, 1, 3], [9, 0, -2]):  # out-of-range lens clamp
        np.testing.assert_allclose(
            TB.gather_last_step(torch.tensor(out), lens).numpy(),
            np.asarray(JB.gather_last_step(jnp.asarray(out), lens)),
            rtol=0, atol=1e-12)


def test_forward_model_matches_jax():
    jm = JF.ForwardModel(num_lstm_layers=1, hidden_size=16)
    params = jm.init(jax.random.PRNGKey(3), jnp.float64)
    tm = _port(ForwardModel(num_lstm_layers=1, hidden_size=16), params)
    _compare(lambda a: jm.apply(params, a), tm, _x((1, 14, 30)) * 0.5)


def test_inverse_model_matches_jax():
    jm = JI.InverseModelMelTimeSmoothResidual(num_lstm_layers=1,
                                              hidden_size=16)
    params = jm.init(jax.random.PRNGKey(4), jnp.float64)
    tm = _port(InverseModelMelTimeSmoothResidual(num_lstm_layers=1,
                                                 hidden_size=16), params)
    _compare(lambda a: jm.apply(params, a), tm, _x((1, 9, 60)) * 0.5)


@pytest.mark.parametrize("batch", [1, 3])
def test_embedder_matches_jax(batch):
    """Two equal-H layers: the port runs them as the fused pair."""
    jm = JE.EmbeddingModel(num_lstm_layers=2, hidden_size=16)
    params = jm.init(jax.random.PRNGKey(5), jnp.float64)
    tm = _port(EmbeddingModel(num_lstm_layers=2, hidden_size=16), params)
    _compare(lambda a: jm.apply(params, a, None), tm,
             _x((batch, 8, 60)) * 0.5)


def test_release_reader_matches_jax():
    weights_j, meta_j = JR.load_release(dtype=np.float16)
    weights_t, meta_t = TR.load_release()
    assert meta_t == meta_j and TR.RELEASE_PATH == JR.release_path()
    for key in weights_j:
        flat_j = jax.tree.leaves(weights_j[key])
        flat_t = jax.tree.leaves(weights_t[key])
        assert len(flat_j) == len(flat_t)
        for a, b in zip(flat_j, flat_t):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key,model", [
    ("predictive", lambda: ForwardModel(num_lstm_layers=1, hidden_size=720)),
    ("inverse", lambda: InverseModelMelTimeSmoothResidual(
        num_lstm_layers=1, hidden_size=720)),
    ("embedder", lambda: EmbeddingModel(num_lstm_layers=2,
                                        hidden_size=720)),
])
def test_release_fills_planning_models(key, model):
    """Every parameter of the three planning models comes from the
    release (a strict load), in the JAX layout."""
    weights, _ = TR.load_release()
    module = TR.load_into(model(), weights[key], device="cpu",
                          dtype=torch.float32)
    state = TR.params_from_jax(weights[key])
    assert set(module.state_dict()) == set(state)
    for name, t in module.state_dict().items():
        np.testing.assert_array_equal(t.numpy(),
                                      state[name].numpy().astype(np.float32))
