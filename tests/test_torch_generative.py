"""The port's batch norm, linear upsampling and ``Generator`` against the
JAX package in float64 on the CPU; the generators carry the release's
``cp_gan`` and ``mel_gan`` trees at full width."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paule_tpu import release as JR
from paule_tpu.models import blocks as JB
from paule_tpu.models import generative as JG
from paule_tpu_torch import release as TR
from paule_tpu_torch.models import blocks as TB
from paule_tpu_torch.models.generative import Generator
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: blocks: the same float64 operations on both sides
ATOL = 1e-12
#: the generator at full width: five convolutions of 256 channels summed in
#: another order; the measured difference is below 1e-14
GEN_ATOL = 1e-10
F64 = {"device": "cpu", "dtype": torch.float64}


@pytest.fixture(scope="module")
def release():
    weights, _meta = JR.load_release()
    return {k: jax.tree.map(lambda a: np.asarray(a, np.float64), weights[k])
            for k in ("cp_gan", "mel_gan")}


def _jit_apply(jgen):
    """The JAX generator's apply as one compiled program (eagerly, each of
    its operations compiles on its own, ~10 times slower)."""
    return jax.jit(jgen.apply, static_argnums=2)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def test_batchnorm_matches_jax():
    rng = np.random.default_rng(1)
    params = {"scale": rng.normal(size=7), "bias": rng.normal(size=7),
              "mean": rng.normal(size=7), "var": rng.uniform(0.1, 2.0, 7)}
    x = _x((3, 9, 7))
    bn = TR.load_into(TB.BatchNorm(7), params, **F64).eval()
    assert {n for n, _ in bn.named_buffers()} == {"mean", "var"}
    np.testing.assert_allclose(
        bn(torch.tensor(x)).detach().numpy(),
        np.asarray(JB.batchnorm(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(x))), rtol=0, atol=ATOL)


@pytest.mark.parametrize("t,size", [(4, 8), (4, 13), (13, 40), (40, 67),
                                    (67, 201), (9, 4), (5, 5)])
def test_upsample_linear_matches_jax(t, size):
    """Integer and non-integer ratios, down-sampling and ``t == size``."""
    x = _x((2, t, 3))
    out = TB.upsample_linear(torch.tensor(x), size)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(JB.upsample_linear(jnp.asarray(x), size)),
        rtol=0, atol=ATOL)
    assert out.shape == (2, size, 3)


@pytest.mark.parametrize("key,out_size", [("cp_gan", 30), ("mel_gan", 60)])
@pytest.mark.parametrize("length", [12, 41, 201])
@pytest.mark.parametrize("batch", [1, 3])
def test_generator_matches_jax(release, key, out_size, length, batch):
    tree = release[key]
    noise = _x((batch, 1, 100), seed=length)
    semvec = _x((batch, 300), seed=length + 1) * 0.3
    ref = _jit_apply(JG.Generator(output_size=out_size))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(noise), length,
        jnp.asarray(semvec))
    gen = TR.load_into(Generator(output_size=out_size), tree, **F64).eval()
    with torch.no_grad():
        out = gen(torch.tensor(noise), length, torch.tensor(semvec))
    assert out.shape == (batch, length, out_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=GEN_ATOL)


def test_generator_block0_residual_rule():
    """Block 0 adds its input only when it has ``hidden_size`` channels:
    ``fc_size=1024`` over 4 steps gives 256 channels, as many as the hidden
    size, so it does; at ``hidden_size=128`` it does not."""
    for hidden in (256, 128):
        jgen = JG.Generator(hidden_size=hidden, num_res_blocks=2)
        params = jgen.init(jax.random.PRNGKey(hidden), jnp.float64)
        gen = TR.load_into(Generator(hidden_size=hidden, num_res_blocks=2),
                           jax.tree.map(np.asarray, params), **F64).eval()
        noise, semvec = _x((2, 1, 100), 3), _x((2, 300), 4)
        with torch.no_grad():
            out = gen(torch.tensor(noise), 10, torch.tensor(semvec))
        ref = _jit_apply(jgen)(params, jnp.asarray(noise), 10,
                               jnp.asarray(semvec))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=GEN_ATOL)


def test_random_init_is_seeded():
    """``init_random`` draws from the generator it is given: one seed, one
    set of values, on every call."""
    def make(seed):
        gen = Generator(output_size=60).to(torch.float64)
        return TB.init_random(gen, torch.Generator().manual_seed(seed))

    a, b, c = make(3), make(3), make(4)
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        if name.endswith(("w", ".b")):
            assert not torch.equal(pa, pc), name
    bn = a.blocks[0].bn
    assert torch.equal(bn.var, torch.ones(256, dtype=torch.float64))
