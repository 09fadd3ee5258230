"""The port's LSTM recurrences against the JAX package.

* the plain versions, through ``paule_tpu_torch.ops.lstm``, against
  ``paule_tpu.ops.lstm`` (``lax.scan`` path) in float64: values and input
  and weight gradients to 1e-10;
* the plain versions inside the port's ``autograd.Function``s against the
  Pallas kernels ``lstm_core`` / ``lstm_stack2_core`` run in Pallas
  interpret mode in float32, including losses that read ``c_T`` and
  ``hs1``, whose cotangents both contracts drop: 2e-5 absolute forward,
  1e-4 relative gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paule_tpu.ops import lstm as JLS
from paule_tpu.ops import pallas_lstm as PL
from paule_tpu_torch.ops import lstm as TLS
from paule_tpu_torch.ops import lstm_kernels as K
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL64 = 1e-10


def _layer(rng, n_in, hidden):
    s = hidden ** -0.5
    return {"w_ih": rng.uniform(-s, s, (n_in, 4 * hidden)),
            "w_hh": rng.uniform(-s, s, (hidden, 4 * hidden)),
            "b": rng.uniform(-s, s, (4 * hidden,))}


def _to_torch(tree, dtype=torch.float64):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, dtype) for v in tree]
    return torch.tensor(np.asarray(tree), dtype=dtype, requires_grad=True)


def _grads_torch(tree):
    if isinstance(tree, dict):
        return {k: _grads_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads_torch(v) for v in tree]
    return tree.grad.numpy()


def _assert_trees_close(a, b, **tol):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol)


@pytest.mark.parametrize("batch,seq", [(1, 5), (3, 9)])
def test_lstm_layer_matches_jax_scan(batch, seq):
    rng = np.random.default_rng(batch)
    params = _layer(rng, 4, 6)
    x = rng.normal(size=(batch, seq, 4))
    h0 = rng.normal(size=(batch, 6)) * 0.3
    c0 = rng.normal(size=(batch, 6)) * 0.3
    r = rng.normal(size=(batch, seq, 6))

    def loss_jax(p, xx, h, c):
        out, (h_t, _c_t) = JLS.lstm_layer(p, xx, h, c)
        return jnp.sum(jnp.sin(out) * r) + jnp.sum(h_t)

    vj = loss_jax(params, x, h0, c0)
    gj = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(params, x, h0, c0)

    pt = _to_torch(params)
    xt, ht, ct = (_to_torch(a) for a in (x, h0, c0))
    out, (h_t, _c_t) = TLS.lstm_layer(pt, xt, ht, ct)
    vt = (torch.sin(out) * torch.tensor(r)).sum() + h_t.sum()
    vt.backward()
    np.testing.assert_allclose(vt.item(), float(vj), rtol=0, atol=ATOL64)
    _assert_trees_close(_grads_torch(pt), gj[0], rtol=0, atol=ATOL64)
    for t, g in zip((xt, ht, ct), gj[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=ATOL64)


@pytest.mark.parametrize("sizes", [(6,), (6, 6), (6, 6, 6)])
def test_lstm_stack_matches_jax_scan(sizes):
    """Equal-H pairs take the fused stack-2 contract, other layers the
    single-layer one; values, final states and grads match the scan."""
    rng = np.random.default_rng(len(sizes))
    layers = [_layer(rng, 4 if i == 0 else sizes[i - 1], h)
              for i, h in enumerate(sizes)]
    x = rng.normal(size=(2, 7, 4))
    r = rng.normal(size=(2, 7, sizes[-1]))

    def loss_jax(p, xx):
        return jnp.sum(jnp.sin(JLS.lstm(p, xx)[0]) * r)

    out_j, (hn_j, cn_j) = JLS.lstm(layers, x)
    gj = jax.grad(loss_jax, argnums=(0, 1))(layers, x)

    pt = _to_torch(layers)
    xt = _to_torch(x)
    out_t, (hn_t, cn_t) = TLS.lstm(pt, xt)
    (torch.sin(out_t) * torch.tensor(r)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=ATOL64)
    np.testing.assert_allclose(hn_t.detach().numpy(), np.asarray(hn_j),
                               rtol=0, atol=ATOL64)
    np.testing.assert_allclose(cn_t.detach().numpy(), np.asarray(cn_j),
                               rtol=0, atol=ATOL64)
    _assert_trees_close(_grads_torch(pt), gj[0], rtol=0, atol=ATOL64)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj[1]), rtol=0,
                               atol=ATOL64)


# ---------------------------------------------------------------------------
# the kernels' contracts against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(PL, "INTERPRET", True)
    chunked = lambda seq, batch, hidden, words: (min(4, seq), None)  # noqa
    monkeypatch.setattr(PL, "_vmem_plan", chunked)
    monkeypatch.setattr(PL, "_vmem_plan2", chunked)


def _f32(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _assert_grads(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b) + 1e-7


def test_lstm_core_contract_matches_pallas(interpret):
    rng = np.random.default_rng(7)
    seq, batch, hidden = 6, 2, 8
    gx = _f32(rng, (seq, batch, 4 * hidden), 0.5)
    w = _f32(rng, (hidden, 4 * hidden), hidden ** -0.5)
    h0 = _f32(rng, (batch, hidden), 0.2)
    c0 = _f32(rng, (batch, hidden), 0.2)
    r = _f32(rng, (seq, batch, hidden))
    rc = _f32(rng, (batch, hidden))

    def loss_jax(*args):
        hs, cs = PL.lstm_core(*args)
        # c_T is read, but its cotangent is dropped by the contract
        return jnp.sum(jnp.sin(hs) * r) + jnp.sum(cs[-1] * rc)

    hs_j, cs_j = PL.lstm_core(gx, w, h0, c0)
    gj = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(gx, w, h0, c0)

    leaves = [torch.tensor(a, requires_grad=True) for a in (gx, w, h0, c0)]
    hs_t, cs_t = K.LSTMCore.apply(*leaves)
    ((torch.sin(hs_t) * torch.tensor(r)).sum()
     + (cs_t[-1] * torch.tensor(rc)).sum()).backward()
    np.testing.assert_allclose(hs_t.detach().numpy(), np.asarray(hs_j),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(cs_t.detach().numpy(), np.asarray(cs_j),
                               rtol=0, atol=2e-5)
    for t, g in zip(leaves, gj):
        _assert_grads(t.grad.numpy(), g)


def test_lstm_stack2_contract_matches_pallas(interpret):
    rng = np.random.default_rng(8)
    seq, batch, hidden = 7, 2, 8
    g1 = _f32(rng, (seq, batch, 4 * hidden), 0.5)
    w1 = _f32(rng, (hidden, 4 * hidden), hidden ** -0.5)
    w2 = _f32(rng, (2 * hidden, 4 * hidden), hidden ** -0.5)
    b2 = _f32(rng, (4 * hidden,), 0.1)
    z = np.zeros((batch, hidden), np.float32)
    r2 = _f32(rng, (seq, batch, hidden))
    r1 = _f32(rng, (seq, batch, hidden))
    rc = _f32(rng, (batch, hidden))

    def loss_jax(*args):
        hs1, cs1, hs2, cs2 = PL.lstm_stack2_core(*args, z, z, z, z)
        # hs1 and the cell states are read; only hs2's cotangent flows
        return (jnp.sum(jnp.sin(hs2) * r2) + jnp.sum(hs1 * r1)
                + jnp.sum((cs1[-1] + cs2[-1]) * rc))

    outs_j = PL.lstm_stack2_core(g1, w1, w2, b2, z, z, z, z)
    gj = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(g1, w1, w2, b2)

    leaves = [torch.tensor(a, requires_grad=True) for a in (g1, w1, w2, b2)]
    zt = [torch.tensor(z, requires_grad=True) for _ in range(4)]
    hs1, cs1, hs2, cs2 = K.LSTMStack2.apply(*leaves, *zt)
    ((torch.sin(hs2) * torch.tensor(r2)).sum()
     + (hs1 * torch.tensor(r1)).sum()
     + ((cs1[-1] + cs2[-1]) * torch.tensor(rc)).sum()).backward()
    for a, b in zip((hs1, cs1, hs2, cs2), outs_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=2e-5)
    for t, g in zip(leaves, gj):
        _assert_grads(t.grad.numpy(), g)
    for t in zt:  # initial-carry grads are zeros, as in the JAX contract
        assert not t.grad.abs().any()


def test_plain_backward_matches_autograd_of_plain_forward():
    """The reverse recurrences (B2, B4) equal autograd through the forward
    step loops (B1, B3), in float64."""
    rng = np.random.default_rng(9)
    seq, batch, hidden = 5, 3, 4
    gx, w, w2 = (torch.tensor(rng.normal(size=s) * 0.5, requires_grad=True)
                 for s in ((seq, batch, 4 * hidden), (hidden, 4 * hidden),
                           (2 * hidden, 4 * hidden)))
    b2 = torch.tensor(rng.normal(size=4 * hidden) * 0.1, requires_grad=True)
    h0, c0 = (torch.tensor(rng.normal(size=(batch, hidden)) * 0.2,
                           requires_grad=True) for _ in range(2))
    r = torch.tensor(rng.normal(size=(seq, batch, hidden)))

    def both(fn):
        leaves = (gx, w, w2, b2, h0, c0)
        for t in leaves:
            t.grad = None
        fn().backward()
        return [None if t.grad is None else t.grad.clone() for t in leaves]

    a = both(lambda: (K.LSTMCore.apply(gx, w, h0, c0)[0] * r).sum())
    b = both(lambda: (K.lstm_fwd_plain(gx, w, h0, c0)[0] * r).sum())
    for x, y in zip(a, b):
        if y is not None:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                       atol=1e-12)
    z = torch.zeros(batch, hidden, dtype=torch.float64)
    a = both(lambda: (K.LSTMStack2.apply(gx, w, w2, b2, z, z, z, z)[2]
                      * r).sum())
    b = both(lambda: (K.lstm_stack2_fwd_plain(gx, w, w2, b2, z, z, z, z)[2]
                      * r).sum())
    for x, y in zip(a[:4], b[:4]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-12)


def test_cpu_tensors_take_the_plain_version():
    K.reset_launch_counts()
    gx = torch.zeros(3, 1, 8)
    w = torch.zeros(2, 8)
    h = torch.zeros(1, 2)
    hs, cs = K.lstm_fwd(gx, w, h, h)
    assert hs.shape == (3, 1, 2) and not hs.any()
    assert all(k.launches == 0 for k in K.KERNELS)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel path, whose checks refuse a
    dtype the kernels do not take before anything is built or launched."""
    meta = dict(device="meta", dtype=torch.float64)
    gx = torch.empty(3, 1, 8, **meta)
    w = torch.empty(2, 8, **meta)
    h = torch.empty(1, 2, **meta)
    with pytest.raises(TypeError, match="float32"):
        K.lstm_fwd(gx, w, h, h)
    with pytest.raises(TypeError, match="float32"):
        K.lstm_bwd(gx, torch.empty(3, 1, 2, **meta),
                   torch.empty(3, 1, 2, **meta), w)
    f32 = dict(device="meta", dtype=torch.float32)
    strided = torch.empty(3, 1, 16, **f32)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        K.lstm_fwd(strided, torch.empty(2, 8, **f32),
                   torch.empty(1, 2, **f32), torch.empty(1, 2, **f32))
    with pytest.raises(ValueError, match="shape"):
        K.lstm_stack2_fwd(torch.empty(3, 1, 8, **f32),
                          torch.empty(2, 8, **f32), torch.empty(2, 8, **f32),
                          torch.empty(8, **f32),
                          *[torch.empty(1, 2, **f32)] * 4)
    assert all(k.launches == 0 for k in K.KERNELS)


def test_dropout_only_between_layers():
    rng = np.random.default_rng(10)
    x = torch.tensor(rng.normal(size=(2, 5, 4)))
    one = [_to_torch(_layer(rng, 4, 6))]
    two = one + [_to_torch(_layer(rng, 6, 6))]
    gen = torch.Generator().manual_seed(0)
    for layers, changes in ((one, False), (two, True)):
        with torch.no_grad():
            ref = TLS.lstm(layers, x)[0]
            out = TLS.lstm(layers, x, dropout=0.5, training=True,
                           generator=gen)[0]
            ev = TLS.lstm(layers, x, dropout=0.5, training=False)[0]
        assert torch.equal(ev, ref)
        assert (not torch.equal(out, ref)) == changes


@pytest.mark.parametrize("sizes", [(12, 12), (12, 12, 12)])
def test_dropout_with_jax_keep_masks_matches_jax(sizes):
    """``lstm(..., dropout=0.7, training=True)`` given the keep masks that
    ``paule_tpu.ops.lstm.lstm(..., deterministic=False, rng=key)`` draws
    (one ``split`` of the key per layer boundary) gives JAX's output and
    gradients."""
    rng = np.random.default_rng(11)
    layers = [_layer(rng, n_in, h)
              for n_in, h in zip((10,) + sizes[:-1], sizes)]
    x = rng.normal(size=(2, 7, 10))
    key = jax.random.PRNGKey(5)

    def loss_j(params, xs):
        out, _ = JLS.lstm(params, xs, dropout=0.7, deterministic=False,
                          rng=key)
        return jnp.sum(jnp.sin(out)), out

    (_, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        jax.tree.map(jnp.asarray, layers), jnp.asarray(x))
    masks, k = [], key
    for h in sizes[:-1]:
        k, sub = jax.random.split(k)
        masks.append(torch.tensor(np.asarray(
            jax.random.bernoulli(sub, 0.3, (2, 7, h)))))

    params = _to_torch(layers)
    out, _ = TLS.lstm(params, torch.tensor(x), dropout=0.7, training=True,
                      keep_masks=masks)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=ATOL64)
    _assert_trees_close(_grads_torch(params), grads_j, rtol=0, atol=ATOL64)
    assert any(not m.all() for m in masks)


def test_dropout_draws_on_the_inputs_device():
    """In training, dropout needs a generator on the input's device (or
    given masks): no mask is drawn elsewhere and copied over."""
    rng = np.random.default_rng(12)
    layers = [_to_torch(_layer(rng, 4, 6)), _to_torch(_layer(rng, 6, 6))]
    x = torch.tensor(rng.normal(size=(1, 5, 4)))
    with pytest.raises(ValueError, match="generator"):
        TLS.lstm(layers, x, dropout=0.5, training=True)
    gen = torch.Generator(device="cpu").manual_seed(1)
    a = TLS.lstm(layers, x, dropout=0.5, training=True, generator=gen)[0]
    gen.manual_seed(1)
    b = TLS.lstm(layers, x, dropout=0.5, training=True, generator=gen)[0]
    assert torch.equal(a, b)
