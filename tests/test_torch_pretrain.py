"""``paule_tpu_torch.pretrain`` against ``paule_tpu.pretrain`` in float64 on
the CPU, on a babbled corpus of 10 utterances of 20-28 cp frames (as
``tests/test_pretrain.py``) with random semvecs and tube columns: the
babbled trajectories bit for bit and their mels to 1e-10; forward,
inverse and embedder training (mixed lengths, with and without
``exact_batch_only``) and WGAN-GP training with JAX's random draws
replayed, epoch losses and parameters (with the batch norms' running
statistics) to 1e-8 relative; and a double backward through the LSTM
kernels' autograd functions raises."""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from paule_tpu import pretrain as JP
from paule_tpu.models import embedder as JE
from paule_tpu.models import forward as JF
from paule_tpu.models import generative as JG
from paule_tpu.models import inverse as JI
from paule_tpu_torch import pretrain as TP
from paule_tpu_torch.models import (Critic, EmbeddingModel, ForwardModel,
                                    Generator,
                                    InverseModelMelTimeSmoothResidual,
                                    LSTMCritic)
from paule_tpu_torch.models.blocks import init_random
from paule_tpu_torch.ops import lstm_kernels as K
from paule_tpu_torch.release import load_into, params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-8
F64 = {"device": "cpu", "dtype": torch.float64}


@pytest.fixture(scope="module")
def corpora():
    """The JAX package's DataFrame and the port's dict of the same babble
    (same seed), with the same semvec and tube columns added."""
    ref = JP.babble_corpus(10, seq_len=(20, 28), seed=1, n_workers=2)
    out = TP.babble_corpus(10, seq_len=(20, 28), seed=1, n_workers=2, **F64)
    rng = np.random.default_rng(2)
    vecs = [rng.normal(0, 0.3, 300) for _ in range(10)]
    tubes = [rng.normal(0, 0.5, (len(c), 10)) for c in ref["cp_norm"]]
    ref["vector"], ref["tube_norm"] = vecs, tubes
    out = dict(out, vector=vecs, tube_norm=tubes)
    return ref, out


def test_random_cp_trajectory_is_bit_for_bit():
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    for n, scale in ((40, 0.05), (7, 0.03)):
        np.testing.assert_array_equal(
            TP.random_cp_trajectory(a, n, walk_scale=scale),
            JP.random_cp_trajectory(b, n, walk_scale=scale))
    assert a.random() == b.random()


def test_babble_corpus_matches_jax(corpora):
    ref, out = corpora
    assert list(out) == ["cp_norm", "melspec_norm_synthesized", "vector",
                         "segment_data", "tube_norm"]
    assert out["segment_data"] == [False] * 10
    for a, b in zip(out["cp_norm"], ref["cp_norm"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(out["melspec_norm_synthesized"],
                    ref["melspec_norm_synthesized"]):
        assert a.shape == (len(b), 60)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-10)
    # the dict of columns is the JAX package's frame
    frame = pd.DataFrame(TP.babble_corpus(2, seq_len=(20, 24), seed=3,
                                          **F64))
    assert list(frame.columns) == list(JP.babble_corpus(
        2, seq_len=(20, 24), seed=3).columns)


def _close(out, ref, what):
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=1e-12,
                               err_msg=what)


def _assert_module_matches(module, tree, what):
    ref = params_from_jax(jax.tree.map(np.asarray, tree))
    state = module.state_dict()
    assert ref.keys() == state.keys()
    for name, v in ref.items():
        _close(state[name].numpy(), v.numpy(), f"{what}: {name}")


def _pair(jmodel, tmodel, key=0):
    params = jmodel.init(jax.random.PRNGKey(key), jnp.float64)
    return params, load_into(tmodel, jax.tree.map(np.asarray, params), **F64)


@pytest.mark.parametrize("kind,batch_size,exact", [
    ("forward", 4, False), ("forward", 2, True), ("inverse", 4, False)])
def test_supervised_training_matches_jax(corpora, kind, batch_size, exact):
    """Mixed lengths: padded leftover batches, or (``exact_batch_only``)
    only the full batches of equal length; ``progress`` after each
    epoch."""
    ref, out = corpora
    if kind == "forward":
        params, model = _pair(JF.ForwardModel(num_lstm_layers=1,
                                              hidden_size=8),
                              ForwardModel(num_lstm_layers=1, hidden_size=8))
        j_fn, t_fn = JP.train_forward, TP.train_forward
        jm = JF.ForwardModel(num_lstm_layers=1, hidden_size=8)
    else:
        params, model = _pair(
            JI.InverseModelMelTimeSmoothResidual(num_lstm_layers=1,
                                                 hidden_size=8),
            InverseModelMelTimeSmoothResidual(num_lstm_layers=1,
                                              hidden_size=8))
        j_fn, t_fn = JP.train_inverse, TP.train_inverse
        jm = JI.InverseModelMelTimeSmoothResidual(num_lstm_layers=1,
                                                  hidden_size=8)
    kw = dict(batch_size=batch_size, n_epochs=2, seed=5,
              exact_batch_only=exact)
    new_params, ref_losses = j_fn(jm, params, ref, **kw)
    seen = []
    model, losses = t_fn(model, out, progress=seen.append, **kw)
    assert seen == [0, 1] and not model.training
    _close(losses, ref_losses, "epoch losses")
    _assert_module_matches(model, new_params, kind)


@pytest.mark.parametrize("column,dropout,batch_size,exact", [
    ("melspec_norm_synthesized", 0.0, 4, False),
    ("melspec_norm_synthesized", 0.0, 2, True), ("tube_norm", 0.7, 4, False)])
def test_train_embedder_matches_jax(corpora, column, dropout, batch_size,
                                    exact):
    """Two layers (the fused pair); with ``dropout=0.7`` the forward still
    runs without dropout, as JAX trains the embedder deterministically."""
    ref, out = corpora
    n_in = 60 if column == "melspec_norm_synthesized" else 10
    kw = dict(input_size=n_in, num_lstm_layers=2, hidden_size=6,
              dropout=dropout)
    jm = JE.EmbeddingModel(**kw)
    params, model = _pair(jm, EmbeddingModel(**kw))
    model.train()
    fit = dict(batch_size=batch_size, n_epochs=2, seed=6,
               input_column=column, exact_batch_only=exact)
    new_params, ref_losses = JP.train_embedder(jm, params, ref, **fit)
    model, losses = TP.train_embedder(model, out, **fit)
    _close(losses, ref_losses, "epoch losses")
    _assert_module_matches(model, new_params, "embedder")
    assert not any(p.requires_grad for p in model.parameters())


class JaxDraws:
    """``train_gan``'s draws as ``paule_tpu.pretrain.train_gan`` makes
    them: per batch ``key, k1, k2 = split(key, 3)`` for the critic's noise
    and mixing weights, and ``key, k3 = split(key)`` for a generator
    step's noise."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.k2 = None

    def __call__(self, what, shape):
        if what == "critic_noise":
            self.key, k1, self.k2 = jax.random.split(self.key, 3)
            return np.array(jax.random.normal(k1, shape, jnp.float64))
        if what == "eps":
            return np.array(jax.random.uniform(self.k2, shape,
                                                 jnp.float64))
        self.key, k3 = jax.random.split(self.key)
        return np.array(jax.random.normal(k3, shape, jnp.float64))


@pytest.mark.parametrize("column,out_size,exact", [
    ("cp_norm", 30, False), ("melspec_norm_synthesized", 60, True)])
def test_train_gan_matches_jax(corpora, column, out_size, exact):
    """Both trees, the batch norms' running statistics (adopted from the
    critic's and the generator's train-mode forwards) and the per-epoch
    (critic, generator) losses; one generator step every two batches."""
    ref, out = corpora
    gkw = dict(fc_size=64, hidden_size=8, num_res_blocks=2,
               output_size=out_size)
    ckw = dict(input_size=out_size, hidden_size=8, num_res_blocks=2)
    jg, jc = JG.Generator(**gkw), JG.Critic(**ckw)
    gp, gen = _pair(jg, Generator(**gkw), key=0)
    cp, cri = _pair(jc, Critic(**ckw), key=1)
    kw = dict(data_column=column, batch_size=2 if exact else 4, n_epochs=2,
              n_critic=2, seed=3, exact_batch_only=exact)
    gp2, cp2, ref_losses = JP.train_gan(jg, gp, jc, cp, ref, **kw)
    gen, cri, losses = TP.train_gan(gen, cri, out, draw=JaxDraws(3), **kw)
    _close(np.array(losses), np.array(ref_losses), "epoch losses")
    _assert_module_matches(gen, gp2, "generator")
    _assert_module_matches(cri, cp2, "critic")
    for block, before in zip(gen.blocks, gp["blocks"]):
        assert not np.allclose(block.bn.mean.numpy(), before["bn"]["mean"])
    assert not gen.training and not cri.training


def _small_generator():
    gen = Generator(fc_size=16, hidden_size=4, num_res_blocks=2).to(**F64)
    return init_random(gen, torch.Generator().manual_seed(0))


def test_train_gan_epoch_without_a_generator_step_is_nan(corpora):
    _ref, out = corpora
    gen = _small_generator()
    cri = init_random(Critic(hidden_size=4, num_res_blocks=1).to(**F64),
                      torch.Generator().manual_seed(1))
    _g, _c, losses = TP.train_gan(gen, cri, out, batch_size=4, n_epochs=1,
                                  n_critic=100)
    assert np.isfinite(losses[0][0]) and np.isnan(losses[0][1])


def test_double_backward_through_the_lstm_kernels_raises():
    """The kernels' backward (B2, B4; their plain versions here) carries no
    graph: a gradient taken with ``create_graph=True`` through them raises
    instead of silently dropping the second-order terms; first-order
    gradients are those of autograd through the plain forward."""
    rng = np.random.default_rng(0)
    h = 4
    gx = torch.tensor(rng.normal(size=(5, 2, 4 * h)), requires_grad=True)
    w = torch.tensor(rng.normal(size=(h, 4 * h)) * 0.3)
    w2 = torch.tensor(rng.normal(size=(2 * h, 4 * h)) * 0.3)
    b2 = torch.zeros(4 * h, dtype=torch.float64)
    z = torch.zeros((2, h), dtype=torch.float64)
    cases = ((lambda: K.LSTMCore.apply(gx, w, z, z)[0],
              lambda: K.lstm_fwd_plain(gx, w, z, z)[0]),
             (lambda: K.LSTMStack2.apply(gx, w, w2, b2, z, z, z, z)[2],
              lambda: K.lstm_stack2_fwd_plain(gx, w, w2, b2, z, z, z,
                                              z)[2]))
    for kernel, plain in cases:
        with pytest.raises(RuntimeError, match="differentiate twice"):
            torch.autograd.grad(torch.sin(kernel()).sum(), gx,
                                create_graph=True)
        g, = torch.autograd.grad(torch.sin(kernel()).sum(), gx)
        ref, = torch.autograd.grad(torch.sin(plain()).sum(), gx)
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-12)


def test_train_gan_with_an_lstm_critic_raises(corpora):
    """The gradient penalty through ``LSTMCritic`` (B3/B4 in eval mode)
    needs a second-order gradient, which the kernels do not give."""
    _ref, out = corpora
    cri = init_random(LSTMCritic(hidden_size=4).to(**F64),
                      torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="differentiate twice"):
        TP.train_gan(_small_generator(), cri, out, batch_size=4, n_epochs=1)


def test_training_takes_a_jax_dataframe(corpora):
    """Any mapping of columns: the JAX package's DataFrame trains the same
    as the port's dict."""
    ref, out = corpora
    losses = []
    for corpus in (ref, out):
        _p, model = _pair(JF.ForwardModel(num_lstm_layers=1, hidden_size=4),
                          ForwardModel(num_lstm_layers=1, hidden_size=4))
        losses.append(TP.train_forward(model, corpus, batch_size=4,
                                       n_epochs=1)[1])
    assert losses[0] == losses[1]
