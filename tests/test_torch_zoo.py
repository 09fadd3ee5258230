"""The rest of the model zoo against the JAX package in float64 on the CPU:
train-mode batch norm (also against ``torch.nn.BatchNorm1d``), instance and
layer norm, the inception block, ``Critic``, ``SemVecToCpModel``,
``SemVecToMelModel``, ``LSTMCritic`` / ``LSTMGenerator`` (eval, and
training with JAX's keep masks), ``SpeechNonSpeechTransformer``, the
baselines, ``ForwardModelMelTimeSmoothResidual`` and
``MelEmbeddingModelMelSmoothResidualUpsampling``, each at small widths
with parameters from the JAX initialiser (through ``params_from_jax``):
outputs and every parameter gradient agree to 1e-10; and the critic's
checkpoint converter."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paule_tpu.models import baselines as JBL
from paule_tpu.models import blocks as JB
from paule_tpu.models import classifier as JC
from paule_tpu.models import embedder as JE
from paule_tpu.models import forward as JF
from paule_tpu.models import generative as JG
from paule_tpu.models import torch_convert as JTC
from paule_tpu_torch import models as TM
from paule_tpu_torch.models import blocks as TB
from paule_tpu_torch.models import classifier as TC
from paule_tpu_torch.models import torch_convert as TTC
from paule_tpu_torch.release import load_into, params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-10
F64 = {"device": "cpu", "dtype": torch.float64}


def _x(shape, seed=0, scale=1.0):
    return np.random.default_rng(seed).normal(size=shape) * scale


def _check(jmodel, tmodel, j_args, t_args=None, j_kw=None, t_kw=None,
           key=0, init=None):
    """Both models from the JAX initialiser's float64 tree: the outputs and
    the gradients of ``sum(sin(out))`` by every port parameter agree."""
    tree = init if init is not None else jmodel.init(
        jax.random.PRNGKey(key), jnp.float64)
    tree = jax.tree.map(np.asarray, tree)
    j_kw, t_kw = j_kw or {}, t_kw or {}

    def loss(p):
        out = jmodel.apply(p, *j_args, **j_kw)
        return jnp.sum(jnp.sin(out)), out

    (_, out_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    load_into(tmodel, tree, **F64)
    t_args = t_args if t_args is not None else [
        torch.tensor(a) if isinstance(a, np.ndarray) else a for a in j_args]
    out = tmodel(*t_args, **t_kw)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=TOL)
    ref = params_from_jax(jax.tree.map(np.asarray, grads_j))
    named = dict(tmodel.named_parameters())
    assert named, "no parameters"
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=0,
                                   atol=TOL, err_msg=name)
    return tmodel


def test_batchnorm_train_mode_matches_jax_and_torch():
    """Batch statistics normalise (biased variance); the running statistics
    take momentum 0.1 and the unbiased variance, as JAX's
    ``batchnorm_new_stats`` and torch's ``BatchNorm1d`` update them."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1.5, (4, 7, 5))
    params = {"scale": rng.normal(size=5), "bias": rng.normal(size=5),
              "mean": rng.normal(size=5), "var": rng.uniform(0.5, 2, 5)}
    jparams = jax.tree.map(jnp.asarray, params)

    def loss(p):
        out = JB.batchnorm(p, jnp.asarray(x), use_running_average=False)
        return jnp.sum(jnp.sin(out)), out

    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(jparams)
    new = JB.batchnorm_new_stats(jparams, jnp.asarray(x))
    bn = load_into(TB.BatchNorm(5), params, **F64).train()
    out = bn(torch.tensor(x))
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=TOL)
    for name in ("scale", "bias"):
        np.testing.assert_allclose(getattr(bn, name).grad.numpy(),
                                   np.asarray(grads[name]), rtol=0, atol=TOL)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(new[name]), rtol=0, atol=TOL)
    ref_bn = torch.nn.BatchNorm1d(5).double()
    with torch.no_grad():
        ref_bn.running_mean.copy_(torch.tensor(params["mean"]))
        ref_bn.running_var.copy_(torch.tensor(params["var"]))
    ref_bn.train()(torch.tensor(x).transpose(1, 2))
    np.testing.assert_allclose(bn.mean.numpy(), ref_bn.running_mean.numpy(),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(bn.var.numpy(), ref_bn.running_var.numpy(),
                               rtol=0, atol=TOL)
    # eval mode leaves the running statistics as they are
    before = bn.mean.clone()
    bn.eval()(torch.tensor(x))
    assert torch.equal(bn.mean, before)


class _JaxBlock:
    """A JAX block's init/apply pair as a model."""

    def __init__(self, init, apply, **kw):
        self.init, self._apply, self.kw = init, apply, kw

    def apply(self, params, x):
        return self._apply(params, x, **self.kw)


@pytest.mark.parametrize("kind", ["instance", "layer", "inception",
                                  "inception_act_no_resid"])
def test_norms_and_inception_block_match_jax(kind):
    c = 6
    x = _x((3, 9, c), seed=1)
    rnd = _x((2 * c,), seed=2)
    if kind in ("instance", "layer"):
        init = {"scale": rnd[:c], "bias": rnd[c:]}
        jfn = JB.instancenorm if kind == "instance" else JB.layernorm
        jm = _JaxBlock(lambda *_: init, jfn)
        tm = TB.InstanceNorm(c) if kind == "instance" else TB.LayerNorm(c)
        _check(jm, tm, [x], init=init)
        return
    act = kind == "inception_act_no_resid"
    jm = _JaxBlock(lambda k, d: JB.time_conv_inception_block_init(k, c, d),
                   JB.time_conv_inception_block, channels=c,
                   activation=jnp.tanh if act else None, add_resid=not act)
    _check(jm, TB.TimeConvInceptionBlock(c), [x],
           t_kw=dict(activation=torch.tanh if act else None,
                     add_resid=not act))


def test_norm_init_random_is_the_identity():
    gen = torch.Generator().manual_seed(0)
    for m in (TB.InstanceNorm(4), TB.LayerNorm(4), TB.BatchNorm(4)):
        with torch.no_grad():
            for p in m.parameters():
                p.add_(1.0)
        TB.init_random(m, gen)
        assert torch.equal(m.scale, torch.ones(4))
        assert torch.equal(m.bias, torch.zeros(4))


def test_critic_matches_jax():
    x, vec = _x((3, 9, 6), seed=3), _x((3, 5), seed=4, scale=0.3)
    _check(JG.Critic(input_size=6, embed_size=5, hidden_size=8,
                     num_res_blocks=2),
           TM.Critic(input_size=6, embed_size=5, hidden_size=8,
                     num_res_blocks=2), [x, 9, vec])


@pytest.mark.parametrize("kind,lstm_resid", [("cp", True), ("cp", False),
                                             ("mel", True)])
def test_semvec_to_trajectory_models_match_jax(kind, lstm_resid):
    """Four LSTM layers of equal width: two fused pairs (B3/B4)."""
    x = _x((2, 11, 7), seed=5, scale=0.5)
    if kind == "cp":
        kw = dict(input_size=7, output_size=5, hidden_size=8,
                  num_lstm_layers=4, resid_blocks=2, lstm_resid=lstm_resid)
        jm, tm = JG.SemVecToCpModel(**kw), TM.SemVecToCpModel(**kw)
    else:
        kw = dict(input_size=7, output_size=6, hidden_size=8,
                  num_lstm_layers=4, mel_smooth_layers=2,
                  lstm_resid=lstm_resid)
        jm, tm = JG.SemVecToMelModel(**kw), TM.SemVecToMelModel(**kw)
    _check(jm, tm, [x])


@pytest.mark.parametrize("layers,lstm_resid", [(2, True), (1, False),
                                               (3, True)])
def test_forward_model_mel_time_smooth_residual_matches_jax(layers,
                                                            lstm_resid):
    """Residual time smoothing, +vel/acc, the LSTM stack (a fused pair, one
    layer alone, a pair and a layer), half-sequence pooling of an odd
    length, mel-channel smoothing and the grouped-conv weighting."""
    kw = dict(input_size=6, output_size=6, hidden_size=8,
              num_lstm_layers=layers, mel_smooth_layers=2, resid_blocks=2,
              lstm_resid=lstm_resid)
    tm = _check(JF.ForwardModelMelTimeSmoothResidual(**kw),
                TM.ForwardModelMelTimeSmoothResidual(**kw),
                [_x((2, 11, 6), seed=11, scale=0.5)])
    assert (tm.resid_weighting is None) is not lstm_resid


@pytest.mark.parametrize("lens", [None, [9, 4]])
def test_mel_embedding_model_smooth_residual_upsampling_matches_jax(lens):
    kw = dict(input_size=6, output_size=5, hidden_size=8, num_lstm_layers=2,
              mel_smooth_layers=2, post_upsampling_size=12)
    lens = None if lens is None else np.asarray(lens)
    _check(JE.MelEmbeddingModelMelSmoothResidualUpsampling(**kw),
           TM.MelEmbeddingModelMelSmoothResidualUpsampling(**kw),
           [_x((2, 9, 6), seed=12), lens])


def _keep_masks(key, n_boundaries, shape, p):
    masks = []
    for _ in range(n_boundaries):
        key, sub = jax.random.split(key)
        masks.append(torch.tensor(np.asarray(
            jax.random.bernoulli(sub, 1.0 - p, shape))))
    return masks


@pytest.mark.parametrize("kind", ["critic", "generator"])
@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("training", [False, True])
def test_recurrent_gan_models_match_jax(kind, layers, training):
    """In eval mode adjacent layers run fused; in training each layer runs
    alone with dropout 0.5 between layers, the port given the keep masks
    that JAX draws from the same key."""
    b, t, h = 3, 8, 6
    vec = _x((b, 5), seed=6, scale=0.3)
    lens = np.array([8, 5, 1])
    if kind == "critic":
        kw = dict(input_size=4, embed_size=5, hidden_size=h,
                  num_lstm_layers=layers)
        jm, tm = JG.LSTMCritic(**kw), TM.LSTMCritic(**kw)
        x = _x((b, t, 4), seed=7)
    else:
        kw = dict(channel_noise=4, embed_size=5, output_size=3,
                  hidden_size=h, num_lstm_layers=layers)
        jm, tm = JG.LSTMGenerator(**kw), TM.LSTMGenerator(**kw)
        x = _x((b, t, 4), seed=8)
    key = jax.random.PRNGKey(9)
    j_kw = dict(deterministic=not training, rng=key if training else None)
    t_kw = {}
    if training:
        t_kw["keep_masks"] = _keep_masks(key, layers - 1, (b, t, h), 0.5)
        assert any(not m.all() for m in t_kw["keep_masks"])
    tm.train(training)
    _check(jm, tm, [x, lens, vec], j_kw=j_kw, t_kw=t_kw)


@pytest.mark.parametrize("src_lens", [None, [9, 4]])
def test_speech_non_speech_transformer_matches_jax(src_lens):
    kw = dict(input_dim=12, num_layers=2, nhead=3, dim_feedforward=16,
              max_len=30)
    x = _x((2, 9, 12), seed=10)
    j_kw = t_kw = {} if src_lens is None else {
        "src_lens": np.asarray(src_lens)}
    tm = _check(JC.SpeechNonSpeechTransformer(**kw),
                TM.SpeechNonSpeechTransformer(**kw), [x], j_kw=j_kw,
                t_kw={k: torch.tensor(v) for k, v in t_kw.items()})
    assert [n for n, _ in tm.named_buffers()] == ["pe"]
    np.testing.assert_allclose(
        TC.positional_encoding(12, 30, torch.float64).numpy(),
        np.asarray(JC.positional_encoding(12, 30, jnp.float64)), rtol=0,
        atol=1e-14)


def test_gelu_is_jax_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh approximation; the exact erf
    GELU differs by up to ~1e-3."""
    x = np.linspace(-5, 5, 101)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(TC._gelu(torch.tensor(x)).numpy(), ref,
                               rtol=0, atol=1e-14)
    exact = torch.nn.functional.gelu(torch.tensor(x)).numpy()
    assert np.abs(exact - ref).max() > 1e-4


BASELINE_CASES = [(cls, mode, full, vel)
                  for cls in ("linear", "nonlinear")
                  for mode in ("pred", "inv", "embed")
                  for full, vel in ((False, True), (True, True),
                                    (True, False))]


@pytest.mark.parametrize("cls,mode,full,vel", BASELINE_CASES)
def test_baselines_match_jax(cls, mode, full, vel):
    kw = dict(input_channel=4, output_channel=3, mode=mode,
              on_full_sequence=full, add_vel_and_acc=vel)
    if cls == "linear":
        jm, tm = JBL.LinearModel(**kw), TM.LinearModel(**kw)
    else:
        jm = JBL.NonLinearModel(hidden_units=7, **kw)
        tm = TM.NonLinearModel(hidden_units=7, **kw)
    x = _x((2, 8 if full else 2, 4), seed=11)
    _check(jm, tm, [x])


def test_baselines_reject_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        TM.LinearModel(mode="other")


def test_convert_critic_matches_jax():
    """A reference-layout critic state dict converts as the JAX package
    converts it, and the port's ``Critic`` takes it whole."""
    rng = np.random.default_rng(12)
    hidden, n_in = 8, 6 + 5
    sd = {"inital_linear.weight": rng.normal(size=(hidden, n_in)),
          "inital_linear.bias": rng.normal(size=hidden)}
    for i in range(2):
        sd[f"res_blocks.{i}.0.weight"] = rng.normal(size=(hidden, hidden, 5))
        sd[f"res_blocks.{i}.0.bias"] = rng.normal(size=hidden)
        sd[f"res_blocks.{i}.1.weight"] = rng.normal(size=hidden)
        sd[f"res_blocks.{i}.1.bias"] = rng.normal(size=hidden)
    sd = {k: torch.tensor(v) for k, v in sd.items()}
    ref = JTC.convert("critic", sd)
    out = TTC.convert("critic", sd)
    assert jax.tree.structure(ref) == jax.tree.structure(out)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(out)):
        np.testing.assert_array_equal(a, b)
    critic = load_into(TM.Critic(input_size=6, embed_size=5,
                                 hidden_size=hidden, num_res_blocks=2),
                       out, **F64)
    assert critic(torch.zeros(1, 3, 6, dtype=torch.float64), 3,
                  torch.zeros(1, 5, dtype=torch.float64)).shape == (1,)
