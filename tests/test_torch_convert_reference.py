"""Conversion parity against the REFERENCE's own torch model classes.

The inline-oracle tests in test_models.py verify each conversion primitive;
these tests close the remaining gap by loading the actual class definitions
from /root/reference/paule/models.py (torch is installed; the pretrained 200
MB weights are not downloadable here, but random weights exercise exactly the
same state_dict key layout), converting their ``state_dict()`` with
``models.torch_convert``, and asserting f64 output equality for every
convertible kind.  If upstream renames a parameter, these fail.

Reference classes under test: ForwardModel (models.py:326),
InverseModelMelTimeSmoothResidual (models.py:177), EmbeddingModel
(models.py:413), Generator (models.py:594), Critic (models.py:559),
LinearClassifier (models.py:887).
"""

import importlib.util
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paule_tpu  # noqa: F401  (x64 via conftest env)
from paule_tpu import models as M
from paule_tpu.models import torch_convert as TC

from paule_tpu.reference_bridge import reference_available
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REF_MODELS = pathlib.Path("/root/reference/paule/models.py")

pytestmark = pytest.mark.skipif(
    not (reference_available() and REF_MODELS.exists()),
    reason="reference checkout not available")


def _load_reference_models():
    # the reference package __init__ needs `toml` (not installed); models.py
    # itself only needs torch, so load it standalone
    spec = importlib.util.spec_from_file_location("ref_paule_models",
                                                  str(REF_MODELS))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return _load_reference_models()


def _check(got, want, atol=1e-10):
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=1e-9)


def test_forward_model_reference_state_dict(ref):
    torch.manual_seed(0)
    tm = ref.ForwardModel(input_size=30, output_size=60, hidden_size=24,
                          num_lstm_layers=2).double().eval()
    x = torch.randn(2, 16, 30, dtype=torch.float64)
    with torch.no_grad():
        want = tm(x).numpy()

    params = TC.convert("forward", tm.state_dict())
    model = M.ForwardModel(input_size=30, output_size=60, hidden_size=24,
                           num_lstm_layers=2)
    got = model.apply(params, jnp.asarray(x.numpy()))
    _check(got, want)


def test_forward_model_tube_variant_reference_state_dict(ref):
    """cp->tube reuse: output_size=10, no half-sequence (paule.py:239-247)."""
    torch.manual_seed(1)
    tm = ref.ForwardModel(input_size=30, output_size=10, hidden_size=24,
                          num_lstm_layers=1,
                          apply_half_sequence=False).double().eval()
    x = torch.randn(2, 15, 30, dtype=torch.float64)
    with torch.no_grad():
        want = tm(x).numpy()
    params = TC.convert("forward", tm.state_dict())
    model = M.ForwardModel(input_size=30, output_size=10, hidden_size=24,
                           num_lstm_layers=1, apply_half_sequence=False)
    _check(model.apply(params, jnp.asarray(x.numpy())), want)


def test_inverse_model_reference_state_dict(ref):
    torch.manual_seed(2)
    tm = ref.InverseModelMelTimeSmoothResidual(
        input_size=60, output_size=30, hidden_size=20, num_lstm_layers=2,
        mel_smooth_layers=2, mel_smooth_filter_size=3, resid_blocks=3,
        time_filter_size=5).double().eval()
    x = torch.randn(2, 9, 60, dtype=torch.float64)
    with torch.no_grad():
        want = tm(x).numpy()

    params = TC.convert("inverse", tm.state_dict())
    model = M.InverseModelMelTimeSmoothResidual(
        input_size=60, output_size=30, hidden_size=20, num_lstm_layers=2,
        mel_smooth_layers=2, mel_smooth_filter_size=3, resid_blocks=3,
        time_filter_size=5)
    _check(model.apply(params, jnp.asarray(x.numpy())), want)


def test_embedding_model_reference_state_dict(ref):
    torch.manual_seed(3)
    tm = ref.EmbeddingModel(input_size=60, output_size=300, hidden_size=24,
                            num_lstm_layers=2).double().eval()
    x = torch.randn(3, 12, 60, dtype=torch.float64)
    lens = torch.tensor([12, 5, 8])
    with torch.no_grad():
        want = tm(x, lens).numpy()

    params = TC.convert("embedder", tm.state_dict())
    model = M.EmbeddingModel(input_size=60, output_size=300, hidden_size=24,
                             num_lstm_layers=2)
    _check(model.apply(params, jnp.asarray(x.numpy()),
                       jnp.asarray(lens.numpy())), want)


def test_embedding_model_upsampling_variant_reference_state_dict(ref):
    """post_upsampling_size>0 path (the full embedder variant layout)."""
    torch.manual_seed(4)
    tm = ref.EmbeddingModel(input_size=60, output_size=300, hidden_size=24,
                            num_lstm_layers=1,
                            post_upsampling_size=32).double().eval()
    x = torch.randn(2, 10, 60, dtype=torch.float64)
    lens = torch.tensor([10, 6])
    with torch.no_grad():
        want = tm(x, lens).numpy()

    params = TC.convert("embedder", tm.state_dict())
    model = M.EmbeddingModel(input_size=60, output_size=300, hidden_size=24,
                             num_lstm_layers=1, post_upsampling_size=32)
    _check(model.apply(params, jnp.asarray(x.numpy()),
                       jnp.asarray(lens.numpy())), want)


@pytest.mark.slow
@pytest.mark.parametrize("output_size", [30, 60])
def test_generator_reference_state_dict(ref, output_size):
    """cp_gen (30) and mel_gen (60) layouts (paule.py:190-208)."""
    torch.manual_seed(5)
    tm = ref.Generator(channel_noise=100, embed_size=300, fc_size=64,
                       inital_seq_length=4, hidden_size=16, num_res_blocks=5,
                       output_size=output_size).double().eval()
    noise = torch.randn(2, 1, 100, dtype=torch.float64)
    vec = torch.randn(2, 300, dtype=torch.float64)
    length = 20
    with torch.no_grad():
        want = tm(noise, length, vec).numpy()

    params = TC.convert("generator", tm.state_dict())
    model = M.Generator(channel_noise=100, embed_size=300, fc_size=64,
                        inital_seq_length=4, hidden_size=16, num_res_blocks=5,
                        output_size=output_size)
    got = model.apply(params, jnp.asarray(noise.numpy()), length,
                      jnp.asarray(vec.numpy()), use_running_average=True)
    _check(got, want)


def test_critic_reference_state_dict(ref):
    torch.manual_seed(6)
    tm = ref.Critic(input_size=30, embed_size=300, hidden_size=16,
                    num_res_blocks=5).double().eval()
    x = torch.randn(2, 14, 30, dtype=torch.float64)
    vec = torch.randn(2, 300, dtype=torch.float64)
    with torch.no_grad():
        want = tm(x, 14, vec).numpy()

    params = TC.convert("critic", tm.state_dict())
    model = M.Critic(input_size=30, embed_size=300, hidden_size=16,
                     num_res_blocks=5)
    _check(model.apply(params, jnp.asarray(x.numpy()), 14,
                       jnp.asarray(vec.numpy())), want)


def test_linear_classifier_reference_state_dict(ref):
    torch.manual_seed(7)
    tm = ref.LinearClassifier(60, 1).double().eval()
    x = torch.randn(3, 11, 60, dtype=torch.float64)
    with torch.no_grad():
        want_plain = tm(x).numpy()
        want_masked = tm(x.clone(), src_lens=[11, 4, 7]).numpy()

    params = TC.convert("linear_classifier", tm.state_dict())
    model = M.LinearClassifier(60, 1)
    _check(model.apply(params, jnp.asarray(x.numpy())), want_plain)
    _check(model.apply(params, jnp.asarray(x.numpy()),
                       src_lens=jnp.asarray([11, 4, 7])), want_masked)


def test_reference_default_shipped_configs_convert(ref):
    """The exact configs Paule.__init__ loads (paule.py:124-273) convert
    without key errors — guards against layout drift at full size."""
    tm = ref.ForwardModel(num_lstm_layers=1, hidden_size=720).double()
    p = TC.convert("forward", tm.state_dict())
    assert len(p["lstm"]) == 1 and p["lstm"][0]["w_ih"].shape == (30, 4 * 720)

    tm = ref.InverseModelMelTimeSmoothResidual(
        num_lstm_layers=1, hidden_size=720).double()
    p = TC.convert("inverse", tm.state_dict())
    assert len(p["mel_blocks"]) == 3 and len(p["resid_blocks"]) == 5
    assert "resid_weighting" in p

    tm = ref.EmbeddingModel(num_lstm_layers=2, hidden_size=720).double()
    p = TC.convert("embedder", tm.state_dict())
    assert len(p["lstm"]) == 2

    for out_size in (30, 60):
        tm = ref.Generator(output_size=out_size).double()
        p = TC.convert("generator", tm.state_dict())
        assert len(p["blocks"]) == 5
        assert p["post_linear"]["w"].shape == (256, out_size)
