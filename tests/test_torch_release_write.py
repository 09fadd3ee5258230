"""Releases written by the port: ``release.save_release`` writes the JAX
package's layout, which ``paule_tpu.release.load_release`` reads (float16
leaves, the manifest's trees and metadata); ``params_to_jax`` gives back
the JAX tree of every model of the zoo; the release recipe runs end to end
on the CPU at its full widths on a tiny corpus; the JAX package's release
directory is refused."""

import hashlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paule_tpu import release as JR
from paule_tpu.models import baselines as JBL
from paule_tpu.models import classifier as JC
from paule_tpu.models import embedder as JE
from paule_tpu.models import forward as JF
from paule_tpu.models import generative as JG
from paule_tpu.models import inverse as JI
from paule_tpu_torch import models as TM
from paule_tpu_torch import release as TR
from paule_tpu_torch.models.blocks import init_random
from paule_tpu_torch.tools import train_release_weights as recipe
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F64 = {"device": "cpu", "dtype": torch.float64}

#: (JAX model, port model) pairs of every kind of the zoo, at small widths
ZOO = {
    "forward": lambda m: m.ForwardModel(num_lstm_layers=2, hidden_size=6),
    "inverse": lambda m: m.InverseModelMelTimeSmoothResidual(
        num_lstm_layers=1, hidden_size=6, resid_blocks=2),
    "embedder": lambda m: m.EmbeddingModel(num_lstm_layers=2, hidden_size=6,
                                           post_upsampling_size=5),
    "generator": lambda m: m.Generator(fc_size=16, hidden_size=4,
                                       num_res_blocks=2),
    "critic": lambda m: m.Critic(hidden_size=4, num_res_blocks=2),
    "semvec_to_cp": lambda m: m.SemVecToCpModel(hidden_size=4,
                                                resid_blocks=1),
    "semvec_to_mel": lambda m: m.SemVecToMelModel(hidden_size=4,
                                                  lstm_resid=False),
    "lstm_critic": lambda m: m.LSTMCritic(hidden_size=4),
    "lstm_generator": lambda m: m.LSTMGenerator(hidden_size=4),
    "linear_classifier": lambda m: m.LinearClassifier(),
    "transformer": lambda m: m.SpeechNonSpeechTransformer(
        input_dim=12, nhead=3, num_layers=2, dim_feedforward=8, max_len=20),
    "linear": lambda m: m.LinearModel(mode="pred", on_full_sequence=True),
    "nonlinear": lambda m: m.NonLinearModel(hidden_units=5, mode="embed"),
}


class _JaxZoo:
    """The JAX package's models under the port's zoo names."""
    ForwardModel = JF.ForwardModel
    InverseModelMelTimeSmoothResidual = JI.InverseModelMelTimeSmoothResidual
    EmbeddingModel = JE.EmbeddingModel
    Generator, Critic = JG.Generator, JG.Critic
    SemVecToCpModel, SemVecToMelModel = JG.SemVecToCpModel, JG.SemVecToMelModel
    LSTMCritic, LSTMGenerator = JG.LSTMCritic, JG.LSTMGenerator
    LinearClassifier = JC.LinearClassifier
    SpeechNonSpeechTransformer = JC.SpeechNonSpeechTransformer
    LinearModel, NonLinearModel = JBL.LinearModel, JBL.NonLinearModel


@pytest.mark.parametrize("kind", sorted(ZOO))
def test_params_to_jax_round_trips_every_zoo_model(kind):
    """JAX tree -> port module -> ``params_to_jax``: the same nested dicts
    and lists, the same leaves."""
    tree = jax.tree.map(np.asarray, ZOO[kind](_JaxZoo).init(
        jax.random.PRNGKey(0), jnp.float64))
    module = TR.load_into(ZOO[kind](TM), tree, **F64)
    back = TR.params_to_jax(module)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)


def _trees():
    gen = torch.Generator().manual_seed(0)
    return {key: TR.params_to_jax(init_random(ZOO[kind](TM).to(**F64), gen))
            for key, kind in (("predictive", "forward"),
                              ("cp_gan", "generator"),
                              ("speech_classifier", "linear_classifier"))}


def test_save_release_reads_in_the_jax_package(tmp_path):
    trees = _trees()
    path = TR.save_release(trees, path=str(tmp_path / "r" / "rel.npz"),
                           metadata={"recipe": "test"})
    loaded, meta = JR.load_release(path, dtype=np.float32)
    assert meta == {"version": TR.RELEASE_VERSION, "format": 1,
                    "models": sorted(trees), "recipe": "test"}
    assert meta == JR.load_release_metadata(path)
    port, port_meta = TR.load_release(path)
    assert port_meta == meta
    for key, tree in trees.items():
        for got in (loaded[key], port[key]):
            assert jax.tree.structure(got) == jax.tree.structure(tree)
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
                np.testing.assert_array_equal(
                    a, b.astype(np.float16).astype(a.dtype))
    assert all(a.dtype == np.float16 for a in jax.tree.leaves(port))
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    assert TR.sha256(path) == JR.sha256(path) == digest


def test_save_release_refuses_the_jax_release_and_unknown_keys(tmp_path):
    with pytest.raises(ValueError, match="release"):
        TR.save_release(_trees(), path=TR.RELEASE_PATH)
    with pytest.raises(ValueError, match="unknown model keys"):
        TR.save_release({"other": {}}, path=str(tmp_path / "x.npz"))
    with pytest.raises(TypeError):
        TR.save_release(_trees())  # the path is required


def test_recipe_trains_and_writes_a_release_both_packages_load(tmp_path):
    """Every stage at the release's widths on the CPU, on 2 classes of 4
    variants (2 for training each: one full batch of 2 a class), one epoch
    each, one generator step per critic step: every trained tree moved
    from its initial values, and the release holds the trained trees to
    float16 rounding."""
    cfg = recipe.settings({})
    cfg.update(classes=2, variants=4, babble=0, batch=2, n_critic=1)
    cfg["epochs"] = dict.fromkeys(cfg["epochs"], 1)
    lines = []
    modules, ctx, report = recipe.run(str(tmp_path / "rel.npz"),
                                      device="cpu", cfg=cfg,
                                      log=lines.append)
    stages = [json.loads(s) for s in lines[1:-1]]
    assert [s["stage"] for s in stages] == [n for n, _ in recipe.STAGES]
    assert json.loads(json.dumps(report["stages"])) == stages
    for s in stages:
        assert s["adam_steps"] > 0 and np.isfinite(s["last_loss"]).all()
    assert [s["generator_steps"] for s in stages[-2:]] == [2, 2]
    loaded, meta = JR.load_release(str(tmp_path / "rel.npz"))
    assert meta["models"] == sorted(JR.MODEL_KEYS)
    assert meta["recipe"] == "paule_tpu_torch/tools/train_release_weights.py"
    for key, module in modules.items():
        trained = TR.params_to_jax(module)
        assert any(not np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(trained), jax.tree.leaves(ctx.initial[key]))), key
        if key in loaded:
            for a, b in zip(jax.tree.leaves(loaded[key]),
                            jax.tree.leaves(trained)):
                np.testing.assert_array_equal(
                    a, b.astype(np.float16).astype(np.float32))
    with pytest.raises(ValueError, match="release"):
        recipe.run(TR.RELEASE_PATH, device="cpu", cfg=cfg)
