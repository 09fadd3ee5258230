"""``pretrained_dir`` and injected weights: the port's ``Paule`` against
``paule_tpu.api.Paule`` on a reference-layout ``pretrained_models/`` tree
that the test writes itself, from the release's trees with a seeded 1%
jitter (so that a plan from the tree differs from one from the release),
inverting ``paule_tpu/models/torch_convert.py``; the variants' files (the
speech classifier, and the three ``somatosensory/`` files told apart by
their names) in a second tree."""

import jax
import numpy as np
import pytest
import torch

from paule_tpu import release as JR
from paule_tpu.api import Paule as JPaule
from paule_tpu.models import torch_convert as JTC
from paule_tpu_torch.api import Paule
from paule_tpu_torch.models import torch_convert as TTC
from torch_parity import SmoothPlant, compare, plan_both, seeded_semvec
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: the reference's shipped filenames (tests/test_pretrained_tree.py:37-56)
FILES = {
    "predictive": "predictive/pred_model_common_voice_1_720_lr_0001_50_"
                  "00001_50_000001_50_0000001_200.pt",
    "inverse": "inverse/inv_model_common_voice_3_1_720_5_lr_0001_50_00001_"
               "50_000001_50_0000001_200.pt",
    "embedder": "embedder/embed_model_common_voice_syn_rec_2_720_0_dropout_"
                "07_noise_6e05_rmse_lr_00001_200.pt",
    "cp_gan": "cp_gan/conditional_trained_cp_generator_whole_critic_it_5_"
              "10_20_40_80_100_415.pt",
    "mel_gan": "mel_gan/conditional_trained_mel_generator_synthesized_"
               "critic_it_5_10_20_40_80_100_400.pt",
}
KIND = {"predictive": "forward", "inverse": "inverse",
        "embedder": "embedder", "cp_gan": "generator", "mel_gan": "generator"}
#: the variants' files, as the reference ships them
#: (tests/test_pretrained_tree.py:48-55); in name order the three
#: somatosensory files would all resolve to the first without the filters
VARIANT_FILES = {
    "speech_classifier": "speech_classifier/linear_model_rec_as_"
                         "nonspeech.pt",
    "cp_tube": "somatosensory/cp_to_tube_model_1_360_lr_0001_50_00001_"
               "100.pt",
    "tube_mel": "somatosensory/tube_to_mel_model_1_360_lr_0001_50_00001_"
                "100.pt",
    "tube_embedder": "somatosensory/tube_to_vector_model_2_720_0_dropout_"
                     "07_noise_6e05_rmse_lr_00001_200.pt",
}
KIND.update(speech_classifier="linear_classifier", cp_tube="forward",
            tube_mel="forward", tube_embedder="embedder")
#: the port's attribute of each model
ATTR = {"predictive": "pred_model", "inverse": "inv_model",
        "embedder": "embedder", "cp_gan": "cp_gen_model",
        "mel_gan": "mel_gen_model"}


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _linear(p, prefix):
    return {f"{prefix}.weight": _t(p["w"]).T, f"{prefix}.bias": _t(p["b"])}


def _conv(p, prefix):
    return {f"{prefix}.weight": _t(p["w"]).permute(2, 1, 0),
            f"{prefix}.bias": _t(p["b"])}


def _lstm(layers, prefix="lstm"):
    sd = {}
    for i, p in enumerate(layers):
        sd[f"{prefix}.weight_ih_l{i}"] = _t(p["w_ih"]).T
        sd[f"{prefix}.weight_hh_l{i}"] = _t(p["w_hh"]).T
        sd[f"{prefix}.bias_ih_l{i}"] = _t(p["b"])
        sd[f"{prefix}.bias_hh_l{i}"] = torch.zeros(len(p["b"]),
                                                   dtype=torch.float64)
    return sd


def to_reference(kind, tree):
    """A JAX-layout tree -> the reference's state dict of that model."""
    sd = {}
    if kind in ("forward", "embedder", "inverse"):
        sd.update(_lstm(tree["lstm"]))
    for name in ("post_linear", "linear_mapping", "fully_connected",
                 "linear"):
        if name in tree:
            sd.update(_linear(tree[name], name))
    if kind == "inverse":
        for i, block in enumerate(tree["mel_blocks"]):
            for j, conv in enumerate(block["convs"]):
                sd.update(_conv(conv, f"MelBlocks.{i}.ConvLayers.{j}"))
        for i, block in enumerate(tree["resid_blocks"]):
            sd.update(_conv(block["conv1"],
                            f"ResidualConvBlocks.{i}.band_conv1d_1"))
            sd.update(_conv(block["conv2"],
                            f"ResidualConvBlocks.{i}.band_conv1d_2"))
        sd.update(_conv(tree["resid_weighting"], "resid_weighting"))
    if kind == "generator":
        for i, block in enumerate(tree["blocks"]):
            sd.update(_conv(block["conv"], f"res_blocks.{i}.0"))
            bn = block["bn"]
            sd.update({f"res_blocks.{i}.1.weight": _t(bn["scale"]),
                       f"res_blocks.{i}.1.bias": _t(bn["bias"]),
                       f"res_blocks.{i}.1.running_mean": _t(bn["mean"]),
                       f"res_blocks.{i}.1.running_var": _t(bn["var"])})
        sd.update(_conv(tree["final_smoothing"], "final_smoothing"))
    return sd


@pytest.fixture(scope="module")
def trees():
    """The release's trees, each leaf times (1 + 0.01 N(0, 1)), seeded."""
    weights, _meta = JR.load_release()
    rng = np.random.default_rng(0)
    return {key: jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        * (1.0 + 0.01 * rng.normal(size=np.shape(a))), weights[key])
        for key in (*FILES, *VARIANT_FILES)}


def _write_tree(root, files, trees):
    for key, rel in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(to_reference(KIND[key], trees[key]), path)
    return root


@pytest.fixture(scope="module")
def tree_dir(trees, tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("pretrained_models"), FILES,
                       trees)


def _state_equal(module, tree):
    """Whether ``module``'s state equals the JAX-layout ``tree``."""
    want = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, list):
            items = enumerate(node)
        else:
            want[prefix] = np.asarray(node)
            return
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k))

    walk(tree, "")
    got = module.state_dict()
    return got.keys() == want.keys() and all(
        np.array_equal(got[k].numpy(), want[k]) for k in want)


def test_tree_converts_as_jax_does(tree_dir, trees):
    """Each file converts to the tree it was written from, as the JAX
    package converts it, and the port's models hold it."""
    port = Paule(device="cpu", dtype=torch.float64,
                 pretrained_dir=str(tree_dir))
    try:
        for key, rel in FILES.items():
            got = TTC.convert(KIND[key], str(tree_dir / rel))
            want = JTC.convert(KIND[key], str(tree_dir / rel))
            assert (jax.tree.structure(got) == jax.tree.structure(want)
                    == jax.tree.structure(trees[key]))
            for g, w, t in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                               jax.tree.leaves(trees[key])):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, t)
            assert _state_equal(getattr(port, ATTR[key]), want), key
    finally:
        port.close()


def test_pretrained_dir_plans_as_jax(tree_dir):
    """A semvec-only plan uses all five models: the tree's weights, the
    same on both sides."""
    kw = dict(target_acoustic=None, target_semvec=seeded_semvec(),
              target_seq_length=21, initialize_from="semvec",
              objective="acoustic_semvec", n_outer=1, n_inner=3, log_ii=1,
              continue_learning=True, continue_learning_inv=True,
              n_batches=1, batch_size=2, n_epochs=1, verbose=False)
    init = {"pretrained_dir": str(tree_dir), "plant": SmoothPlant()}
    out, ref, _port, _noises = plan_both(kw, init, init, n_noises=2)
    compare(out, ref)
    release, _ref, _port, _noises = plan_both(
        kw, {"plant": SmoothPlant()}, {"plant": SmoothPlant()})
    assert np.abs(release.planned_cp - out.planned_cp).max() > 1e-3


def test_missing_dir_raises():
    with pytest.raises(FileNotFoundError):
        Paule(device="cpu", pretrained_dir="/nonexistent/pretrained_models")


def test_random_init_is_seeded():
    """``"random"``: the same seed gives the same weights, another seed
    others, and neither is the release."""
    a, b, c, rel = (Paule(device="cpu", pretrained_dir=p, seed=s)
                    for p, s in (("random", 3), ("random", 3),
                                 ("random", 4), (None, 3)))
    try:
        for attr in ATTR.values():
            sa, sb, sc, sr = (getattr(p, attr).state_dict()
                              for p in (a, b, c, rel))
            for name in sa:
                assert torch.equal(sa[name], sb[name]), (attr, name)
            weights = [n for n in sa if n.endswith("w")]
            assert weights
            for name in weights:
                assert not torch.equal(sa[name], sc[name]), (attr, name)
                assert not torch.equal(sa[name], sr[name]), (attr, name)
    finally:
        for p in (a, b, c, rel):
            p.close()


@pytest.mark.parametrize("how", ["env", "missing_file"])
def test_no_release_falls_back_to_random(how, monkeypatch, tmp_path,
                                         capsys):
    """Without the release (``PAULE_TPU_NO_RELEASE=1``, or no file at the
    release path) ``Paule()`` builds with the seeded random initialisation
    of ``pretrained_dir="random"`` and prints the hint once, as the JAX
    package does (``paule_tpu/api.py:333-343``,
    ``tests/test_release.py:58-60``)."""
    from paule_tpu_torch import release as TR

    if how == "env":
        monkeypatch.setenv("PAULE_TPU_NO_RELEASE", "1")
    else:
        monkeypatch.setattr(TR, "release_path",
                            lambda version=TR.RELEASE_VERSION:
                            str(tmp_path / "absent.npz"))
    monkeypatch.setattr(TR, "_PRINTED_FALLBACK_HINT", False)
    assert not TR.release_available()
    a, b = (Paule(device="cpu", seed=3) for _ in range(2))
    hint = capsys.readouterr().out
    rand = Paule(device="cpu", pretrained_dir="random", seed=3)
    try:
        assert hint.count("no pretrained weight release found") == 1
        assert hint.startswith("paule_tpu_torch: ")
        for attr in ATTR.values():
            for p in (a, b):
                got = getattr(p, attr).state_dict()
                for name, want in getattr(rand, attr).state_dict().items():
                    assert torch.equal(got[name], want), (attr, name)
    finally:
        for p in (a, b, rand):
            p.close()


def test_partial_tree_falls_back_to_random(tree_dir, tmp_path, trees):
    """Only the predictive model's file: it is read, and the other models
    get the seeded random initialisation, as an instance with the same
    seed whose predictive model is injected gets them."""
    partial = tmp_path / "partial"
    (partial / "predictive").mkdir(parents=True)
    (partial / FILES["predictive"]).write_bytes(
        (tree_dir / FILES["predictive"]).read_bytes())
    p = Paule(device="cpu", dtype=torch.float64, pretrained_dir=str(partial),
              seed=5)
    q = Paule(device="cpu", dtype=torch.float64, pretrained_dir="random",
              seed=5, pred_model=trees["predictive"])
    try:
        assert _state_equal(p.pred_model, trees["predictive"])
        assert _state_equal(q.pred_model, trees["predictive"])
        for attr in ("inv_model", "embedder", "cp_gen_model",
                     "mel_gen_model"):
            sp, sq = (getattr(m, attr).state_dict() for m in (p, q))
            for name in sp:
                assert torch.equal(sp[name], sq[name]), (attr, name)
    finally:
        p.close()
        q.close()


@pytest.mark.parametrize("variant,keys", [
    ("use_speech_classifier", {"speech_classifier": "speech_classifier"}),
    ("use_somatosensory_feedback", {
        "cp_tube": "cp_tube_model", "tube_mel": "tube_mel_model",
        "tube_embedder": "tube_embedder"})])
def test_pretrained_dir_reads_the_variants_files(trees, tmp_path, variant,
                                                 keys):
    """Each variant model is read from its own file, the one the JAX
    package picks."""
    root = _write_tree(tmp_path, VARIANT_FILES, trees)
    port = Paule(device="cpu", dtype=torch.float64, pretrained_dir=str(root),
                 **{variant: True})
    jpaule = JPaule(pretrained_dir=str(root), **{variant: True})
    jparams = {"speech_classifier": jpaule.speech_classifier_params,
               "cp_tube": jpaule.cp_tube_params,
               "tube_mel": jpaule.tube_mel_params,
               "tube_embedder": jpaule.tube_embedder_params}
    try:
        for key, attr in keys.items():
            module = getattr(port, attr)
            assert _state_equal(module, trees[key]), key
            assert _state_equal(module, jax.tree.map(np.asarray,
                                                     jparams[key])), key
    finally:
        port.close()
