"""Corpus planning of the port (``paule_tpu_torch.experiments``) against
``paule_tpu.experiments`` (float64 on the CPU, the release weights):
``plan_corpus_batched`` over utterances of two lengths and with
``pad_to_multiple``, resuming through ``discover_targets``, and
``plan_corpus`` with ``collect_results``."""

import os

import numpy as np
import pytest
import torch

from paule_tpu import experiments as JX
from paule_tpu import synth as JS
from paule_tpu.api import Paule as JPaule
from paule_tpu.ops.normalize import inv_normalize_cp
from paule_tpu_torch import checkpoint as CK
from paule_tpu_torch import experiments as TX
from paule_tpu_torch.api import Paule
from paule_tpu_torch.dsp import audio as audio_io
from torch_parity import CP_ATOL, LOSS_RTOL
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F64 = {"device": "cpu", "dtype": torch.float64}


def _targets(lengths, seed):
    """``(sig, sr)`` of seeded cp trajectories of ``lengths`` frames."""
    rng = np.random.default_rng(seed)
    return [JS.speak(inv_normalize_cp(np.clip(
        rng.normal(0, 0.1, (n, 30)).cumsum(0) * 0.1, -1, 1)))
        for n in lengths]


def _compare(out, ref):
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert sorted(a) == sorted(b)
        for key in ("planned_cp", "prod_mel"):
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=CP_ATOL,
                                       err_msg=key)
        np.testing.assert_allclose(a["prod_sig"], b["prod_sig"], rtol=0,
                                   atol=1e-6)
        for key in a:
            if key.endswith("_curve"):
                np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL,
                                           atol=0, err_msg=key)


def _count_batches(monkeypatch):
    """The batch sizes of the port's ``plan_batch_resynth`` calls."""
    sizes = []
    real = TX.batched.plan_batch_resynth

    def counting(model, mels, *args, **kwargs):
        sizes.append(len(mels))
        return real(model, mels, *args, **kwargs)

    monkeypatch.setattr(TX.batched, "plan_batch_resynth", counting)
    return sizes


def test_plan_corpus_batched_mixed_lengths_matches_jax(monkeypatch):
    """Five utterances of 24 and 32 cp frames, ``max_batch=2``: buckets of
    exact length (3 and 2 utterances), a leftover batch of 1, the results
    in input order, with continue-learning carried from batch to batch."""
    lengths = (24, 24, 32, 24, 32)
    targets = _targets(lengths, seed=9)
    kw = dict(max_batch=2, verbose=False, plan_kwargs=dict(
        n_outer=1, n_inner=2, continue_learning=True, n_epochs=1,
        batch_size=2))
    ref = JX.plan_corpus_batched(JPaule(seed=21), targets, **kw)
    sizes = _count_batches(monkeypatch)
    port = Paule(seed=21, **F64)
    done = []
    try:
        out = TX.plan_corpus_batched(
            port, targets, on_result=lambda i, r: done.append(i), **kw)
    finally:
        port.close()
    _compare(out, ref)
    assert sizes == [2, 1, 2]
    assert sorted(done) == list(range(5))
    for res, n_cp in zip(out, lengths):
        assert res["planned_cp"].shape == (n_cp, 30)
        assert res["prod_sig"].shape == ((n_cp - 1) * 110,)
        assert res["prod_loss_curve"].shape == (1,)
        assert res["prod_semvec_loss_curve"].shape == (1,)


def test_plan_corpus_batched_pad_to_multiple_matches_jax(monkeypatch):
    """22, 26, 30 and 32 cp frames are 11, 13, 15 and 16 mel frames, which
    ``pad_to_multiple=16`` merges into one batch; each result is trimmed
    back to its own length."""
    lengths = (22, 26, 30, 32)
    targets = _targets(lengths, seed=10)
    kw = dict(max_batch=4, verbose=False, pad_to_multiple=16,
              plan_kwargs=dict(n_outer=1, n_inner=2, objective="acoustic",
                               continue_learning=False))
    ref = JX.plan_corpus_batched(JPaule(seed=22), targets, **kw)
    sizes = _count_batches(monkeypatch)
    port = Paule(seed=22, **F64)
    try:
        out = TX.plan_corpus_batched(port, targets, **kw)
    finally:
        port.close()
    _compare(out, ref)
    assert sizes == [4]
    for res, n_cp in zip(out, lengths):
        assert res["planned_cp"].shape == (n_cp, 30)
        assert res["prod_sig"].shape == ((n_cp - 1) * 110,)
        assert res["prod_mel"].shape == (n_cp // 2, 60)


@pytest.fixture
def corpus(tmp_path):
    """Two labelled WAVs of 40 cp frames: ``<label>/<name>_<label>.wav``."""
    root = tmp_path / "corpus"
    for (label, name), target in zip([("ba", "u1"), ("da", "u2")],
                                      _targets((40, 40), seed=0)):
        (root / label).mkdir(parents=True)
        audio_io.write(str(root / label / f"{name}_{label}.wav"), *target)
    return str(root)


def test_discover_targets_resumes(corpus, tmp_path):
    """Files with a ``_results.pkl`` or ``_batched.pkl`` under the save
    directory are left out; the order is the JAX package's."""
    files = TX.discover_targets(corpus)
    assert files == JX.discover_targets(corpus)
    assert sorted(TX.label_of(f) for f in files) == ["ba", "da"]
    save = tmp_path / "save" / "ba"
    save.mkdir(parents=True)
    (save / "u1_ba_batched.pkl").write_bytes(b"x")
    left = TX.discover_targets(corpus, save_dir=str(tmp_path / "save"),
                               shuffle=False)
    assert [os.path.basename(f) for f in left] == ["u2_da.wav"]
    (save / "u2_da_results.pkl").write_bytes(b"x")
    assert TX.discover_targets(corpus, save_dir=str(tmp_path / "save")) == []


def test_plan_corpus_and_collect(corpus, tmp_path):
    """``plan_corpus`` writes each result, its audio and the checkpoint;
    ``collect_results`` reads them into one row per utterance; nothing is
    left to plan after."""
    pd = pytest.importorskip("pandas")
    save_dir = str(tmp_path / "out")
    port = Paule(seed=3, **F64)
    files = TX.discover_targets(corpus, shuffle=False)
    try:
        result_files = TX.plan_corpus(
            port, files, save_dir, semvec_lookup={"ba": np.zeros(300)},
            checkpoint_every=1, verbose=False, plan_kwargs=dict(
                n_outer=1, n_inner=2, n_batches=1, batch_size=2, n_epochs=1,
                continue_learning=True))
    finally:
        port.close()
    assert all(os.path.exists(f) for f in result_files)
    assert len(result_files) == 2
    assert CK.load(os.path.join(save_dir, "checkpoint.pkl"))["pred_params"]
    for f in result_files:
        stem = f[:-len("_results.pkl")]
        assert (os.path.exists(stem + "_planned.wav")
                or os.path.exists(stem + "_planned.flac"))
    final = TX.collect_results(save_dir)
    assert isinstance(final, pd.DataFrame) and len(final) == 2
    assert sorted(final["label"]) == ["ba", "da"]
    assert np.isfinite(final["prod_loss"].astype(float)).all()
    assert os.path.exists(os.path.join(save_dir, "results_loss.txt"))
    assert TX.discover_targets(corpus, save_dir=save_dir) == []
