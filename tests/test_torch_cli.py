"""The port's command line (``python -m paule_tpu_torch``) on the CPU:
``plan`` and ``corpus --batched`` write their results, ``babble`` writes
what the JAX package's ``babble`` writes, ``sysinfo`` prints, the card is
the default device, and the commands not ported yet exit with an error
naming their ROADMAP.md item without running."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from paule_tpu_torch import synth
from paule_tpu_torch.__main__ import main
from paule_tpu_torch.dsp import audio as audio_io
from paule_tpu_torch.ops.normalize import inv_normalize_cp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--n-outer", "1", "--n-inner", "2", "--n-batches",
        "1", "--batch-size", "2", "--n-epochs", "1", "--quiet"]


def _wav(path, n_cp, seed):
    rng = np.random.default_rng(seed)
    cp = np.clip(rng.normal(0, 0.1, (n_cp, 30)).cumsum(0) * 0.1, -1, 1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    audio_io.write(path, *synth.speak(inv_normalize_cp(cp)))
    return path


def test_plan_writes_results_audio_and_state(tmp_path, capsys):
    target = _wav(str(tmp_path / "word.wav"), 24, 0)
    save = str(tmp_path / "out" / "word")
    main(["plan", "--target", target, "--save", save, *TINY])
    with open(save + ".pkl", "rb") as fh:
        results = pickle.load(fh)
    assert results.planned_cp.shape == (24, 30)
    assert len(results.pred_model_loss) == 1
    assert (os.path.exists(save + "_planned.wav")
            or os.path.exists(save + "_planned.flac"))
    assert os.path.exists(save + "_state.pkl")
    assert "saved" in capsys.readouterr().out


def test_corpus_batched_writes_one_result_per_utterance(tmp_path, capsys):
    """Three utterances of two labels and two lengths, ``--batched 2``:
    one ``_batched.pkl`` each under its label; a second run finds nothing
    left to plan."""
    data = tmp_path / "data"
    for name, n_cp, seed in (("ba/u1_ba", 24, 1), ("ba/u2_ba", 24, 2),
                             ("da/u3_da", 28, 3)):
        _wav(str(data / f"{name}.wav"), n_cp, seed)
    save = str(tmp_path / "save")
    args = ["corpus", "--data-dir", str(data), "--save-dir", save,
            "--batched", "2", *TINY]
    main(args)
    assert "planned 3 utterances" in capsys.readouterr().out
    for name, n_cp in (("ba/u1_ba", 24), ("ba/u2_ba", 24), ("da/u3_da", 28)):
        with open(os.path.join(save, f"{name}_batched.pkl"), "rb") as fh:
            res = pickle.load(fh)
        assert res["planned_cp"].shape == (n_cp, 30)
        assert res["prod_loss_curve"].shape == (1,)
        assert np.isfinite(res["prod_semvec_loss_curve"]).all()
    main(args)
    assert "nothing to plan" in capsys.readouterr().out


def test_babble_writes_what_the_jax_command_writes(tmp_path, capsys):
    """The same DataFrame pickle for the same seed: the trajectories bit
    for bit, the log-mels (float32 here, float64 in the JAX package under
    the tests' x64 mode) to float32 rounding."""
    from paule_tpu.__main__ import main as jax_main

    args = ["babble", "--n", "3", "--min-len", "20", "--max-len", "26",
            "--seed", "4", "--workers", "2"]
    jax_main(args + ["--out", str(tmp_path / "ref.pkl")])
    main(args + ["--out", str(tmp_path / "out.pkl"), "--device", "cpu"])
    assert "wrote 3 babbled utterances" in capsys.readouterr().out
    ref = pd.read_pickle(tmp_path / "ref.pkl")
    out = pd.read_pickle(tmp_path / "out.pkl")
    assert list(out.columns) == list(ref.columns)
    assert list(out["segment_data"]) == list(ref["segment_data"])
    assert list(out["vector"]) == list(ref["vector"])
    for a, b in zip(out["cp_norm"], ref["cp_norm"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(out["melspec_norm_synthesized"],
                    ref["melspec_norm_synthesized"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def test_sysinfo(capsys):
    main(["sysinfo"])
    out = capsys.readouterr().out
    assert f"torch: {torch.__version__}" in out
    assert f"CUDA devices: {torch.cuda.device_count()}" in out


def test_the_card_is_the_default_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    target = _wav(str(tmp_path / "word.wav"), 24, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["plan", "--target", target, "--save", str(tmp_path / "w")])


@pytest.mark.parametrize("argv,needs", [
    (["synth", "--cps", "t.txt", "--out", "o.wav"], "read_cp"),
    (["seg2wav", "--seg", "w.seg", "--out", "o.wav"], "seg_to_cps"),
    (["speaker-import", "JD3.speaker", "-o", "jd3.ini"], "speaker_import"),
    (["plan", "--target", "w.wav", "--save", "w", "--visualize"],
     "visualize.py"),
])
def test_unported_commands_exit_with_an_error(argv, needs, tmp_path,
                                              monkeypatch):
    """They name ROADMAP item 12 and what they need, and write nothing."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        main(argv)
    message = str(exc.value.code)
    assert "item 12" in message and needs in message
    assert os.listdir(tmp_path) == []


def test_module_entry_point_exits_non_zero():
    res = subprocess.run(
        [sys.executable, "-m", "paule_tpu_torch", "synth", "--cps", "t.txt",
         "--out", "o.wav"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert res.returncode != 0 and "item 12" in res.stderr
