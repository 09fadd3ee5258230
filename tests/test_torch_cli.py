"""The port's command line (``python -m paule_tpu_torch``) on the CPU:
``plan`` (also with ``--visualize``) and ``corpus --batched`` write their
results; ``babble``, ``synth``, ``seg2wav`` and ``speaker-import`` write
what the JAX package's commands write; ``sysinfo`` prints, and the card
is the default device."""

import json
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


@pytest.mark.parametrize("command", ["plan", "corpus"])
def test_trace_writes_one_record_a_line(tmp_path, command):
    """``--trace PATH``: the call records as JSON lines, the leaves named
    ``<scope>.<phase>.<leaf>``; tracing is off again afterwards."""
    from paule_tpu_torch import tracing

    trace = str(tmp_path / "trace.jsonl")
    if command == "plan":
        argv = ["plan", "--target", _wav(str(tmp_path / "w.wav"), 24, 0),
                "--save", str(tmp_path / "out" / "w")]
        scopes = ["plan_resynth"]
    else:
        for name, seed in (("ba/u1_ba", 1), ("ba/u2_ba", 2)):
            _wav(str(tmp_path / "data" / f"{name}.wav"), 24, seed)
        argv = ["corpus", "--data-dir", str(tmp_path / "data"),
                "--save-dir", str(tmp_path / "save"), "--batched", "2"]
        scopes = ["plan_batch_resynth"]
    main([*argv, *TINY, "--trace", trace])
    assert not tracing.ON and not tracing._enabled
    with open(trace) as fh:
        records = [json.loads(line) for line in fh]
    assert [r["scope"] for r in records] == scopes
    leaves = [s["name"] for s in records[0]["spans"] if s["kind"] == "leaf"]
    first = "enqueue" if command == "plan" else "shards"
    assert f"{scopes[0]}.planning.{first}" in leaves
    assert records[0]["ops"] and records[0]["counters"]["snapshots"] > 0


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


def _cp_file(path):
    """A tract-sequence file (``read_cp``'s format) of a short word."""
    seg = path.parent / "cp_source.seg"
    seg.write_text("a 0.06\ni 0.06\n")
    cps = synth.seg_to_cps(str(seg))
    lines = ["#"] * 6 + ["Geometric glottis", str(len(cps))]
    for row in cps:
        lines.append(" ".join(f"{v:.17g}" for v in row[19:]))
        lines.append(" ".join(f"{v:.17g}" for v in row[:19]))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("argv,needs", [
    (["synth", "--cps", "t.txt", "--out", "o.wav"], "read_cp"),
    (["seg2wav", "--seg", "w.seg", "--out", "o.wav"], "seg_to_cps"),
    (["speaker-import", "JD3.speaker", "-o", "jd3.ini"], "speaker_import"),
    (["plan", "--target", "w.wav", "--save", "w", "--visualize"],
     "visualize.py"),
])
def test_unported_commands_exit_with_an_error(argv, needs, tmp_path,
                                              monkeypatch, capsys):
    """The commands that exited naming ROADMAP item 12 until they were
    ported (``needs`` names what they needed) now run: ``synth``,
    ``seg2wav`` and ``speaker-import`` write what the JAX package's
    commands write (byte for byte), ``plan --visualize`` (on the CPU) also
    writes the plots of ``visualize_results``."""
    from paule_tpu.__main__ import main as jax_main
    from test_torch_speaker_import import write_vtl_speaker

    monkeypatch.chdir(tmp_path)
    out = argv[argv.index("-o" if "-o" in argv else "--out") + 1] \
        if argv[0] != "plan" else None
    if needs == "read_cp":
        _cp_file(tmp_path / "t.txt")
    elif needs == "seg_to_cps":
        (tmp_path / "w.seg").write_text("name = a; duration_s = 0.10;\n"
                                        "name = t; duration_s = 0.05;\n")
    elif needs == "speaker_import":
        write_vtl_speaker(tmp_path / "JD3.speaker")
    else:
        _wav(str(tmp_path / "w.wav"), 24, 0)
        main(argv + TINY)
        assert "saved" in capsys.readouterr().out
        files = set(os.listdir(tmp_path))
        for name in ("w.pkl", "w_state.pkl", "w_mel.png", "w_loss.png",
                     "w_cps.png", "w_planned.wav", "w_target.wav"):
            assert name in files, name
        assert os.listdir(tmp_path / "w_planned_svgs")
        return
    main(argv)
    assert "wrote" in capsys.readouterr().out
    ported = (tmp_path / out).read_bytes()
    jax_argv = [a if a != out else "jax_" + out for a in argv]
    jax_main(jax_argv)
    assert ported == (tmp_path / ("jax_" + out)).read_bytes()
    assert len(ported) > 1000


def test_speaker_import_fit_tube_needs_the_library(tmp_path, monkeypatch):
    """``--fit-tube`` without a VocalTractLab library exits before writing,
    naming the library it looked for."""
    from test_torch_speaker_import import write_vtl_speaker

    src = write_vtl_speaker(tmp_path / "x.speaker")
    lib = str(tmp_path / "libVocalTractLabApi.so")
    with pytest.raises(SystemExit) as exc:
        main(["speaker-import", src, "-o", str(tmp_path / "x.ini"),
              "--fit-tube", "--fit-tube-lib", lib])
    assert "--fit-tube needs a VocalTractLab library" in str(exc.value.code)
    assert lib in str(exc.value.code)
    assert not (tmp_path / "x.ini").exists()


def test_module_entry_point_exits_non_zero():
    """A missing input file fails the command with a non-zero exit."""
    res = subprocess.run(
        [sys.executable, "-m", "paule_tpu_torch", "synth", "--cps",
         "no_such_trajectory.txt", "--out", "o.wav"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert res.returncode != 0 and "no_such_trajectory.txt" in res.stderr
    assert not os.path.exists(os.path.join(REPO, "o.wav"))
