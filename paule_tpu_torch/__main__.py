"""Command-line interface of the port: ``python -m paule_tpu_torch
<command>`` (counterpart of ``paule_tpu/__main__.py``).

    python -m paule_tpu_torch sysinfo
    python -m paule_tpu_torch plan --target word.wav --save out/word
    python -m paule_tpu_torch corpus --data-dir corpus/ --save-dir out/
    python -m paule_tpu_torch corpus --data-dir corpus/ --save-dir out/ \\
        --batched 8
    python -m paule_tpu_torch babble --n 100 --out babble.pkl
    python -m paule_tpu_torch synth --cps traj.txt --out out.wav
    python -m paule_tpu_torch seg2wav --seg word.seg --out word.wav
    python -m paule_tpu_torch speaker-import JD3.speaker -o jd3.speaker

The model (and ``babble``'s log-mels) runs on the card (``--device cuda``,
the default, which fails without one) or, with ``--device cpu``, on the
CPU; ``synth``, ``seg2wav`` and ``speaker-import`` run on the host.
``plan --visualize`` also writes the plots of
:func:`paule_tpu_torch.visualize.visualize_results` (matplotlib needed).
``plan`` and ``corpus`` with ``--trace PATH`` trace every planning call
(:mod:`paule_tpu_torch.tracing`) and write the call records, the last 64,
to ``PATH`` as JSON lines when the command ends.
"""

import argparse
import contextlib
import json
import os
import pickle
import sys


def _add_plan_args(p):
    p.add_argument("--objective", default="acoustic_semvec",
                   choices=["acoustic", "semvec", "acoustic_semvec"])
    p.add_argument("--initialize-from", default="acoustic",
                   choices=["acoustic", "semvec"])
    p.add_argument("--n-outer", type=int, default=10)
    p.add_argument("--n-inner", type=int, default=25)
    p.add_argument("--log-ii", type=int, default=1)
    p.add_argument("--n-batches", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--n-epochs", type=int, default=10)
    p.add_argument("--no-continue-learning", action="store_true")
    p.add_argument("--use-speech-classifier", action="store_true")
    p.add_argument("--use-somatosensory-feedback", action="store_true")
    p.add_argument("--smiling", action="store_true")
    p.add_argument("--pretrained-dir", default=None)
    p.add_argument("--load-state", default=None,
                   help="checkpoint from a previous run (Paule.save_state)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the models (default: cuda)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="trace every planning call and write the call "
                        "records to PATH as JSON lines")


@contextlib.contextmanager
def _traced(path):
    """With ``path``, every planning call inside the block is traced, and
    the finished call records are written to ``path``, one JSON object a
    line, when the block ends."""
    if not path:
        yield
        return
    from . import tracing

    tracing.clear()
    tracing.enable()
    try:
        yield
    finally:
        tracing.enable(False)
        with open(path, "w") as fh:
            for rec in tracing.calls():
                fh.write(json.dumps(rec) + "\n")


def _make_paule(args):
    from .api import Paule

    kw = dict(use_speech_classifier=args.use_speech_classifier,
              use_somatosensory_feedback=args.use_somatosensory_feedback,
              smiling=args.smiling, pretrained_dir=args.pretrained_dir,
              device=args.device)
    if args.seed is not None:
        kw["seed"] = args.seed
    model = Paule(**kw)
    if args.load_state:
        model.load_state(args.load_state)
    return model


def cmd_sysinfo(_args):
    from . import sysinfo

    sysinfo()


def cmd_plan(args):
    from .dsp import audio as audio_io

    model = _make_paule(args)
    try:
        results = model.plan_resynth(
            target_acoustic=args.target, objective=args.objective,
            initialize_from=args.initialize_from, n_outer=args.n_outer,
            n_inner=args.n_inner, log_ii=args.log_ii,
            n_batches=args.n_batches, batch_size=args.batch_size,
            n_epochs=args.n_epochs,
            continue_learning=not args.no_continue_learning,
            verbose=not args.quiet)
        save = args.save
        os.makedirs(os.path.dirname(save) or ".", exist_ok=True)
        with open(save + ".pkl", "wb") as fh:
            pickle.dump(results, fh, protocol=4)
        audio_io.write(save + "_planned.flac", results.prod_sig,
                       results.prod_sr)
        model.save_state(save + "_state.pkl")
        if args.visualize:
            from . import visualize

            visualize.visualize_results(results, os.path.basename(save),
                                        os.path.dirname(save) or ".")
    finally:
        model.close()
    print(f"saved {save}.pkl (+ audio, + model state)")


def cmd_corpus(args):
    from . import experiments

    files = experiments.discover_targets(args.data_dir,
                                         save_dir=args.save_dir)
    if not files:
        print("nothing to plan (all results exist)")
        return
    model = _make_paule(args)
    try:
        if args.batched:
            _corpus_batched(args, model, files)
            return
        experiments.plan_corpus(
            model, files, args.save_dir,
            plan_kwargs=dict(
                objective=args.objective,
                initialize_from=args.initialize_from, n_outer=args.n_outer,
                n_inner=args.n_inner, log_ii=args.log_ii,
                n_batches=args.n_batches, batch_size=args.batch_size,
                n_epochs=args.n_epochs,
                continue_learning=not args.no_continue_learning),
            verbose=not args.quiet)
    finally:
        model.close()
    try:
        final = experiments.collect_results(args.save_dir)
    except ImportError:
        print(f"results are under {args.save_dir}; collecting them into a "
              "table needs pandas")
        return
    print(final[["file", "label", "prod_loss"]].to_string(index=False))


def _corpus_batched(args, model, files):
    """Batches of up to ``--batched`` utterances of one mel length; each
    utterance's result is written to ``<save_dir>/<label>/<stem>_batched.pkl``
    as its batch completes, so an interrupted run resumes."""
    from . import experiments

    def save_result(i, res):
        out_dir = os.path.join(args.save_dir, experiments.label_of(files[i]))
        os.makedirs(out_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(files[i]))[0]
        with open(os.path.join(out_dir, stem + "_batched.pkl"), "wb") as fh:
            pickle.dump(res, fh, protocol=4)

    results = experiments.plan_corpus_batched(
        model, files, max_batch=args.batched,
        plan_kwargs=dict(
            objective=args.objective, n_outer=args.n_outer,
            n_inner=args.n_inner,
            continue_learning=not args.no_continue_learning,
            batch_size=args.batch_size, n_epochs=args.n_epochs),
        verbose=not args.quiet, on_result=save_result)
    losses = [float(r["prod_loss_curve"][-1]) for r in results]
    print(f"planned {len(results)} utterances; "
          f"final prod loss mean {sum(losses) / len(losses):.4f}")


def cmd_babble(args):
    """A motor-babbling corpus, pickled as the JAX package's ``babble``
    writes it: a pandas DataFrame (pandas is needed here only)."""
    import pandas as pd

    from . import pretrain

    corpus = pretrain.babble_corpus(
        args.n, seq_len=(args.min_len, args.max_len), seed=args.seed,
        n_workers=args.workers, device=args.device)
    df = pd.DataFrame(corpus)
    df.to_pickle(args.out, protocol=4)
    print(f"wrote {len(df)} babbled utterances to {args.out}")


def _write_audio(cps, out):
    from . import synth
    from .dsp import audio as audio_io

    sig, sr = synth.speak(cps)
    path = audio_io.write(out, sig, sr)
    print(f"wrote {path} ({len(sig) / sr:.2f} s)")


def cmd_synth(args):
    from . import synth

    _write_audio(synth.read_cp(args.cps), args.out)


def cmd_seg2wav(args):
    from . import synth

    _write_audio(synth.seg_to_cps(args.seg), args.out)


def cmd_speaker_import(args):
    from .synth import speaker_import

    voiceless = [v for v in (args.voiceless or "").split(",") if v]
    tube_fit = None
    if args.fit_tube:
        from .synth import vtl_plant

        lib = args.fit_tube_lib or vtl_plant.DEFAULT_LIB
        if not vtl_plant.vtl_available(lib, args.src):
            raise SystemExit(
                "--fit-tube needs a VocalTractLab library to sample "
                f"(none at {lib})")
        plant = vtl_plant.VTLPlant(lib_path=lib, speaker_path=args.src)
        parsed = speaker_import.parse_vtl_speaker(args.src)
        tube_fit = speaker_import.fit_tract_affine(
            parsed, plant.tract_to_tube, n_samples=2200, shape_weight=12)
        print(f"fitted [tract_affine]: {tube_fit['diagnostics']}")
    speaker_import.import_speaker(
        args.src, args.out, name=args.name,
        base_length_cm=args.base_length, voiceless=voiceless,
        tube_fit=tube_fit)
    print(f"wrote {args.out}")


def build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m paule_tpu_torch",
        description="predictive articulatory speech synthesis on PyTorch "
                    "and CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("sysinfo").set_defaults(fn=cmd_sysinfo)

    p = sub.add_parser("plan", help="plan one utterance")
    p.add_argument("--target", required=True, help="wav/flac target")
    p.add_argument("--save", required=True, help="output path prefix")
    p.add_argument("--visualize", action="store_true")
    _add_plan_args(p)
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("corpus", help="plan a corpus (resume-safe)")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--save-dir", required=True)
    p.add_argument("--batched", type=int, default=0, metavar="B",
                   help="plan in batches of up to B utterances of one mel "
                        "length (0 = one at a time)")
    _add_plan_args(p)
    p.set_defaults(fn=cmd_corpus)

    p = sub.add_parser("babble", help="generate a motor-babbling corpus")
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--min-len", type=int, default=40)
    p.add_argument("--max-len", type=int, default=120)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device of the log-mels (default: cuda)")
    p.set_defaults(fn=cmd_babble)

    p = sub.add_parser("synth", help="synthesize a cp trajectory file")
    p.add_argument("--cps", required=True,
                   help="tract-sequence file (read_cp format)")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("seg2wav",
                       help="segment file -> gestures -> cps -> audio")
    p.add_argument("--seg", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_seg2wav)

    p = sub.add_parser(
        "speaker-import",
        help="convert a VocalTractLab XML speaker to the INI speaker format")
    p.add_argument("src", help="VTL XML .speaker file")
    p.add_argument("-o", "--out", required=True, help="output INI path")
    p.add_argument("--name", default=None, help="speaker name")
    p.add_argument("--base-length", type=float, default=None,
                   help="override the estimated tract length (cm)")
    p.add_argument("--voiceless", default=None,
                   help="comma-separated shape names to emit voiced=0")
    p.add_argument("--fit-tube", action="store_true",
                   help="fit a [tract_affine] tube map against the "
                        "VocalTractLab library's vtlTractToTube")
    p.add_argument("--fit-tube-lib", default=None,
                   help="path to libVocalTractLabApi.so for --fit-tube")
    p.set_defaults(fn=cmd_speaker_import)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    with _traced(getattr(args, "trace", None)):
        args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
