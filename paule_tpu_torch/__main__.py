"""Command-line interface of the port: ``python -m paule_tpu_torch
<command>`` (counterpart of ``paule_tpu/__main__.py``).

    python -m paule_tpu_torch sysinfo
    python -m paule_tpu_torch plan --target word.wav --save out/word
    python -m paule_tpu_torch corpus --data-dir corpus/ --save-dir out/
    python -m paule_tpu_torch corpus --data-dir corpus/ --save-dir out/ \\
        --batched 8
    python -m paule_tpu_torch babble --n 100 --out babble.pkl

The model (and ``babble``'s log-mels) runs on the card (``--device cuda``,
the default, which fails without one) or, with ``--device cpu``, on the
CPU.  ``synth``, ``seg2wav``, ``speaker-import`` and ``plan --visualize``
are not ported yet: they exit with an error naming their ROADMAP.md item
and run nothing.
"""

import argparse
import os
import pickle
import sys

#: the message of a command that is not ported yet
NOT_PORTED = ("{what} is not ported yet (ROADMAP.md, 'Modules to port', "
              "item 12: {needs})")


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

    if args.visualize:
        raise SystemExit(NOT_PORTED.format(
            what="plan --visualize", needs="paule_tpu/visualize.py"))
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


def _not_ported(what, needs):
    def fn(_args):
        raise SystemExit(NOT_PORTED.format(what=what, needs=needs))
    return fn


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
    p.set_defaults(fn=_not_ported("synth", "synth.read_cp"))

    p = sub.add_parser("seg2wav",
                       help="segment file -> gestures -> cps -> audio")
    p.add_argument("--seg", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=_not_ported("seg2wav", "synth.seg_to_cps"))

    p = sub.add_parser(
        "speaker-import",
        help="convert a VocalTractLab XML speaker to the INI speaker format")
    p.add_argument("src", help="VTL XML .speaker file")
    p.add_argument("-o", "--out", required=True, help="output INI path")
    p.add_argument("--name", default=None)
    p.add_argument("--base-length", type=float, default=None)
    p.add_argument("--voiceless", default=None)
    p.add_argument("--fit-tube", action="store_true")
    p.add_argument("--fit-tube-lib", default=None)
    p.set_defaults(fn=_not_ported("speaker-import",
                                  "paule_tpu/synth/speaker_import.py"))
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
