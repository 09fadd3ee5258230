"""Corpus-scale quality of the port's plans, on the card (the port's
counterpart of ``tools/corpus_quality_run.py``).

1. Bootstraps the forward and inverse models of ``Paule(seed=2)`` by motor
   babbling (:func:`paule_tpu_torch.pretrain.babble_corpus`,
   ``train_forward``, ``train_inverse``);
2. builds the seeded evaluation corpus (``default_rng(42)``, cp lengths
   :data:`LENGTHS` in turn, ``pretrain.random_cp_trajectory``);
3. measures the produced loss of each utterance's inverse-model
   initialisation, then plans the corpus with
   ``experiments.plan_corpus_batched(max_batch=8)`` and reports the final
   produced-loss distribution and the corpus wall;
4. plans one long utterance twice, in one shot and with
   ``plan_iterative`` (chunks of 64 mel frames, overlap 8).

Settings, as the JAX tool reads them from the environment: ``CORPUS_N``
(50), ``CORPUS_OUTER`` (10), ``CORPUS_INNER`` (25), ``CORPUS_BABBLE``
(120), ``CORPUS_BABBLE_EPOCHS`` (12).

Run on the card::

    python -m paule_tpu_torch.tools.corpus_quality_run [--out FILE]

Prints one JSON line (with the card's name and power limit); without a
card it raises.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

from .. import pretrain, synth
from ..api import Paule, _np
from ..dsp.mel import librosa_melspec
from ..experiments import plan_corpus_batched
from ..ops.normalize import inv_normalize_cp, normalize_mel
from . import timing

#: cp-frame lengths (even): few distinct values, so that exact-length
#: buckets batch well (``plan_corpus_batched`` buckets by mel length)
LENGTHS = (80, 120, 160, 200)
#: cp frames of the long utterance of step 4
N_LONG = 400


def settings(env=os.environ):
    """The JAX tool's environment settings (``tools/corpus_quality_run.py:
    27-31``) as :func:`run`'s keywords."""
    return {"n_utt": int(env.get("CORPUS_N", "50")),
            "n_outer": int(env.get("CORPUS_OUTER", "10")),
            "n_inner": int(env.get("CORPUS_INNER", "25")),
            "babble_n": int(env.get("CORPUS_BABBLE", "120")),
            "babble_epochs": int(env.get("CORPUS_BABBLE_EPOCHS", "12"))}


def log(msg):
    print(f"[corpus] {msg}", file=sys.stderr, flush=True)


def corpus_cps(n_utt, lengths=LENGTHS, seed=42):
    """The evaluation corpus's normalised cp trajectories, utterance ``i``
    of ``lengths[i % len(lengths)]`` frames.  -> ``(cps, rng)``, the
    generator where the corpus left it."""
    rng = np.random.default_rng(seed)
    cps = [pretrain.random_cp_trajectory(rng, lengths[i % len(lengths)])
           for i in range(n_utt)]
    return cps, rng


def prod_loss_of(planned_cp, target, speak, *, device, dtype):
    """The planner's produced loss of ``planned_cp`` against the audio
    ``target``: 5 x the RMSE of the produced mel against the target mel,
    the target min-shifted to 0 (the reference's convention), the
    produced mel not; ``speak`` synthesises a denormalised trajectory
    (``tools/corpus_quality_run.py:86-95``)."""
    tmel = normalize_mel(librosa_melspec(*target, device=device,
                                         dtype=dtype))
    tmel = tmel - tmel.min()
    psig, psr = speak(inv_normalize_cp(np.asarray(planned_cp)))
    pmel = normalize_mel(librosa_melspec(psig, psr, device=device,
                                         dtype=dtype))
    n = min(len(tmel), len(pmel))
    return 5.0 * float(np.sqrt(np.mean((pmel[:n] - tmel[:n]) ** 2)))


def inverse_init(model, target):
    """The inverse model's trajectory of ``target``'s (unshifted)
    normalised mel, clipped to +-1: where the batched planner starts."""
    tmel = normalize_mel(librosa_melspec(*target, device=model.device,
                                         dtype=model.dtype))
    with torch.no_grad():
        cp = model.inv_model(model._tensor(tmel[None]))
    return np.clip(_np(cp)[0], -1.0, 1.0)


def quantiles(values):
    return {"median": float(np.median(values)),
            "mean": float(np.mean(values)),
            "p10": float(np.percentile(values, 10)),
            "p90": float(np.percentile(values, 90))}


def run(*, device="cuda", paule=None, n_utt=50, n_outer=10, n_inner=25,
        babble_n=120, babble_epochs=12, n_long=N_LONG):
    """The four stages above.  ``paule``: the instance to train and plan
    with (default ``Paule(seed=2)`` on ``device``, closed afterwards).
    -> the summary as a JSON-able dict."""
    device = timing.open_device(device)
    t_start = time.perf_counter()
    model = paule if paule is not None else Paule(seed=2, device=device)
    pool = synth.SynthPool(size=4)
    # the produced audio on an instance of its own, which synthesises
    # nothing else (the JAX tool's use of its module's instance)
    producer = synth.SynthPool(size=1)
    try:
        # ---- 1. babble-bootstrap the forward and inverse proxies ----
        log(f"babbling {babble_n} utterances...")
        corpus_train = pretrain.babble_corpus(
            babble_n, seq_len=(40, 160), seed=1, pool=pool,
            device=model.device, dtype=model.dtype)
        _fwd, losses = pretrain.train_forward(
            model.pred_model, corpus_train, batch_size=8,
            n_epochs=babble_epochs)
        _inv, inv_losses = pretrain.train_inverse(
            model.inv_model, corpus_train, batch_size=8,
            n_epochs=babble_epochs)
        log(f"forward {losses[0]:.4f} -> {losses[-1]:.4f}, inverse "
            f"{inv_losses[0]:.4f} -> {inv_losses[-1]:.4f}")

        # ---- 2. the evaluation corpus ----
        cps, rng = corpus_cps(n_utt)
        targets = [pool.speak(inv_normalize_cp(cp)) for cp in cps]

        def loss_of(cp, target):
            return prod_loss_of(cp, target, producer.speak,
                                device=model.device, dtype=model.dtype)

        init_losses = np.array([loss_of(inverse_init(model, t), t)
                                for t in targets])
        log(f"inverse-init median produced loss "
            f"{np.median(init_losses):.3f}")

        # ---- 3. batched corpus planning ----
        plan_kwargs = dict(objective="acoustic", n_outer=n_outer,
                           n_inner=n_inner, continue_learning=True,
                           batch_size=8, n_epochs=5)
        t_corpus, results = timing.wall_s(
            lambda: plan_corpus_batched(model, targets, max_batch=8,
                                        plan_kwargs=plan_kwargs,
                                        verbose=False), device)
        final = np.array([float(r["prod_loss_curve"][-1]) for r in results])
        first = np.array([float(r["prod_loss_curve"][0]) for r in results])
        improved = float(np.mean(final < init_losses))
        log(f"corpus planned in {t_corpus:.1f} s; median final loss "
            f"{np.median(final):.3f}")

        # ---- 4. plan_iterative against one shot on a long utterance ----
        cp_long = pretrain.random_cp_trajectory(rng, n_long)
        long_target = pool.speak(inv_normalize_cp(cp_long))
        budget = dict(objective="acoustic", n_outer=n_outer, n_inner=n_inner,
                      log_ii=n_inner, continue_learning=False, verbose=False)
        r_single = model.plan_resynth(target_acoustic=long_target,
                                      initialize_from="acoustic", **budget)
        loss_single = loss_of(r_single.planned_cp, long_target)
        planned_chunked, _chunks = model.plan_iterative(
            target_acoustic=long_target, chunk_size=64, overlap=8, **budget)
        loss_chunked = loss_of(planned_chunked, long_target)
        log(f"single-shot {loss_single:.3f} vs chunked {loss_chunked:.3f}")
    finally:
        pool.close()
        producer.close()
        if paule is None:
            model.close()

    return {
        "n_utterances": n_utt,
        "budget": plan_kwargs,
        "babble": {"n": babble_n, "epochs": babble_epochs,
                   "train_loss_first": float(losses[0]),
                   "train_loss_last": float(losses[-1]),
                   "inv_loss_first": float(inv_losses[0]),
                   "inv_loss_last": float(inv_losses[-1])},
        "corpus_wall_s": t_corpus,
        "final_prod_loss": quantiles(final),
        "outer1_prod_loss_median": float(np.median(first)),
        "preplan_prod_loss_median": float(np.median(init_losses)),
        "fraction_better_than_preplan": improved,
        "long_utterance": {
            "cp_frames": 2 * (1 + n_long * 110 // 220),
            "single_shot_loss": loss_single,
            "chunked_loss": loss_chunked,
            "chunked_over_single": loss_chunked / loss_single,
        },
        "per_utterance": {"final": final.tolist(), "outer1": first.tolist(),
                          "preplan": init_losses.tolist()},
        "total_wall_s": time.perf_counter() - t_start,
        **timing.labels(device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    timing.emit(run(device="cuda", **settings()), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
