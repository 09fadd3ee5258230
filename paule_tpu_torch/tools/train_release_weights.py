"""Train every model of a pretrained-weight release from nothing with the
port, and write the release (the port's copy of the JAX package's recipe,
``tools/train_release_weights.py``; same stages, order, widths and batch).

* a corpus: a synthetic lexicon (``classes`` word classes, each a prototype
  articulation with ``variants`` variants and a unit-norm 300-dim semantic
  vector) plus ``babble`` extra babbled utterances, synthesised with tube
  extraction;
* the forward model ``ForwardModel(1, 720)``, the inverse model
  ``InverseModelMelTimeSmoothResidual(1, 720)``, the embedder
  ``EmbeddingModel(2, 720)``, the somatosensory trio (cp->tube and
  tube->mel at H=360, the tube embedder at H=720), the speech classifier
  ``LinearClassifier`` (babble against silence, noise and hum) and the cp
  and mel ``Generator`` + ``Critic`` WGAN-GP pairs, all at batch 16 with
  only full batches;
* the release, through :func:`paule_tpu_torch.release.save_release`, in the
  layout both packages load.

    python -m paule_tpu_torch.tools.train_release_weights --device cuda \\
        --out releases/paule_torch_release_v1.npz

The sizes come from the JAX recipe's environment variables
(``RELEASE_CLASSES``, ``RELEASE_VARIANTS``, ``RELEASE_BABBLE``,
``RELEASE_EPOCHS_FWD``, ``_INV``, ``_EMB``, ``_TUBE``, ``_GAN``, ``_CLS``).
Each stage's result is kept in ``.release_work_torch/`` (or
``RELEASE_WORK_DIR``), so an interrupted run resumes.  One JSON line is
printed per stage (first and last epoch loss, Adam steps, seconds, ms per
step) and one for the release.  The output may not be the JAX package's
``paule_tpu/pretrained_weights/``.
"""

import argparse
import collections
import contextlib
import copy
import json
import os
import pickle
import random
import sys
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from .. import pretrain, release, synth
from ..dsp.mel import librosa_melspec
from ..models import (Critic, EmbeddingModel, ForwardModel, Generator,
                      InverseModelMelTimeSmoothResidual, LinearClassifier)
from ..models.blocks import init_random
from ..ops import losses as L
from ..ops.normalize import normalize_mel
from ..ops.padding import pad_batch
from ..planning.trainer import build_length_dict, mean_or_nan

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 20260820
VAL_PER_CLASS = 2
#: the recipe's sizes (``tools/train_release_weights.py:45-66``)
DEFAULTS = {
    "classes": 120, "variants": 12, "babble": 360,
    "class_lengths": (40, 60, 80, 100, 120),
    "babble_lengths": (80, 120, 160, 200),
    "epochs": {"forward": 40, "inverse": 40, "embedder": 40, "tube": 30,
               "gan": 40, "classifier": 30},
    "batch": 16, "n_critic": 5,
}
_ENV = {"classes": "RELEASE_CLASSES", "variants": "RELEASE_VARIANTS",
        "babble": "RELEASE_BABBLE"}
_ENV_EPOCHS = {"forward": "FWD", "inverse": "INV", "embedder": "EMB",
               "tube": "TUBE", "gan": "GAN", "classifier": "CLS"}


def settings(env=os.environ):
    """:data:`DEFAULTS` with the ``RELEASE_*`` overrides of ``env``."""
    cfg = copy.deepcopy(DEFAULTS)
    for key, var in _ENV.items():
        cfg[key] = int(env.get(var, cfg[key]))
    for key, var in _ENV_EPOCHS.items():
        cfg["epochs"][key] = int(env.get(f"RELEASE_EPOCHS_{var}",
                                         cfg["epochs"][key]))
    return cfg


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------

def build_corpus(cfg, device, dtype=torch.float32):
    """The lexicon and the babble, synthesised with their tubes: a dict of
    column lists ``cp_norm``, ``melspec_norm_synthesized``, ``tube_norm``,
    ``vector`` (``None`` for babble), and numpy ``class_id`` (-1 for
    babble) and ``split`` (``"train"`` or ``"val"``)."""
    rng = np.random.default_rng(SEED)
    vectors = rng.normal(0, 1, (cfg["classes"], 300))
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    cps, vecs, class_ids, split_of = [], [], [], []
    for c in range(cfg["classes"]):
        n = int(rng.choice(cfg["class_lengths"]))
        proto = pretrain.random_cp_trajectory(rng, n)
        for k in range(cfg["variants"]):
            jitter = pretrain.random_cp_trajectory(rng, n, walk_scale=0.03)
            cps.append(np.clip(proto + 0.35 * jitter, -1.0, 1.0))
            vecs.append(vectors[c])
            class_ids.append(c)
            split_of.append("val" if k < VAL_PER_CLASS else "train")
    for b in range(cfg["babble"]):
        n = int(rng.choice(cfg["babble_lengths"]))
        cps.append(pretrain.random_cp_trajectory(rng, n))
        vecs.append(None)
        class_ids.append(-1)
        split_of.append("val" if b % 6 == 0 else "train")
    pool = synth.SynthPool(size=4)
    try:
        sounds = pretrain.synthesize_by_length(pool, cps, with_tube=True)
    finally:
        pool.close()
    mels, tubes = [], []
    for i, (sig, sr, tube_info) in enumerate(sounds):
        mel = normalize_mel(librosa_melspec(sig, sr, device=device,
                                            dtype=dtype))
        tube = synth.tube_features(tube_info)
        if not (np.isfinite(mel).all() and np.isfinite(tube).all()):
            raise ValueError(f"utterance {i}: non-finite mel or tube")
        mels.append(mel.astype(np.float32))
        tubes.append(tube.astype(np.float32))
    return {"cp_norm": cps, "melspec_norm_synthesized": mels,
            "tube_norm": tubes, "vector": vecs,
            "class_id": np.array(class_ids), "split": np.array(split_of)}


def rows(corpus, mask):
    """The rows of ``corpus`` where the boolean ``mask`` holds."""
    idx = np.flatnonzero(mask)
    return {k: v[idx] if isinstance(v, np.ndarray) else [v[i] for i in idx]
            for k, v in corpus.items()}


def splits(corpus):
    """-> ``{"train", "val", "lex_train", "lex_val"}`` row subsets."""
    lex = corpus["class_id"] >= 0
    train = corpus["split"] == "train"
    return {"train": rows(corpus, train), "val": rows(corpus, ~train),
            "lex_train": rows(corpus, train & lex),
            "lex_val": rows(corpus, ~train & lex)}


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

class Context:
    """Where the stages run, and the models they start from: each made on
    ``device`` in ``dtype`` with a seeded random initialisation, its
    initial parameter tree kept in :attr:`initial` under its key.  On the
    card, matmuls and convolutions run in full float32, as in
    :class:`paule_tpu_torch.api.Paule` (no TF32)."""

    def __init__(self, cfg, device, dtype=torch.float32):
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        self.generator = torch.Generator().manual_seed(SEED)
        self.initial = {}
        #: the corpus's row subsets (:func:`splits`), once :func:`run` made
        #: them
        self.data = None
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def model(self, key, module):
        module.to(device=self.device, dtype=self.dtype)
        init_random(module, self.generator)
        self.initial[key] = release.params_to_jax(module)
        return module

    def fit(self, name):
        """Keyword arguments every ``pretrain.train_*`` call shares."""
        return dict(batch_size=self.cfg["batch"],
                    n_epochs=self.cfg["epochs"][name], exact_batch_only=True)


def val_loss(model, inps, tgts, loss):
    """Mean per-utterance loss (``"rmse"`` or ``"cp_trajectory"``) at
    batch 1."""
    fn = L.rmse if loss == "rmse" else (
        lambda a, b: L.cp_trajectory_loss(a, b)[0])
    dev, dtype = next(model.parameters()).device, next(
        model.parameters()).dtype
    with torch.no_grad():
        vals = [fn(model(torch.as_tensor(x, dtype=dtype, device=dev)[None]),
                   torch.as_tensor(y, dtype=dtype, device=dev)[None])
                for x, y in zip(inps, tgts)]
    return float(torch.stack(vals).mean())


def stage_forward(ctx, data):
    m = ctx.model("predictive", ForwardModel(num_lstm_layers=1,
                                             hidden_size=720))
    m, losses = pretrain.train_forward(m, data["train"], **ctx.fit("forward"))
    val = data["val"]
    return {"predictive": m}, losses, {"val_rmse": val_loss(
        m, val["cp_norm"], val["melspec_norm_synthesized"], "rmse")}


def stage_inverse(ctx, data):
    m = ctx.model("inverse", InverseModelMelTimeSmoothResidual(
        num_lstm_layers=1, hidden_size=720))
    m, losses = pretrain.train_inverse(m, data["train"], **ctx.fit("inverse"))
    val = data["val"]
    return {"inverse": m}, losses, {"val_cp_trajectory": val_loss(
        m, val["melspec_norm_synthesized"], val["cp_norm"],
        "cp_trajectory")}


def stage_embedder(ctx, data):
    """MSE to the class vectors, and the validation rows' retrieval
    accuracy: the nearest class vector is the right class."""
    m = ctx.model("embedder", EmbeddingModel(num_lstm_layers=2,
                                             hidden_size=720))
    train, val = data["lex_train"], data["lex_val"]
    m, losses = pretrain.train_embedder(m, train, **ctx.fit("embedder"))
    with torch.no_grad():
        preds = np.concatenate([m(torch.as_tensor(
            x, dtype=ctx.dtype, device=ctx.device)[None]).cpu().numpy()
            for x in val["melspec_norm_synthesized"]])
    vecs = np.stack(val["vector"])
    first = {}
    for c, v in zip(train["class_id"], train["vector"]):
        first.setdefault(int(c), v)
    classes = np.stack([first[c] for c in sorted(first)])
    acc = np.mean(np.argmax(preds @ classes.T, 1) == val["class_id"])
    return {"embedder": m}, losses, {
        "val_mse": float(np.mean((preds - vecs) ** 2)),
        "val_class_retrieval": float(acc)}


def stage_tube(ctx, data):
    """cp -> tube and tube -> mel (H=360), and the tube embedder (H=720,
    dropout 0.7 in planning, trained without it)."""
    train, val, lex = data["train"], data["val"], data["lex_train"]
    fit = ctx.fit("tube")
    cp_tube = ctx.model("cp_tube", ForwardModel(
        num_lstm_layers=1, hidden_size=360, output_size=10, input_size=30,
        apply_half_sequence=False))
    cp_tube, l1 = pretrain.train_forward(
        cp_tube, dict(train, melspec_norm_synthesized=train["tube_norm"]),
        **fit)
    tube_mel = ctx.model("tube_mel", ForwardModel(
        num_lstm_layers=1, hidden_size=360, output_size=60, input_size=10,
        apply_half_sequence=True))
    tube_mel, l2 = pretrain.train_forward(
        tube_mel, dict(train, cp_norm=train["tube_norm"]), **fit)
    tube_emb = ctx.model("tube_embedder", EmbeddingModel(
        input_size=10, num_lstm_layers=2, hidden_size=720, dropout=0.7,
        post_upsampling_size=0))
    tube_emb, l3 = pretrain.train_embedder(tube_emb, lex,
                                           input_column="tube_norm", **fit)
    metrics = {
        "cp_tube_last": l1[-1], "tube_mel_last": l2[-1],
        "tube_embedder_last": l3[-1],
        "cp_tube_val_rmse": val_loss(cp_tube, val["cp_norm"],
                                     val["tube_norm"], "rmse"),
        "tube_mel_val_rmse": val_loss(tube_mel, val["tube_norm"],
                                      val["melspec_norm_synthesized"],
                                      "rmse")}
    # the stage's losses: the three models' epochs summed
    losses = [a + b + c for a, b, c in zip(l1, l2, l3)]
    return ({"cp_tube": cp_tube, "tube_mel": tube_mel,
             "tube_embedder": tube_emb}, losses, metrics)


def _negatives(mels, device, dtype):
    """One non-speech mel per positive, of its length: silence, noise of a
    random level, or a low hum, in turn."""
    rng = np.random.default_rng(7)
    out = []
    for i, mel in enumerate(mels):
        n_samples = (len(mel) * 2 - 1) * 110
        kind = i % 3
        if kind == 0:
            sig = np.zeros(n_samples)
        elif kind == 1:
            sig = rng.normal(0, 10 ** rng.uniform(-4, -1), n_samples)
        else:
            t = np.arange(n_samples) / 44100.0
            sig = 0.01 * np.sin(2 * np.pi * rng.uniform(30, 80) * t)
        out.append(normalize_mel(librosa_melspec(sig, 44100, device=device,
                                                 dtype=dtype)))
    return out


def stage_classifier(ctx, data):
    """``LinearClassifier``: binary cross entropy of babble and lexicon
    (speech) against silence, noise and hum, Adam (1e-3), full batches of
    one length; the validation rows' speech recall."""
    m = ctx.model("speech_classifier", LinearClassifier(input_dim=60,
                                                        output_dim=1))
    pos = data["train"]["melspec_norm_synthesized"]
    x = pretrain.to_device(pos + _negatives(pos, ctx.device, ctx.dtype),
                           ctx.device, ctx.dtype)
    y = torch.tensor([1.0] * len(pos) + [0.0] * len(pos),
                     dtype=ctx.dtype).to(ctx.device)
    lens = [len(s) for s in x]
    lens_t = torch.as_tensor(lens).to(ctx.device)
    length_dict = build_length_dict(lens)
    optimizer = torch.optim.Adam(m.parameters(), lr=1e-3)
    prng = random.Random(11)
    m.requires_grad_(True)
    losses = []
    for _ in range(ctx.cfg["epochs"]["classifier"]):
        epoch = []
        for idx in pretrain.epoch_batches(len(x), ctx.cfg["batch"],
                                          length_dict, prng, True):
            sel = torch.as_tensor(idx).to(ctx.device)
            logit = m(pad_batch([lens[i] for i in idx], [x[i] for i in idx]),
                      src_lens=lens_t[sel])
            loss = L.bce_with_logits(logit, y[sel])
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            epoch.append(loss.detach())
        losses.append(mean_or_nan(epoch, ctx.device))
    m.requires_grad_(False)
    with torch.no_grad():
        hits = [float(m(torch.as_tensor(v, dtype=ctx.dtype,
                                        device=ctx.device)[None],
                        src_lens=[len(v)])[0]) > 0
                for v in data["val"]["melspec_norm_synthesized"]]
    return ({"speech_classifier": m}, [float(v) for v in losses],
            {"val_speech_recall": float(np.mean(hits))})


def _gan(ctx, data, key, column, out_size):
    gen = ctx.model(key, Generator(output_size=out_size))
    cri = ctx.model(key + "_critic", Critic(input_size=out_size))
    gen, cri, losses = pretrain.train_gan(
        gen, cri, data["lex_train"], data_column=column,
        n_critic=ctx.cfg["n_critic"], **ctx.fit("gan"))
    return {key: gen, key + "_critic": cri}, losses, {
        "last_critic_gen": list(losses[-1])}


def stage_cp_gan(ctx, data):
    return _gan(ctx, data, "cp_gan", "cp_norm", 30)


def stage_mel_gan(ctx, data):
    return _gan(ctx, data, "mel_gan", "melspec_norm_synthesized", 60)


#: the stages in the recipe's order
STAGES = (("forward", stage_forward), ("inverse", stage_inverse),
          ("embedder", stage_embedder), ("tube", stage_tube),
          ("classifier", stage_classifier), ("cp_gan", stage_cp_gan),
          ("mel_gan", stage_mel_gan))


@contextlib.contextmanager
def count_adam_steps():
    """-> a Counter of optimizer steps taken inside the block, by the
    ``id`` of each optimizer's first parameter."""
    counts = collections.Counter()

    def hook(opt, _args, _kwargs):
        counts[id(opt.param_groups[0]["params"][0])] += 1

    handle = register_optimizer_step_post_hook(hook)
    try:
        yield counts
    finally:
        handle.remove()


def run_stage(ctx, name, fn, data, observe=None):
    """One stage, in a ``train_release_weights.<name>`` profiler range;
    -> ``(modules, report)``.  ``observe(name)``, a context manager, wraps
    the stage (a test's hook)."""
    guard = observe(name) if observe else contextlib.nullcontext()
    t0 = time.perf_counter()
    with guard, count_adam_steps() as counts, \
            torch.profiler.record_function(f"train_release_weights.{name}"):
        modules, losses, metrics = fn(ctx, data)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
    seconds = time.perf_counter() - t0
    steps = sum(counts.values())
    report = {"stage": name, "first_loss": losses[0],
              "last_loss": losses[-1], "adam_steps": steps,
              "seconds": seconds,
              "ms_per_step": seconds / steps * 1e3 if steps else None,
              **metrics}
    gens = [m for k, m in modules.items() if k in ("cp_gan", "mel_gan")]
    if gens:
        report["generator_steps"] = counts[id(next(gens[0].parameters()))]
    return modules, report


def _load(work_dir, name):
    """A result this recipe kept in ``work_dir``, or ``None``."""
    if work_dir is None:
        return None
    path = os.path.join(work_dir, f"{name}.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        return pickle.load(fh)


def _keep(work_dir, name, value):
    if work_dir is not None:
        os.makedirs(work_dir, exist_ok=True)
        with open(os.path.join(work_dir, f"{name}.pkl"), "wb") as fh:
            pickle.dump(value, fh, protocol=pickle.HIGHEST_PROTOCOL)
    return value


def run(out, *, device="cuda", cfg=None, work_dir=None, observe=None,
        log=print):
    """The recipe: corpus, every stage, the release at ``out``.  ->
    ``(trained modules by key, the Context, report)``.  With ``work_dir``
    the corpus and each stage's trained trees and report are kept there,
    and a later run reuses them (a reused stage gives no modules)."""
    out = release.check_release_path(out)
    cfg = cfg or settings()
    ctx = Context(cfg, device)
    t_start = time.perf_counter()
    corpus = _load(work_dir, "corpus") or _keep(
        work_dir, "corpus", build_corpus(cfg, device))
    data = ctx.data = splits(corpus)
    report = {"corpus": {
        "classes": cfg["classes"], "variants": cfg["variants"],
        "babble_extra": cfg["babble"], "train": len(data["train"]["cp_norm"]),
        "val": len(data["val"]["cp_norm"]),
        "class_lengths": list(cfg["class_lengths"]),
        "babble_lengths": list(cfg["babble_lengths"])},
        "epochs": cfg["epochs"], "batch": cfg["batch"],
        "n_critic": cfg["n_critic"], "stages": []}
    log(json.dumps({"corpus": report["corpus"]}))
    modules, trees = {}, {}
    for name, fn in STAGES:
        kept = _load(work_dir, name)
        if kept is None:
            mods, rep = run_stage(ctx, name, fn, data, observe)
            modules.update(mods)
            kept = _keep(work_dir, name, (
                {k: release.params_to_jax(m) for k, m in mods.items()}, rep))
        trees.update(kept[0])
        report["stages"].append(kept[1])
        log(json.dumps(kept[1]))
    dev_name = (torch.cuda.get_device_name(ctx.device)
                if ctx.device.type == "cuda" else "CPU")
    path = release.save_release(
        {k: trees[k] for k in release.MODEL_KEYS}, path=out, metadata={
            "recipe": "paule_tpu_torch/tools/train_release_weights.py",
            "trained_on": f"{dev_name} (PyTorch {torch.__version__}), "
                          "synthetic babble + lexicon via the in-repo C++ "
                          "synthesizer",
            "seed": SEED})
    report["artifact"] = {"path": path, "sha256": release.sha256(path),
                          "size_mb": os.path.getsize(path) / 1e6,
                          "storage_dtype": "float16",
                          "total_wall_s": time.perf_counter() - t_start}
    log(json.dumps({"artifact": report["artifact"]}))
    return modules, ctx, report


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m paule_tpu_torch.tools.train_release_weights",
        description="train every model of a weight release from nothing")
    parser.add_argument("--out", required=True,
                        help="path of the release .npz to write")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    work = os.environ.get("RELEASE_WORK_DIR") or os.path.join(
        REPO, ".release_work_torch")
    run(args.out, device=args.device, work_dir=work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
