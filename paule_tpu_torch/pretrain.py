"""Training the models from nothing (counterpart of ``paule_tpu/pretrain.py``).

* :func:`babble_corpus`: motor babbling, random smooth cp trajectories
  synthesised by the C++ synthesizer (one native call per sequence length
  through a :class:`~paule_tpu_torch.synth.SynthPool`) and paired with their
  log-mels: the (cp, mel) pairs the forward and inverse models learn from.
* :func:`train_forward` / :func:`train_inverse`: supervised training with
  continue-learning's trainer and same-size batching.
* :func:`train_embedder`: mel (or tube) -> semvec regression on a corpus
  with ``vector`` labels.
* :func:`train_gan`: conditional WGAN-GP of a semvec -> trajectory
  generator against a critic.

A corpus is any mapping of column names to equal-length sequences: the
plain dict :func:`babble_corpus` returns, or a pandas DataFrame of the JAX
package's (``pd.DataFrame(corpus)`` turns one into the other).  Each
``train_*`` copies its columns to the model's device once, trains the
modules it is given in place on that device (the LSTM kernels B1-B4 for
float32 models on the card) and returns them frozen and in ``eval()``
mode, as :class:`~paule_tpu_torch.planning.trainer.ModelTrainer` leaves its
model.  Batches are drawn from a ``random.Random(seed)`` call for call as
the JAX package draws them, so equal seeds give equal batches.
"""

import random

import numpy as np
import torch

from . import synth
from .dsp.mel import librosa_melspec
from .ops.normalize import inv_normalize_cp, normalize_mel
from .ops.padding import pad_batch
from .planning.trainer import (ModelTrainer, build_length_dict,
                               create_epoch_batches, mean_or_nan,
                               train_epochs)


# ---------------------------------------------------------------------------
# data generation (motor babbling)
# ---------------------------------------------------------------------------

def random_cp_trajectory(rng, seq_len, *, walk_scale=0.05, smooth=8):
    """A random smooth normalised cp trajectory ``(seq_len, 30)``: a random
    walk, boxcar-smoothed, centred and clipped to [-1, 1]; the JAX
    package's numpy code, so a ``numpy`` generator in the same state gives
    the same trajectory bit for bit."""
    steps = rng.normal(0.0, walk_scale, (seq_len + smooth, 30))
    walk = np.cumsum(steps, axis=0)
    kernel = np.ones(smooth) / smooth
    sm = np.stack([np.convolve(walk[:, c], kernel, mode="valid")
                   for c in range(walk.shape[1])], axis=1)[:seq_len]
    return np.clip(sm - sm.mean(0, keepdims=True), -1.0, 1.0)


def synthesize_by_length(pool, cps, *, with_tube=False):
    """Synthesis of normalised trajectories of mixed lengths through
    ``pool``, one native call per length.  -> per trajectory its ``(audio,
    sr)``, or ``(audio, sr, tube_info)`` ``with_tube``; raises
    ``ValueError`` if one fails, as ``SynthPool.speak`` does."""
    out = [None] * len(cps)
    for length, idx in build_length_dict([len(c) for c in cps]).items():
        batch = np.stack([inv_normalize_cp(np.asarray(cps[i])) for i in idx])
        if with_tube:
            audio, sr, errors, tubes = pool.speak_and_extract_batch(batch)
        else:
            (audio, sr, errors), tubes = pool.speak_batch(batch), None
        if errors.any():
            raise ValueError(f"synthesis failed at length {length}: errors "
                             f"{errors.tolist()}")
        for j, i in enumerate(idx):
            out[i] = ((audio[j], sr, tubes[j]) if with_tube
                      else (audio[j], sr))
    return out


def babble_corpus(n_utterances, *, seq_len=(40, 120), seed=0, pool=None,
                  n_workers=4, device="cuda", dtype=torch.float32):
    """Motor babbling: ``n_utterances`` random trajectories of even lengths
    drawn from ``seq_len`` (so the 2:1 cp:mel contract holds), synthesised
    and featurised (the log-mel on ``device`` in ``dtype``).  -> a dict of
    column lists ``cp_norm``, ``melspec_norm_synthesized``, ``vector``
    (``None``) and ``segment_data`` (``False``), as the JAX package's
    DataFrame; the arrays are float64 numpy."""
    rng = np.random.default_rng(seed)
    lo, hi = seq_len if isinstance(seq_len, tuple) else (seq_len, seq_len)
    lens = [int(rng.integers(lo // 2, hi // 2 + 1)) * 2
            for _ in range(n_utterances)]
    cps = [random_cp_trajectory(rng, n) for n in lens]
    own_pool = pool is None
    if own_pool:
        pool = synth.SynthPool(size=n_workers)
    try:
        sounds = synthesize_by_length(pool, cps)
    finally:
        if own_pool:
            pool.close()
    mels = [normalize_mel(librosa_melspec(sig, sr, device=device,
                                          dtype=dtype))
            for sig, sr in sounds]
    return {"cp_norm": cps, "melspec_norm_synthesized": mels,
            "vector": [None] * n_utterances,
            "segment_data": [False] * n_utterances}


# ---------------------------------------------------------------------------
# supervised model training
# ---------------------------------------------------------------------------

def _placement(module):
    p = next(module.parameters())
    return p.device, p.dtype


def to_device(seqs, device, dtype):
    """Sequences of ``(T_i, C)`` arrays -> a list of tensors on ``device``
    in ``dtype``, copied there in one transfer."""
    arrays = [np.asarray(s, dtype=np.float64) for s in seqs]
    flat = torch.as_tensor(np.concatenate(arrays), dtype=dtype).to(device)
    return list(torch.split(flat, [len(a) for a in arrays]))


def _vectors(corpus, device, dtype):
    return torch.as_tensor(
        np.stack([np.asarray(v, dtype=np.float64) for v in corpus["vector"]]),
        dtype=dtype).to(device)


def epoch_batches(n, batch_size, length_dict, rng, exact_batch_only):
    """One epoch's same-size batches of ``n`` samples drawn from ``rng``
    (``create_epoch_batches``), without the short ones if
    ``exact_batch_only``."""
    batches = create_epoch_batches(n, batch_size, shuffle=True,
                                   same_size_batching=True,
                                   training_length_dict=length_dict, rng=rng)
    if exact_batch_only:
        batches = [b for b in batches if len(b) == batch_size]
    return batches


def _supervised(model, inputs, targets, loss, *, learning_rate, seed, **kw):
    device, dtype = _placement(model)
    trainer = ModelTrainer(model, loss=loss, learning_rate=learning_rate)
    losses = train_epochs(trainer, to_device(inputs, device, dtype),
                          to_device(targets, device, dtype),
                          rng=random.Random(seed), **kw)
    return model.eval(), losses


def train_forward(model, corpus, *, batch_size=8, n_epochs=10,
                  learning_rate=1e-3, seed=0, exact_batch_only=False,
                  progress=None):
    """Train a cp -> mel forward model (RMSE) on ``cp_norm`` ->
    ``melspec_norm_synthesized``; -> ``(model, per-epoch losses)``."""
    return _supervised(
        model, corpus["cp_norm"], corpus["melspec_norm_synthesized"], "rmse",
        batch_size=batch_size, n_epochs=n_epochs,
        learning_rate=learning_rate, seed=seed,
        exact_batch_only=exact_batch_only, progress=progress)


def train_inverse(model, corpus, *, batch_size=8, n_epochs=10,
                  learning_rate=1e-3, seed=0, exact_batch_only=False,
                  progress=None):
    """Train a mel -> cp inverse model (the cp-trajectory loss: position,
    velocity, acceleration and jerk); -> ``(model, per-epoch losses)``."""
    return _supervised(
        model, corpus["melspec_norm_synthesized"], corpus["cp_norm"],
        "cp_trajectory", batch_size=batch_size, n_epochs=n_epochs,
        learning_rate=learning_rate, seed=seed,
        exact_batch_only=exact_batch_only, progress=progress)


def train_embedder(model, corpus, *, batch_size=8, n_epochs=10,
                   learning_rate=1e-3, seed=0,
                   input_column="melspec_norm_synthesized",
                   exact_batch_only=False, progress=None):
    """Train a sequence -> semvec embedder (mean squared error to the
    ``vector`` column) with Adam and same-size batches of ``input_column``
    (``"tube_norm"`` for the tube embedder); -> ``(model, per-epoch
    losses)``.  The forward runs without dropout, in ``eval()`` mode: the
    JAX package trains the embedder deterministically."""
    device, dtype = _placement(model)
    rng = random.Random(seed)
    seqs = to_device(corpus[input_column], device, dtype)
    vecs = _vectors(corpus, device, dtype)
    lens = [len(s) for s in seqs]
    lens_t = torch.as_tensor(lens).to(device)
    length_dict = build_length_dict(lens)
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    model.eval().requires_grad_(True)
    epoch_losses = []
    for epoch in range(n_epochs):
        losses = []
        for idx in epoch_batches(len(seqs), batch_size, length_dict, rng,
                               exact_batch_only):
            sel = torch.as_tensor(idx).to(device)
            pred = model(pad_batch([lens[i] for i in idx],
                                   [seqs[i] for i in idx]), lens_t[sel])
            loss = torch.mean((pred - vecs[sel]) ** 2)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        epoch_losses.append(mean_or_nan(losses, device))
        if progress is not None:
            progress(epoch)
    optimizer.zero_grad(set_to_none=True)
    model.requires_grad_(False)
    return model, torch.stack(epoch_losses).tolist()


# ---------------------------------------------------------------------------
# conditional WGAN-GP for the semvec -> cp / mel generators
# ---------------------------------------------------------------------------

def device_draws(seed, device, dtype):
    """:func:`train_gan`'s default random draws: ``draw(what, shape)``
    gives uniform samples for ``what == "eps"`` and normal ones for
    ``"critic_noise"`` and ``"gen_noise"``, drawn on ``device`` from a
    generator there seeded from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(what, shape):
        sample = torch.rand if what == "eps" else torch.randn
        return sample(shape, generator=gen, device=device, dtype=dtype)
    return draw


def _critic_loss(critic, real, fake, vec, eps, length, gp_weight):
    """Wasserstein distance plus the gradient penalty at a random mix of
    real and fake (the penalty's gradient is a second-order one)."""
    real_score = critic(real, length, vec)
    fake_score = critic(fake, length, vec)
    mix = (eps * real + (1.0 - eps) * fake).requires_grad_(True)
    grads, = torch.autograd.grad(critic(mix, length, vec).sum(), mix,
                                 create_graph=True)
    gnorm = torch.sqrt(torch.sum(grads ** 2, dim=(1, 2)) + 1e-12)
    gp = torch.mean((gnorm - 1.0) ** 2)
    return fake_score.mean() - real_score.mean() + gp_weight * gp


def train_gan(generator, critic, corpus, *, data_column="cp_norm",
              batch_size=8, n_epochs=10, n_critic=5, gp_weight=10.0,
              learning_rate=1e-4, seed=0, noise_size=100,
              exact_batch_only=False, progress=None, draw=None):
    """Conditional WGAN-GP: the critic scores (trajectory, semvec) pairs,
    the generator maps (noise, length, semvec) to a trajectory
    (``paule_tpu/pretrain.py:187-306``).

    Both optimisers are Adam (``learning_rate``, betas (0.5, 0.9)).  Every
    batch takes a critic step; every ``n_critic``-th batch of the whole run
    also a generator step.  The generator is in ``train()`` mode in both
    steps, so both update its batch norms' running statistics, as the JAX
    package adopts them; the critic runs in ``eval()`` mode (the JAX
    package applies it deterministically).  The noise ``(b, 1,
    noise_size)`` and the mixing weights ``(b, 1, 1)`` come from ``draw``
    (:func:`device_draws` of ``seed`` by default), which is called, per
    batch, with ``"critic_noise"``, ``"eps"`` and, at a generator step,
    ``"gen_noise"``; a test replays JAX's draws through it.  A critic whose
    backward is not twice differentiable (an LSTM through B1-B4) raises.
    -> ``(generator, critic, per-epoch (critic_loss, gen_loss))``, ``nan``
    for an epoch without such a step."""
    device, dtype = _placement(generator)
    rng = random.Random(seed)
    data = to_device(corpus[data_column], device, dtype)
    vecs = _vectors(corpus, device, dtype)
    lens = [len(d) for d in data]
    length_dict = build_length_dict(lens)
    draw = draw or device_draws(seed, device, dtype)

    def drawn(what, shape):
        return torch.as_tensor(draw(what, shape), dtype=dtype, device=device)

    adam = dict(lr=learning_rate, betas=(0.5, 0.9), eps=1e-8)
    gen_opt = torch.optim.Adam(generator.parameters(), **adam)
    cri_opt = torch.optim.Adam(critic.parameters(), **adam)
    generator.train().requires_grad_(True)
    critic.eval().requires_grad_(True)
    epoch_losses = []
    it = 0
    for epoch in range(n_epochs):
        c_losses, g_losses = [], []
        for idx in epoch_batches(len(data), batch_size, length_dict, rng,
                               exact_batch_only):
            real = pad_batch([lens[i] for i in idx], [data[i] for i in idx])
            vec = vecs[torch.as_tensor(idx).to(device)]
            b, length = real.shape[:2]
            noise = drawn("critic_noise", (b, 1, noise_size))
            eps = drawn("eps", (b, 1, 1))
            with torch.no_grad():
                fake = generator(noise, length, vec)
            loss = _critic_loss(critic, real, fake, vec, eps, length,
                                gp_weight)
            cri_opt.zero_grad(set_to_none=True)
            loss.backward()
            cri_opt.step()
            c_losses.append(loss.detach())
            it += 1
            if it % n_critic == 0:
                noise = drawn("gen_noise", (b, 1, noise_size))
                critic.requires_grad_(False)
                loss = -critic(generator(noise, length, vec), length,
                               vec).mean()
                gen_opt.zero_grad(set_to_none=True)
                loss.backward()
                gen_opt.step()
                critic.requires_grad_(True)
                g_losses.append(loss.detach())
        epoch_losses.append(torch.stack([mean_or_nan(c_losses, device),
                                         mean_or_nan(g_losses, device)]))
        if progress is not None:
            progress(epoch)
    for module, opt in ((generator, gen_opt), (critic, cri_opt)):
        opt.zero_grad(set_to_none=True)
        module.eval().requires_grad_(False)
    return generator, critic, [tuple(e) for e in
                               torch.stack(epoch_losses).tolist()]
