"""The mesh's ``dp`` and ``tp`` axes over distinct cards, timed against the
same meshes on one card listed several times.

Run on a host with four CUDA devices::

    python -m paule_tpu_torch.tools.mesh_cards

In one process, with ``Paule(seed=7)``'s models (H=720) on ``cuda:0``:

1. the forward model's forward and backward on a seeded ``(4, 402, 30)``
   input, whole on ``cuda:0``, with its LSTM over ``tp=2`` on ``cuda:0``
   listed twice, and over ``tp=2`` on ``cuda:0`` and ``cuda:1``: the
   median of 20 timed calls each, the output's and the gradients'
   largest relative difference from the whole model's and the two-card
   split's from the one-card split's, and the bytes ``ops.lstm.gather``
   counts per call;
2. ``plan_corpus_batched`` of 8 seeded utterances of 402 cp frames, 2 x 24
   steps with continue-learning (``chip_smoke.py``'s ``drive_tp`` (d)):
   unsharded on ``cuda:0``, dp=2 on ``cuda:0`` listed twice and over
   ``cuda:0, cuda:1``, dp=2 x tp=2 on ``cuda:0`` listed four times and
   over ``cuda:0``-``cuda:3``; each warmed up, then timed in this order
   and back from one state: utterances per second, each run against its
   repeat, and each mesh of distinct cards against its one-card twin.

Prints each card's name and power limit, a line per measurement, and last
one JSON object with the numbers.  Exits 1 with fewer than four cards.
"""

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .. import checkpoint as CK
from .. import experiments as X
from .. import synth
from ..api import Paule
from ..dsp.targets import audio_target_to_mel
from ..ops import lstm as LS
from ..ops.normalize import inv_normalize_cp
from ..parallel import mesh as TMesh

#: the four cards, in order; ``CARDS[0]`` holds the models
CARDS = [f"cuda:{i}" for i in range(4)]


def sync():
    for dev in CARDS:
        torch.cuda.synchronize(dev)


def max_rel(a, b):
    """The largest ``|a - b|`` relative to ``max |b|``."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def fwd_bwd(model, x, cot):
    """One forward and backward of ``model``: -> (output, d input)."""
    xg = x.clone().requires_grad_(True)
    out = model(xg)
    (out * cot).sum().backward()
    return out.detach(), xg.grad


def time_layer(paule, seq=402, reps=20):
    """Measurement 1.  -> {name: {"ms", "err", "bytes"}}."""
    whole = copy.deepcopy(paule.pred_model).requires_grad_(True)
    lead = CARDS[0]
    gen = torch.Generator(device=lead).manual_seed(12)
    x = torch.rand((4, seq, 30), generator=gen, device=lead,
                   dtype=paule.dtype) * 2 - 1
    cot = torch.randn((4, seq // 2, 60), generator=gen, device=lead,
                      dtype=paule.dtype)
    runs = {"whole, cuda:0": whole}
    for name, devices in (("tp=2, cuda:0 twice", [lead] * 2),
                          ("tp=2, cuda:0 and cuda:1", CARDS[:2])):
        mesh = TMesh.make_mesh(devices=devices, dp=1, tp=2)
        runs[name] = TMesh.replicate(mesh, whole)[0]
    ref = fwd_bwd(whole, x, cot)
    out, got = {}, {}
    for name, m in runs.items():
        for _ in range(3):
            got[name] = fwd_bwd(m, x, cot)
        LS.gather.bytes = 0
        fwd_bwd(m, x, cot)
        n_bytes = LS.gather.bytes
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fwd_bwd(m, x, cot)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        err = max(max_rel(a, b) for a, b in zip(got[name], ref))
        out[name] = {"ms": statistics.median(times), "err": err,
                     "bytes": n_bytes}
        print(f"  {name}: forward + backward {out[name]['ms']:.3f} ms "
              f"(median of {reps}; min {min(times):.3f}, max "
              f"{max(times):.3f}); output and d input max rel err against "
              f"whole {err:.1e}; bytes moved between lead and blocks "
              f"{n_bytes}")
    twin = max(max_rel(a, b) for a, b in zip(
        got["tp=2, cuda:0 and cuda:1"], got["tp=2, cuda:0 twice"]))
    print(f"  tp=2 over two cards against tp=2 on one, max rel err: "
          f"{twin:.1e}")
    out["two cards against one, max rel err"] = twin
    return out


def synth_mels(paule, n=8, n_frames=402):
    mels = []
    for i in range(n):
        rng = np.random.default_rng(10 + i)
        cp = np.clip(rng.normal(0, 0.05, (n_frames, 30)).cumsum(0) * 0.2,
                     -1, 1)
        target = synth.speak(inv_normalize_cp(cp))
        mels.append(audio_target_to_mel(target, device=paule.device,
                                        dtype=paule.dtype)[2])
    return np.stack(mels)


def time_corpus(paule, n_frames=402):
    """Measurement 2.  -> {name: [seconds, seconds]}."""
    mels = synth_mels(paule, n_frames=n_frames)
    meshes = {
        "unsharded, cuda:0": None,
        "dp=2, cuda:0 twice": TMesh.make_mesh(devices=CARDS[:1] * 2),
        "dp=2, cuda:0 and cuda:1": TMesh.make_mesh(devices=CARDS[:2]),
        "dp=2 x tp=2, cuda:0 four times": TMesh.make_mesh(
            devices=CARDS[:1] * 4, dp=2, tp=2),
        "dp=2 x tp=2, cuda:0-3": TMesh.make_mesh(devices=CARDS, dp=2, tp=2),
    }
    kw = dict(max_batch=8, verbose=False, plan_kwargs=dict(
        objective="acoustic_semvec", n_outer=2, n_inner=24,
        continue_learning=True))
    state = CK.paule_state(paule)
    walls = {name: [] for name in meshes}
    results = {name: [] for name in meshes}
    try:
        for name, m in meshes.items():   # each first call pays its set-up
            X.plan_corpus_batched(paule, list(mels), mesh=m, **kw)
            CK.restore_paule_state(paule, state)
        for name in [*meshes, *reversed(meshes)]:
            paule._py_rng.seed(7)
            sync()
            t0 = time.perf_counter()
            results[name].append(X.plan_corpus_batched(
                paule, list(mels), mesh=meshes[name], **kw))
            sync()
            walls[name].append(time.perf_counter() - t0)
            CK.restore_paule_state(paule, state)
    finally:
        CK.restore_paule_state(paule, state)
    def cp_err(a, b):
        return max(float(np.abs(x["planned_cp"] - y["planned_cp"]).max())
                   for x, y in zip(a, b))

    for name, ws in walls.items():
        first, again = results[name]
        finite = all(np.isfinite(r["planned_cp"]).all() for r in again)
        print(f"  {name}: " + ", ".join(
            f"{w:.3f} s ({8 / w:.2f} utterances per s)" for w in ws)
            + f"; planned_cp max |err| against unsharded, not held: "
            f"{cp_err(again, results['unsharded, cuda:0'][1]):.1e}; "
            f"against its own repeat: {cp_err(again, first):.1e}; finite: "
            f"{finite}")
    twins = {a: cp_err(results[a][1], results[b][1]) for a, b in (
        ("dp=2, cuda:0 and cuda:1", "dp=2, cuda:0 twice"),
        ("dp=2 x tp=2, cuda:0-3", "dp=2 x tp=2, cuda:0 four times"))}
    for name, err in twins.items():
        print(f"  {name} against the same mesh on one card: planned_cp "
              f"max |err| {err:.1e}")
    return {"walls_s": walls, "against one card": twins}


def main():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("needs 4 CUDA devices", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        end="")
    paule = Paule(seed=7, device=CARDS[0])
    try:
        print("forward model's forward + backward at (4, 402, 30):")
        layer = time_layer(paule)
        print("plan_corpus_batched, 8 x 402 cp frames, 2 x 24 steps, "
              "continue-learning:")
        corpus = time_corpus(paule)
    finally:
        paule.close()
    print(json.dumps({"layer": layer, "corpus": corpus}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
