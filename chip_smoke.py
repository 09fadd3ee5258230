"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. prints the card's name and power limit, and builds the kernels from
   ``paule_tpu_torch/csrc/lstm.cu`` and ``csrc/ceiling_probes.cu`` (two
   ``nvcc`` processes started together);
2. holds each LSTM kernel (B1-B4) against its plain PyTorch version on the
   card at the shapes of the planning and training paths (B1/B2 at
   T=402 and T=201 with B=8 for the forward and inverse models' training
   steps), and times the
   kernel, the plain version and ``torch.nn.LSTM`` (cuDNN, a yardstick the
   port never calls), with µs per time step; holds the four persistent
   kernels also at edge shapes (T=1, a batch of 13 rows, H=100), B2 at
   the shapes of its tiled layout (B=8 and 16, H=720 and 360) and of its
   owner layout (B=1-4) with the layout each launch took and µs per step
   (``paule_tpu_torch.tools.bwd_layouts``), checks
   that two calls give bit-identical outputs, and counts with
   ``torch.profiler`` that one call of each, and of each ceiling probe at
   both of step 3's shapes, runs exactly one device kernel;
3. runs the ceiling-probe entry point (``paule_tpu_torch.tools.
   kernel_ceiling_probes``) at (T, B) = (1024, 1) and (402, 8), H=720: the
   four probe kernels (each one persistent launch per call) against their
   plain versions, with ms per call and µs per step beside B1/B2 timed in
   the same process (step 2 counts one device kernel per call of each);
4. drives ``paule_tpu_torch.api.Paule.plan_resynth`` at full width (H=720,
   the in-repo release weights) on a synthesised target: a short plan
   without continue-learning, then the default call with continue-learning
   of both models at the reference budget (only ``n_outer`` cut); checks
   the losses and that every kernel of each path launched during its run,
   and traces one more warm call with ``torch.profiler`` (not timed) for
   the share of each phase's wall time in which the card was busy;
5. drives the semvec path, planning from a semantic vector alone:
   ``plan_resynth(target_acoustic=None, target_semvec=..., target_seq_length=
   201, initialize_from="semvec", objective="semvec")`` with continue-
   learning of both models, the semvec taken by the port's embedder from
   the synthesised target's mel (the mel generator makes the target mel,
   Griffin-Lim its audio, the cp generator the initial trajectory); checks
   the losses, the plan's and the target signal's shapes and that B1-B4
   each launched during its run;
6. drives this slice's path, the somatosensory variant
   (``Paule(use_somatosensory_feedback=True)``: cp->tube and tube->mel
   models at H=360, a tube embedder of two layers at H=720 with dropout 0.7
   in planning, tube extraction in the synthesizer) with continue-learning
   of all four trained models at the main path's budget; checks the loss
   and tube series and that B1-B4 each launched, and counts the launches
   per kernel and shape; then a short run of the speech-classifier variant;
7. drives the batched and chunked planners and the entry points on the
   main path's ``Paule``: ``experiments.plan_corpus_batched`` over 10
   synthesised targets of two lengths (a batch of 8 at 402 cp frames and
   one of 2 at 302; B1/B2 at (402, 8) and B3/B4 at (201, 8) in every inner
   step), with its phase split, launches per shape, utterances per second
   beside the main path's and the device-busy share of one traced call;
   ``Paule.plan_iterative`` on ~400 mel frames in chunks of 64; the HTTP
   service (``serve.make_server`` on 127.0.0.1, a free port: /health,
   /plan, /plan_batch, a bad request); and the command line
   (``python -m paule_tpu_torch plan`` and ``corpus --batched 4`` through
   its ``main``, on a temporary corpus of 4 WAVs);
8. drives the training path: the port's release recipe
   (``paule_tpu_torch.tools.train_release_weights``) at the release's
   widths and batch 16 on a small corpus (:data:`PRETRAIN`), with per
   stage its wall time, Adam steps, ms per step, first and last loss and
   B1-B4 launches by (T, B, H), the device-busy share of one more, traced
   forward stage, checks that every trained tree and the generators'
   batch-norm statistics moved, and the written release loaded back and
   planned with (``drive_pretrain``); then one Adam step of each zoo
   model that only training uses (``drive_zoo``: ``SemVecTo*`` at H=180,
   ``LSTMCritic``/``LSTMGenerator`` at H=200 in training and eval);
9. drives the physical path, planning through the physics
   (``Paule(physical_forward=True)``: the differentiable spectral model of
   ``paule_tpu_torch/spectral.py`` in place of the learned forward model,
   the release's inverse model and embedder at H=720) at the main path's
   budget with continue-learning of the inverse model: phase split, ms per
   inner step, device activities per step, launches by (T, B, H) against
   the prediction, the device-busy share, and the spectral model alone at
   (1, 402, 30); the CLI's host commands ``synth``, ``seg2wav`` and
   ``speaker-import`` run inside step 7's command-line phase, and
   ``drive_zoo`` adds ``ForwardModelMelTimeSmoothResidual`` and
   ``MelEmbeddingModelMelSmoothResidualUpsampling``;
10. holds short plans on the card (float32) against the CPU (float64),
   without and with continue-learning, a short semvec-only plan, a short
   somatosensory plan with continue-learning (the tube embedder's dropout
   set to 0 on both sides), a short batched plan (three utterances), and
   training (``check_pretrain_against_cpu``: ``train_forward``,
   ``train_embedder`` and ``train_gan`` at full width, batch 16, the
   GAN's draws made on the CPU for both), and the physical path
   (``check_physical_against_cpu``: the spectral mel and its gradient at
   full width, and a short plan with continue-learning);
11. checks the last modules of the port: ``Paule()`` under
    ``PAULE_TPU_NO_RELEASE=1`` builds with the seeded random weights and
    prints its hint once (``check_release_fallback``); two card runs of
    Griffin-Lim are bit-equal, its ordered overlap-add timed beside the
    ``index_add_`` one it replaced (``check_griffin_lim``); the main
    path's warm call with ``plan_overlap`` False, 2 and 3 chunks and
    with ``async_chunk_fetch=False`` from one state, held against each
    other, with each setting's phase split, interleaved timing rounds
    against the synthesizer pool's size (``time_overlap``) and the busy
    share of a traced call without and with overlap (``drive_overlap``;
    ``drive_somatosensory`` also runs its call without overlap); the
    batched planner over ``make_mesh(devices=["cuda:0", "cuda:0"])``,
    its shards against the unsharded plans of the same halves, both
    against the unsharded batch step by step, continue-learning's
    sharded training step on a copy of the model against the whole
    batch's (``check_sharded_train_step``), and its full run against
    ``mesh=None``, with launches by (T, B, H) and utterances per second
    (``drive_sharded``; B1/B2 also held at (402, 4)); and the reference
    bridge's stand-ins
    against the port's own functions (``check_reference_bridge``);
12. drives the mesh's ``tp`` axis, the counterpart of the multi-chip dry
    run's three parts (``drive_tp``): over ``make_mesh(devices=["cuda:0"]
    * 4, dp=2, tp=2)`` against ``dp=2, tp=1``, the release forward model
    with its LSTM gate axis split against itself whole (output and every
    gradient; one B1 and one B2 per call), ``plan_batch`` step by step,
    the training step, and ``plan_corpus_batched`` with
    continue-learning, with utterances per second, launches by (T, B, H)
    and the bytes moved between leads and blocks per inner step;
13. runs each of the port's measurement and corpus-quality tools
    (``paule_tpu_torch/tools/``: ``hot_timing``, ``roofline``,
    ``batch_scaling``, ``step_decomposition``, ``profile_device``,
    ``bench_serve``, ``corpus_quality_run``, ``release_quality_run``,
    ``launch_overhead_probe``, ``synthesis_breakdown``,
    ``bench_variants``) at a cut budget (``drive_tools``), checking that
    every number is finite, that each traced ``plan_resynth`` phase but
    the host's synthesis had device time, that the launch probe's chains
    of 8 calls take longer than its single calls, that each synthesis
    strategy called the plant as it should, and that each variant has its
    ratio to ``acoustic_semvec``;
14. prints one JSON line with the kernels' numbers (the launches of the
    main path's, the physical path's and the tp path's warm calls) and,
    last, one JSON line with the device.

The kernel phase also holds B1/B2 at the somatosensory variant's H=360
shapes, B3 at T=402 (the tube embedder), B3/B4 at (201, 8), batched
planning's embedder, and the training path's batch-16 shapes
(:data:`TRAIN_CORE_SHAPES`, :data:`TRAIN_STACK_SHAPES`) against their
plain versions.

Exits non-zero on any failure, and when no CUDA device is present.
"""

import bisect
import collections
import contextlib
import copy
import http.client
import io
import json
import os
import pickle
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from paule_tpu_torch import checkpoint as CK
from paule_tpu_torch import experiments as X
from paule_tpu_torch import models as TM
from paule_tpu_torch import pretrain as PT
from paule_tpu_torch import reference_bridge as RB
from paule_tpu_torch import release as REL
from paule_tpu_torch import serve as S
from paule_tpu_torch import synth
from paule_tpu_torch import tracing
from paule_tpu_torch.__main__ import main as cli_main
from paule_tpu_torch.api import Paule
from paule_tpu_torch.dsp import audio as audio_io
from paule_tpu_torch.dsp import griffinlim as GL
from paule_tpu_torch.dsp import mel as MEL
from paule_tpu_torch.dsp.griffinlim import mel_to_sig
from paule_tpu_torch.dsp.resample import resample
from paule_tpu_torch.dsp.targets import audio_target_to_mel
from paule_tpu_torch.models.blocks import init_random
from paule_tpu_torch.ops import lstm as LS
from paule_tpu_torch.ops import lstm_kernels as K
from paule_tpu_torch.ops.normalize import inv_normalize_cp
from paule_tpu_torch.parallel import batched as TB
from paule_tpu_torch.parallel import mesh as TMesh
from paule_tpu_torch.planning.trainer import ModelTrainer
from paule_tpu_torch.spectral import SpectralForwardModel
from paule_tpu_torch.tools import (batch_scaling, bench_serve,
                                   bench_variants, corpus_quality_run,
                                   hot_timing, launch_overhead_probe,
                                   profile_device, release_quality_run,
                                   roofline, step_decomposition,
                                   synthesis_breakdown)
from paule_tpu_torch.tools import bwd_layouts as BL
from paule_tpu_torch.tools import kernel_ceiling_probes as P
from paule_tpu_torch.tools import timing
from paule_tpu_torch.tools import train_release_weights as R
from paule_tpu_torch.tools.timing import (bound_ms, cuda_ms, cudnn_lstm_ms,
                                          lstm_bwd_bound, lstm_fwd_bound)

H = 720
#: the somatosensory variant's cp->tube and tube->mel models
H_TUBE = 360
#: tolerances of a kernel against its plain version in float32: the forward
#: outputs in absolute terms; gradients (dgates, input and weight grads) as
#: the relative Frobenius error, since ~400 steps of f32 recurrence summed
#: in another order drift by a few ulps per step
FWD_ATOL = P.FWD_ATOL
GRAD_RTOL = P.GRAD_RTOL
#: (T, H) at batch 16 of the training path's B1/B2 and B3/B4 launches,
#: held against the plain versions and timed (``main``)
TRAIN_CORE_SHAPES = ((200, H), (100, H), (200, H_TUBE), (100, 200))
TRAIN_STACK_SHAPES = ((60, H), (120, H), (100, 180), (100, 200))
#: a short plan in float32 on the card against float64 on the CPU: the
#: losses (planned, produced and, with continue-learning, the models'
#: training losses), relative
PLAN_RTOL = 1e-3

#: (T, B) of the ceiling probes: the TPU probe's shape, and the shape of
#: continue-learning's B1/B2 rows (the forward model's training batch)
PROBE_SHAPES = ((1024, 1), (402, 8))

LSTM_SOURCE = "paule_tpu_torch/csrc/lstm.cu"
PROBE_SOURCE = "paule_tpu_torch/csrc/ceiling_probes.cu"
REPLACES = {
    "lstm_fwd": "paule_tpu/ops/pallas_lstm.py:214",
    "lstm_bwd": "paule_tpu/ops/pallas_lstm.py:264",
    "lstm_stack2_fwd": "paule_tpu/ops/pallas_lstm.py:554",
    "lstm_stack2_bwd": "paule_tpu/ops/pallas_lstm.py:601",
    "fwd_wide": "tools/kernel_ceiling_probes.py:12",
    "fwd_split": "tools/kernel_ceiling_probes.py:44",
    "bwd_wide": "tools/kernel_ceiling_probes.py:111",
    "bwd_split": "tools/kernel_ceiling_probes.py:162",
}


def rel_err(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def max_abs(pairs):
    return max(float((a - b).abs().max()) for a, b in pairs)


def _uniform(gen, shape, bound, dev):
    return ((torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1)
            * bound).to(dev)


def _normal(gen, shape, scale, dev):
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * scale).to(dev)


def build_all():
    """Both kernel libraries, one ``nvcc`` each, started together; then
    both loaded, before any ``torch.profiler`` trace (which records no
    kernel of a library loaded after its first start)."""
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(lib.build, verbose=True)
                  for lib in (K.LIBRARY, P.LIBRARY)]
        for b in builds:
            b.result()
    for lib in (K.LIBRARY, P.LIBRARY):
        lib.load()


def check_core(dev, gen, seq, batch, hidden=H):
    """B1 and B2 at (seq, batch, hidden) against their plain versions."""
    gx = _normal(gen, (seq, batch, 4 * hidden), 0.5, dev)
    w = _uniform(gen, (hidden, 4 * hidden), hidden ** -0.5, dev)
    h0 = _normal(gen, (batch, hidden), 0.1, dev)
    c0 = _normal(gen, (batch, hidden), 0.1, dev)
    gout = _normal(gen, (seq, batch, hidden), 1.0, dev)

    hs, cs = K.lstm_fwd(gx, w, h0, c0)
    hs_p, cs_p = K.lstm_fwd_plain(gx, w, h0, c0)
    fwd_err = max_abs([(hs, hs_p), (cs, cs_p)])
    same = identical((hs, cs), K.lstm_fwd(gx, w, h0, c0))

    hs_prev = torch.cat([h0[None], hs_p[:-1]])
    cs_prev = torch.cat([c0[None], cs_p[:-1]]).contiguous()
    acts = K.activate(gx + hs_prev @ w, hidden).contiguous()
    dg, dh0, dc0 = K.lstm_bwd(acts, cs_prev, gout, w)
    dg_p, dh0_p, dc0_p = K.lstm_bwd_plain(acts, cs_prev, gout, w)
    bwd_err = max_abs([(dg, dg_p), (dh0, dh0_p), (dc0, dc0_p)])
    bwd_rel = max(rel_err(dg, dg_p), rel_err(dh0, dh0_p),
                  rel_err(dc0, dc0_p))

    # input and weight gradients: the kernels' autograd.Function against
    # autograd through the plain forward
    leaves = [t.clone().requires_grad_() for t in (gx, w)]
    hs_k, _ = K.LSTMCore.apply(leaves[0], leaves[1], h0, c0)
    grads_k = torch.autograd.grad((hs_k * gout).sum(), leaves)
    leaves_p = [t.clone().requires_grad_() for t in (gx, w)]
    hs_pl, _ = K.lstm_fwd_plain(leaves_p[0], leaves_p[1], h0, c0)
    grads_p = torch.autograd.grad((hs_pl * gout).sum(), leaves_p)
    grad_rel = max(rel_err(a, b) for a, b in zip(grads_k, grads_p))

    out = {
        "lstm_fwd": dict(
            seq=seq, max_abs_err=fwd_err, rel_err=None,
            ms=cuda_ms(lambda: K.lstm_fwd(gx, w, h0, c0), 20),
            plain_ms=cuda_ms(lambda: K.lstm_fwd_plain(gx, w, h0, c0), 3),
            library_ms=cudnn_lstm_ms(30, hidden, 1, seq, batch, dev, False),
            bound=lstm_fwd_bound(seq, batch, hidden)),
        "lstm_bwd": dict(
            seq=seq, max_abs_err=bwd_err, rel_err=max(bwd_rel, grad_rel),
            ms=cuda_ms(lambda: K.lstm_bwd(acts, cs_prev, gout, w), 20),
            plain_ms=cuda_ms(lambda: K.lstm_bwd_plain(acts, cs_prev, gout,
                                                      w), 3),
            library_ms=cudnn_lstm_ms(30, hidden, 1, seq, batch, dev, True),
            bound=lstm_bwd_bound(seq, batch, hidden)),
    }
    print(f"  B1 lstm_fwd  T={seq} B={batch} H={hidden}: fwd max|err| "
          f"{fwd_err:.3e} (tol {FWD_ATOL}); two calls bit-identical: {same}")
    print(f"  B2 lstm_bwd  T={seq} B={batch} H={hidden}: dgates/dh0/dc0 "
          f"max|err| {bwd_err:.3e}, rel {bwd_rel:.3e}; input/weight grads rel "
          f"{grad_rel:.3e} (tol {GRAD_RTOL})")
    ok = (fwd_err <= FWD_ATOL and same and bwd_rel <= GRAD_RTOL
          and grad_rel <= GRAD_RTOL)
    return ok, out


def check_stack2(dev, gen, seq, batch, hidden=H):
    """B3 and B4 at (seq, batch, hidden) against their plain versions."""
    g1 = _normal(gen, (seq, batch, 4 * hidden), 0.5, dev)
    w1 = _uniform(gen, (hidden, 4 * hidden), hidden ** -0.5, dev)
    w2 = _uniform(gen, (2 * hidden, 4 * hidden), hidden ** -0.5, dev)
    b2 = _uniform(gen, (4 * hidden,), hidden ** -0.5, dev)
    z = torch.zeros((batch, hidden), device=dev)
    gout = _normal(gen, (seq, batch, hidden), 1.0, dev)

    outs = K.lstm_stack2_fwd(g1, w1, w2, b2, z, z, z, z)
    outs_p = K.lstm_stack2_fwd_plain(g1, w1, w2, b2, z, z, z, z)
    fwd_err = max_abs(zip(outs, outs_p))
    same = identical(outs, K.lstm_stack2_fwd(g1, w1, w2, b2, z, z, z, z))

    hs1, cs1, hs2, cs2 = outs_p
    shift = lambda a: torch.cat([z[None], a[:-1]]).contiguous()  # noqa: E731
    cat2 = torch.cat([hs1, shift(hs2)], dim=-1)
    acts1 = K.activate(g1 + shift(hs1) @ w1, hidden).contiguous()
    acts2 = K.activate(b2 + cat2 @ w2, hidden).contiguous()
    args = (acts1, acts2, shift(cs1), shift(cs2), gout, w1, w2)
    dg = K.lstm_stack2_bwd(*args)
    dg_p = K.lstm_stack2_bwd_plain(*args)
    bwd_err = max_abs(zip(dg, dg_p))
    bwd_rel = max(rel_err(a, b) for a, b in zip(dg, dg_p))

    leaves = [t.clone().requires_grad_() for t in (g1, w1, w2, b2)]
    hs2_k = K.LSTMStack2.apply(*leaves, z, z, z, z)[2]
    grads_k = torch.autograd.grad((hs2_k * gout).sum(), leaves)
    leaves_p = [t.clone().requires_grad_() for t in (g1, w1, w2, b2)]
    hs2_p = K.lstm_stack2_fwd_plain(*leaves_p, z, z, z, z)[2]
    grads_p = torch.autograd.grad((hs2_p * gout).sum(), leaves_p)
    grad_rel = max(rel_err(a, b) for a, b in zip(grads_k, grads_p))

    f32 = 4
    out = {
        "lstm_stack2_fwd": dict(
            seq=seq, max_abs_err=fwd_err, rel_err=None,
            ms=cuda_ms(lambda: K.lstm_stack2_fwd(g1, w1, w2, b2, z, z, z, z),
                       20),
            plain_ms=cuda_ms(lambda: K.lstm_stack2_fwd_plain(
                g1, w1, w2, b2, z, z, z, z), 3),
            library_ms=cudnn_lstm_ms(60, hidden, 2, seq, batch, dev, False),
            bound=bound_ms(
                f32 * (seq * batch * 8 * hidden + 12 * hidden * hidden
                       + 4 * hidden + 4 * batch * hidden),
                seq * batch * (24 * hidden * hidden + 26 * hidden))),
        "lstm_stack2_bwd": dict(
            seq=seq, max_abs_err=bwd_err, rel_err=max(bwd_rel, grad_rel),
            ms=cuda_ms(lambda: K.lstm_stack2_bwd(*args), 20),
            plain_ms=cuda_ms(lambda: K.lstm_stack2_bwd_plain(*args), 3),
            library_ms=cudnn_lstm_ms(60, hidden, 2, seq, batch, dev, True),
            bound=bound_ms(
                f32 * (seq * batch * 19 * hidden + 12 * hidden * hidden),
                seq * batch * (24 * hidden * hidden + 40 * hidden))),
    }
    print(f"  B3 lstm_stack2_fwd  T={seq} B={batch} H={hidden}: fwd max|err| "
          f"{fwd_err:.3e} (tol {FWD_ATOL}); two calls bit-identical: {same}")
    print(f"  B4 lstm_stack2_bwd  T={seq} B={batch} H={hidden}: dgates "
          f"max|err| {bwd_err:.3e}, rel {bwd_rel:.3e}; input/weight grads rel "
          f"{grad_rel:.3e} (tol {GRAD_RTOL})")
    ok = (fwd_err <= FWD_ATOL and same and bwd_rel <= GRAD_RTOL
          and grad_rel <= GRAD_RTOL)
    return ok, out


def identical(outs, again):
    """Whether two calls' outputs are bit for bit the same."""
    return all(torch.equal(a, b) for a, b in zip(outs, again))


#: (T, B, H) at which B1-B4 are also held against their plain versions:
#: one step, a batch of 13 rows (a part-filled pass of rows), and H=100,
#: which the units per block do not divide
EDGE_SHAPES = ((1, 1, H), (1, 13, H), (37, 13, H), (23, 3, 100),
               (9, 13, 100))


def check_edges(dev, gen):
    """B1-B4 at :data:`EDGE_SHAPES`, with random inputs and initial
    carries, against their plain versions (forward: max abs error;
    backward: relative error) and against a second call.  -> ok."""
    ok = True
    for seq, batch, hidden in EDGE_SHAPES:
        gx = _normal(gen, (seq, batch, 4 * hidden), 0.5, dev)
        w = _uniform(gen, (hidden, 4 * hidden), hidden ** -0.5, dev)
        w2 = _uniform(gen, (2 * hidden, 4 * hidden), hidden ** -0.5, dev)
        b2 = _uniform(gen, (4 * hidden,), hidden ** -0.5, dev)
        carries = [_normal(gen, (batch, hidden), 0.1, dev) for _ in range(4)]
        acts = [K.activate(_normal(gen, (seq, batch, 4 * hidden), 1.0, dev),
                           hidden) for _ in range(2)]
        c_prev = [_normal(gen, (seq, batch, hidden), 0.5, dev)
                  for _ in range(2)]
        ghs = _normal(gen, (seq, batch, hidden), 1.0, dev)
        calls = {
            "B1": (K.lstm_fwd, K.lstm_fwd_plain, (gx, w, *carries[:2])),
            "B2": (K.lstm_bwd, K.lstm_bwd_plain, (acts[0], c_prev[0], ghs, w)),
            "B3": (K.lstm_stack2_fwd, K.lstm_stack2_fwd_plain,
                   (gx, w, w2, b2, *carries)),
            "B4": (K.lstm_stack2_bwd, K.lstm_stack2_bwd_plain,
                   (*acts, *c_prev, ghs, w, w2)),
        }
        errs, same = {}, True
        for name, (kernel, plain, args) in calls.items():
            outs = kernel(*args)
            pairs = list(zip(outs, plain(*args)))
            errs[name] = (max_abs(pairs) if name in ("B1", "B3")
                          else max(rel_err(a, b) for a, b in pairs))
            same = same and identical(outs, kernel(*args))
        print(f"  edge T={seq} B={batch} H={hidden}: max|err| B1 "
              f"{errs['B1']:.3e}, B3 {errs['B3']:.3e} (tol {FWD_ATOL}); rel "
              f"err B2 {errs['B2']:.3e}, B4 {errs['B4']:.3e} (tol "
              f"{GRAD_RTOL}); two calls bit-identical: {same}")
        ok = (ok and same and max(errs["B1"], errs["B3"]) <= FWD_ATOL
              and max(errs["B2"], errs["B4"]) <= GRAD_RTOL)
    return ok


def check_bwd_layouts(dev):
    """B2 at :data:`~paule_tpu_torch.tools.bwd_layouts.SMOKE_SHAPES`
    (``bwd_layouts.measure``): against its plain version (relative error
    under ``bwd_layouts.REL_TOL``) and a second launch (bit for bit), with
    the layout the wrapper took and µs per step.  -> ok."""
    ok = True
    for shape in BL.SMOKE_SHAPES:
        row = BL.measure(*shape, dev)
        print("  " + BL.line(row))
        ok = ok and BL.row_ok(row)
    return ok


def device_kernels(fn):
    """Names of the device activities (kernels, copies) that one call of
    ``fn`` runs, as ``torch.profiler`` traces them, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def check_one_kernel_per_call(dev, gen):
    """B1 at (402, 1), B2 at (402, 8), B3 at (201, 24) and B4 at (201, 1)
    each run one device kernel per call, and so does each ceiling probe at
    each of :data:`PROBE_SHAPES` (here and not in the probe phase: a trace
    taken after the probe entry point's timing runs recorded no probe
    kernel, PERF.md §7).  -> ok."""
    gx = _normal(gen, (402, 1, 4 * H), 0.5, dev)
    g1 = _normal(gen, (201, 24, 4 * H), 0.5, dev)
    w = _uniform(gen, (H, 4 * H), H ** -0.5, dev)
    w2 = _uniform(gen, (2 * H, 4 * H), H ** -0.5, dev)
    b2 = _uniform(gen, (4 * H,), H ** -0.5, dev)
    z1 = torch.zeros((1, H), device=dev)
    z24 = torch.zeros((24, H), device=dev)
    acts8 = K.activate(_normal(gen, (402, 8, 4 * H), 1.0, dev), H)
    c8, g8 = (_normal(gen, (402, 8, H), 0.5, dev) for _ in range(2))
    acts1 = [K.activate(_normal(gen, (201, 1, 4 * H), 1.0, dev), H)
             for _ in range(2)]
    c1 = [_normal(gen, (201, 1, H), 0.5, dev) for _ in range(3)]
    ok = True
    for name, fn in (
            ("lstm_fwd", lambda: K.lstm_fwd(gx, w, z1, z1)),
            ("lstm_bwd", lambda: K.lstm_bwd(acts8, c8, g8, w)),
            ("lstm_stack2_fwd",
             lambda: K.lstm_stack2_fwd(g1, w, w2, b2, z24, z24, z24, z24)),
            ("lstm_stack2_bwd",
             lambda: K.lstm_stack2_bwd(*acts1, *c1, w, w2))):
        names = device_kernels(fn)
        print(f"  {name}: {len(names)} device kernel(s) in one call: {names}")
        ok = ok and len(names) == 1
    for seq, batch in PROBE_SHAPES:
        inp = P.make_inputs(seq, batch, H, 1, dev)
        fwd_args = (inp["gates"], inp["w_hh"], inp["h0"], inp["c0"])
        bwd_args = (inp["acts"], inp["cs_prev"], inp["ghs"], inp["w_hh"])
        for k in P.KERNELS:
            args = fwd_args if k.__name__.startswith("fwd") else bwd_args
            names = device_kernels(lambda: k(*args))
            print(f"  {k.__name__} T={seq} B={batch}: {len(names)} device "
                  f"kernel(s) in one call: {names}")
            ok = ok and len(names) == 1
    return ok


def _union(intervals):
    """Sorted, disjoint cover of ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(union, a, b):
    """Length of ``[a, b)`` that the disjoint sorted ``union`` covers."""
    i = max(bisect.bisect_right([u[0] for u in union], a) - 1, 0)
    total = 0.0
    for lo, hi in union[i:]:
        if lo >= b:
            break
        total += max(0.0, min(hi, b) - max(lo, a))
    return total


def device_busy_share(run, untraced, scope="plan_resynth", activities=None):
    """One more call of ``run()`` under ``torch.profiler``, not timed: per
    phase of ``untraced`` (the tracer's ``<scope>.<phase>.<leaf>`` ranges
    grouped by phase, or a tool's ``<scope>.<phase>`` ranges, summed over
    their occurrences), the seconds in which the card ran a kernel or a
    copy, as a share of the traced call's phase wall time and of the
    untraced call's (``untraced``: {phase: seconds}; the profiler slows the
    host, not the card).  With ``activities`` (a dict), also fills in per
    phase the number of device activities (kernels and copies) that start
    inside it.  -> {phase: share of the traced wall}."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    windows, device = collections.defaultdict(list), []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.name.startswith(scope + "."):
            if (e.device_type == torch.autograd.DeviceType.CPU
                    and e.name.split(".")[1] in untraced):
                windows[e.name.split(".")[1]].append(span)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(span)
    busy = _union(device)
    starts = sorted(a for a, _b in device)
    share = {}
    for phase, spans in windows.items():
        wall = sum(b - a for a, b in spans)
        on = sum(_covered(busy, a, b) for a, b in spans)
        share[phase] = on / wall
        if activities is not None:
            activities[phase] = sum(
                bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
                for a, b in spans)
        plain = untraced[phase]
        print(f"  {phase}: device busy {on / 1e6:.3f} s, {share[phase]:.1%} "
              f"of the traced {wall / 1e6:.3f} s, {on / 1e6 / plain:.1%} of "
              f"the untraced {plain:.3f} s")
    return share


def print_times(label, res):
    for name, r in res.items():
        print(f"  {name}{label}: kernel {r['ms']:.3f} ms "
              f"({r['ms'] * 1e3 / r['seq']:.2f} µs per time step), plain "
              f"{r['plain_ms']:.3f} ms, cuDNN {r['library_ms']:.3f} ms, "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")


def merge_errors(name, results, *others):
    """The largest error of kernel ``name`` over all checked shapes."""
    for key in ("max_abs_err", "rel_err"):
        vals = [r[name][key] for r in (results, *others)
                if r[name][key] is not None]
        results[name][key] = max(vals) if vals else None


def run_probes():
    """The ceiling-probe entry point on the card at each of
    :data:`PROBE_SHAPES`, its launches counted from 0 (one device kernel
    per call is checked in :func:`check_one_kernel_per_call`).  -> (ok,
    {(T, B): result}, launches)."""
    P.reset_launch_counts()
    results = {}
    for seq, batch in PROBE_SHAPES:
        results[(seq, batch)] = P.run(seq=seq, device="cuda", batch=batch)
        P.report(results[(seq, batch)])
    launches = {k.__name__: k.launches for k in P.KERNELS}
    print(f"  launches during the probe runs: {launches}")
    ok = all(P.within_tolerance(r["errors"]) for r in results.values())
    if not ok:
        print(f"probes: error above tolerance (forward {FWD_ATOL} absolute, "
              f"gradients {GRAD_RTOL} relative)", file=sys.stderr)
    if not all(launches.values()):
        print("probes: a kernel was not launched", file=sys.stderr)
        ok = False
    return ok, results, launches


def probe_row(name, result):
    """One probe's numbers at one shape, as the ``kernels`` line gives
    them."""
    t, e = result["times"][name], result["errors"][name]
    return {"shape": list(result["shape"]), "ms": t["ms"],
            "us_per_step": t["us_per_step"], "max_abs_err": e["max_abs_err"],
            "rel_err": e["rel_err"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"]}


def synth_target(n_frames, seed):
    """``(sig, sr)`` synthesised by the port from a seeded smooth cp
    trajectory of ``n_frames`` frames."""
    rng = np.random.default_rng(seed)
    cp = np.clip(rng.normal(0, 0.05, (n_frames, 30)).cumsum(0) * 0.2, -1, 1)
    return synth.speak(inv_normalize_cp(cp))


def counts():
    """The LSTM kernels' launch counts, by name."""
    return {k.__name__: k.launches for k in K.KERNELS}


def timed_plan(paule, kw, label):
    """One ``plan_resynth`` call with the launch counts set to 0 just
    before it; -> (results, launches, timings with the call's ``wall``)."""
    K.reset_launch_counts()
    t0 = time.perf_counter()
    r = paule.plan_resynth(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    t = paule.last_planning_timings
    print(f"{label}: {wall:.3f} s; " + ", ".join(
        f"{k} {v:.3f} s" for k, v in t.items()))
    return r, launches, dict(t, wall=wall)


def check_losses(r, n_logged, n_frames, what):
    ok = True
    losses = (r.planned_loss_steps + r.prod_loss_steps
              + r.pred_semvec_loss_steps + r.prod_semvec_loss_steps)
    if len(r.planned_loss_steps) != n_logged or not np.isfinite(
            losses).all():
        print(f"{what}: missing or non-finite losses", file=sys.stderr)
        ok = False
    if not r.planned_loss_steps[-1] < r.planned_loss_steps[0]:
        print(f"{what}: planned loss did not fall", file=sys.stderr)
        ok = False
    if r.planned_cp.shape != (n_frames, 30) or not np.isfinite(
            r.planned_cp).all():
        print(f"{what}: bad planned_cp", file=sys.stderr)
        ok = False
    return ok


def drive_planning(paule, target):
    """The planning path of the first slice: ``plan_resynth`` without
    continue-learning, 2 x 8 inner steps; checks the losses and that every
    kernel launched during the run.  -> ok."""
    kw = dict(target_acoustic=target, initialize_from="acoustic",
              objective="acoustic_semvec", n_outer=2, n_inner=8, log_ii=4,
              continue_learning=False, verbose=False)
    # the first call pays the CUDA libraries' set-up; the second is the run
    # whose launches and phase times are reported
    timed_plan(paule, kw, "plan_resynth(continue_learning=False, n_outer=2, "
               "n_inner=8, log_ii=4), first call")
    r, launches, t = timed_plan(paule, kw, "  second call")
    print(f"  planning {t['planning'] / 16 * 1e3:.2f} ms per inner step")
    print(f"  planned_loss_steps {r.planned_loss_steps}")
    print(f"  prod_loss_steps {r.prod_loss_steps}")
    print(f"  launches during the run: {launches}")
    ok = check_losses(r, 4, 402, "planning path")
    if not all(launches.values()):
        print("planning path: a kernel was not launched", file=sys.stderr)
        ok = False
    return ok


def drive_continue_learning(paule, target, step_ms):
    """The main path: the default ``plan_resynth`` with continue-learning
    of the predictive and inverse models at the reference budget
    (``n_inner=24, log_ii=1, n_batches=3, batch_size=8, n_epochs=10``), cut
    to ``n_outer=2``.  Called twice; the warm call's launches and phase
    split are reported.  The same budget without continue-learning then
    shows that B1/B2 launch once more per training step.  ``step_ms``:
    B1 + B2 ms at each model's training shape (``"pred"``, ``"inv"``),
    timed apart, to give the kernels' share of the phase.  -> (ok,
    launches, phase timings) of the warm call."""
    n_outer, n_inner = 2, 24
    kw = dict(target_acoustic=target, initialize_from="acoustic",
              objective="acoustic_semvec", n_outer=n_outer, n_inner=n_inner,
              log_ii=1, continue_learning=True, continue_learning_inv=True,
              verbose=False)
    label = (f"plan_resynth(continue_learning=True, continue_learning_inv="
             f"True, n_outer={n_outer}, n_inner={n_inner}, log_ii=1)")
    timed_plan(paule, kw, label + ", first call")
    pred0, inv0 = paule.pred_trainer.steps, paule.inv_trainer.steps
    r, launches, t = timed_plan(paule, kw, "  second call")
    pred_steps = paule.pred_trainer.steps - pred0
    inv_steps = paule.inv_trainer.steps - inv0
    steps = pred_steps + inv_steps
    kernel_s = (pred_steps * step_ms["pred"] + inv_steps * step_ms["inv"]) / 1e3
    _r, planning_only, _t = timed_plan(
        paule, dict(kw, continue_learning=False),
        "  same budget, continue_learning=False")
    print(f"  planning {t['planning'] / (n_outer * n_inner) * 1e3:.2f} ms per "
          f"inner step; continue-learning {t['continue_learning'] / n_outer:.3f}"
          f" s per outer iteration, {t['continue_learning'] / steps * 1e3:.2f}"
          f" ms per training step ({steps} Adam steps at batch 8)")
    print(f"  B1 + B2 at the training shapes, timed apart: {pred_steps} x "
          f"{step_ms['pred']:.3f} ms (T=402) + {inv_steps} x "
          f"{step_ms['inv']:.3f} ms (T=201) = {kernel_s:.3f} s, "
          f"{kernel_s / t['continue_learning']:.0%} of continue_learning")
    print(f"  planned_loss_steps[0, -1] {r.planned_loss_steps[0]:.6f} "
          f"{r.planned_loss_steps[-1]:.6f}")
    print(f"  pred_model_loss {r.pred_model_loss}")
    print(f"  inv_model_loss {r.inv_model_loss}")
    print(f"  launches during the run: {launches}; without continue-"
          f"learning: {planning_only}")
    print("  device-busy share per phase (one traced warm call):")
    busy = device_busy_share(lambda: paule.plan_resynth(**kw), t)
    ok = check_losses(r, n_outer * n_inner, 402, "continue-learning path")
    if not {"planning", "continue_learning"} <= busy.keys():
        print("continue-learning path: the trace shows no phase ranges",
              file=sys.stderr)
        ok = False
    model_losses = r.pred_model_loss + r.inv_model_loss
    if (len(r.pred_model_loss) != 10 * n_outer
            or len(r.inv_model_loss) != 10 * n_outer
            or not np.isfinite(model_losses).all()):
        print("continue-learning path: missing or non-finite model losses",
              file=sys.stderr)
        ok = False
    if steps != 2 * 30 * n_outer:
        print(f"continue-learning path: {steps} training steps, expected "
              f"{2 * 30 * n_outer}", file=sys.stderr)
        ok = False
    for name in ("lstm_fwd", "lstm_bwd"):
        if launches[name] - planning_only[name] != steps:
            print(f"continue-learning path: {name} launched "
                  f"{launches[name] - planning_only[name]} more times than "
                  f"without training, expected {steps}", file=sys.stderr)
            ok = False
    if not all(launches.values()):
        print("continue-learning path: a kernel was not launched",
              file=sys.stderr)
        ok = False
    return ok, launches, t


def target_semvec(paule, target):
    """The semantic vector ``(300,)`` that ``paule``'s embedder gives the
    target mel of the audio ``target``."""
    _sig, _sr, mel = audio_target_to_mel(target, device=paule.device,
                                         dtype=paule.dtype)
    with torch.no_grad():
        semvec = paule.embedder(torch.as_tensor(
            mel[None], dtype=paule.dtype, device=paule.device))
    return semvec[0].cpu().numpy().astype(np.float64)


def drive_semvec(paule, target):
    """The semvec path: plan from a semantic vector alone, the port's
    embedder's semvec of ``target``'s mel, at ``target_seq_length=201``
    (``initialize_from="semvec", objective="semvec"``), with continue-
    learning of both models, ``n_outer=2, n_inner=24, log_ii=1``.  Called
    twice; the warm call's launches and phase split are reported.  Also
    times Griffin-Lim alone on the card.  -> ok."""
    n_outer, n_inner, n_frames = 2, 24, 201
    semvec = target_semvec(paule, target)
    kw = dict(target_acoustic=None, target_semvec=semvec,
              target_seq_length=n_frames, initialize_from="semvec",
              objective="semvec", n_outer=n_outer, n_inner=n_inner,
              log_ii=1, continue_learning=True, continue_learning_inv=True,
              verbose=False)
    label = (f"plan_resynth(target_acoustic=None, target_seq_length="
             f"{n_frames}, initialize_from='semvec', objective='semvec', "
             f"continue_learning=True, continue_learning_inv=True, n_outer="
             f"{n_outer}, n_inner={n_inner}, log_ii=1)")
    timed_plan(paule, kw, label + ", first call")
    r, launches, t = timed_plan(paule, kw, "  second call")
    gl_ms = cuda_ms(lambda: mel_to_sig(r.target_mel, device=paule.device,
                                       dtype=paule.dtype), 3)
    print(f"  planning {t['planning'] / (n_outer * n_inner) * 1e3:.2f} ms per "
          f"inner step; continue-learning {t['continue_learning'] / n_outer:.3f}"
          f" s per outer iteration")
    print(f"  Griffin-Lim (mel_to_sig, 32 iterations, {n_frames} frames), "
          f"one call: {gl_ms:.3f} ms (CUDA events, its host part included)")
    print(f"  planned_loss_steps[0, -1] {r.planned_loss_steps[0]:.6f} "
          f"{r.planned_loss_steps[-1]:.6f}; pred_semvec_loss_steps[0, -1] "
          f"{r.pred_semvec_loss_steps[0]:.6f} "
          f"{r.pred_semvec_loss_steps[-1]:.6f}")
    print(f"  pred_model_loss {r.pred_model_loss}")
    print(f"  inv_model_loss {r.inv_model_loss}")
    print(f"  target_sig {len(r.target_sig)} samples, peak "
          f"{np.abs(r.target_sig).max():.4f}; planned_cp "
          f"{r.planned_cp.shape}")
    print(f"  launches during the run: {launches}")
    ok = check_losses(r, n_outer * n_inner, 2 * n_frames, "semvec path")
    n_sig = 220 * n_frames - 110
    if (r.target_sr != 44100 or r.target_sig.shape != (n_sig,)
            or not np.isfinite(r.target_sig).all()):
        print(f"semvec path: target_sig {r.target_sig.shape} at "
              f"{r.target_sr} Hz, expected ({n_sig},) at 44100",
              file=sys.stderr)
        ok = False
    model_losses = r.pred_model_loss + r.inv_model_loss
    if (len(r.pred_model_loss) != 10 * n_outer
            or len(r.inv_model_loss) != 10 * n_outer
            or not np.isfinite(model_losses).all()):
        print("semvec path: missing or non-finite model losses",
              file=sys.stderr)
        ok = False
    if not all(launches.values()):
        print("semvec path: a kernel was not launched", file=sys.stderr)
        ok = False
    return ok


#: the somatosensory variant's series, each one value per logged step
TUBE_SERIES = ("prod_tube_loss_steps", "pred_tube_mel_loss_steps",
               "prod_tube_mel_loss_steps", "pred_tube_semvec_loss_steps",
               "prod_tube_semvec_loss_steps")
#: the tube models' training losses, one value per epoch
TUBE_MODEL_LOSSES = ("tube_model_loss", "tube_mel_model_loss")


#: the tracer's LSTM op (family, direction) -> the kernel wrapper's name
OP_KERNELS = {("single", "fwd"): "lstm_fwd", ("single", "bwd"): "lstm_bwd",
              ("pair", "fwd"): "lstm_stack2_fwd",
              ("pair", "bwd"): "lstm_stack2_bwd"}


@contextlib.contextmanager
def shape_tally():
    """Inside the block, count the LSTM kernels' launches by kernel and
    ``(T, B, H)``: the block runs as one traced call
    (``paule_tpu_torch.tracing``), whose op records, those of the calls
    inside it included, give them (the launches on the card: ops with a
    device time).  -> the Counter of {(kernel, T, B, H): launches}, filled
    in when the block ends."""
    tally = collections.Counter()
    with tracing.call("shape_tally", force=True) as rec:
        yield tally
    for o in rec.record["ops"]:
        if o["device_ms"] is not None:
            tally[(OP_KERNELS[o["family"], o["direction"]], o["T"], o["B"],
                   o["H"])] += o["count"]


def launches_by_shape(fn):
    """Run ``fn()`` inside :func:`shape_tally`.  -> (fn's result,
    {(kernel, T, B, H): launches})."""
    with shape_tally() as tally:
        out = fn()
    return out, dict(sorted(tally.items()))


def drive_somatosensory(target, main_launches, main_times):
    """This slice's path: ``Paule(use_somatosensory_feedback=True)`` at full
    width (release weights: cp->tube and tube->mel at H=360, the tube
    embedder's two layers at H=720) on the main path's target and budget,
    ``objective="acoustic_semvec"``, continue-learning of the predictive,
    inverse, cp->tube and tube->mel models, ``n_outer=2, n_inner=24``.
    Called twice; the warm call's launches (per kernel, and per kernel and
    shape) and phase split are reported beside the main path's
    (``main_launches``, ``main_times``: its warm call's counts and
    ``last_planning_timings``).  -> (ok, {(kernel, T, B, H): launches} of
    the warm call)."""
    n_outer, n_inner = 2, 24
    kw = dict(target_acoustic=target, initialize_from="acoustic",
              objective="acoustic_semvec", n_outer=n_outer, n_inner=n_inner,
              log_ii=1, continue_learning=True, continue_learning_inv=True,
              continue_learning_tube=True, seed=7, verbose=False)
    paule = Paule(seed=7, use_somatosensory_feedback=True)
    try:
        timed_plan(paule, kw, "plan_resynth(use_somatosensory_feedback=True, "
                   "continue_learning_tube=True, continue_learning_inv=True,"
                   f" n_outer={n_outer}, n_inner={n_inner}, log_ii=1), first "
                   "call")
        state = CK.paule_state(paule)
        tube0 = paule.tube_trainer.steps + paule.tube_mel_trainer.steps
        (r, launches, t), shapes = launches_by_shape(
            lambda: timed_plan(paule, kw, "  second call (plan_overlap="
                               "True)"))
        tube_steps = (paule.tube_trainer.steps + paule.tube_mel_trainer.steps
                      - tube0)
        # 8e: the same call from the same state without overlap
        CK.restore_paule_state(paule, state)
        paule.plan_overlap = False
        r1, _l1, _t1 = timed_plan(paule, kw, "  the same, plan_overlap=False")
    finally:
        paule.close()
    overlap_err = max([max_rel(r.planned_cp, r1.planned_cp)] + [
        max_rel(getattr(r, k), getattr(r1, k))
        for k in OVERLAP_SERIES + TUBE_SERIES])
    print(f"  plan_overlap=True against False: max rel err {overlap_err:.3e}"
          f" (tol {OVERLAP_RTOL}); synthesis {t['synthesis']:.3f} s against "
          f"{_t1['synthesis']:.3f} s, wall {t['wall']:.3f} s against "
          f"{_t1['wall']:.3f} s")
    steps = n_outer * n_inner
    print(f"  planning {t['planning'] / steps * 1e3:.2f} ms per inner step "
          f"(main path {main_times['planning'] / steps * 1e3:.2f}); "
          f"continue-learning {t['continue_learning'] / n_outer:.3f} s per "
          f"outer iteration (main path "
          f"{main_times['continue_learning'] / n_outer:.3f}); synthesis "
          f"{t['synthesis']:.3f} s, metrics {t['metrics']:.3f} s (main path "
          f"{main_times['synthesis']:.3f}, {main_times['metrics']:.3f})")
    print(f"  launches during the run: {launches}; main path: "
          f"{main_launches}")
    print("  launches by kernel and (T, B, H): " + ", ".join(
        f"{k[0]} {k[1:]} {n}" for k, n in shapes.items()))
    print(f"  planned_loss_steps[0, -1] {r.planned_loss_steps[0]:.6f} "
          f"{r.planned_loss_steps[-1]:.6f}; pred_tube_semvec_loss_steps[0, "
          f"-1] {r.pred_tube_semvec_loss_steps[0]:.6f} "
          f"{r.pred_tube_semvec_loss_steps[-1]:.6f}")
    print(f"  tube_model_loss {r.tube_model_loss}")
    print(f"  tube_mel_model_loss {r.tube_mel_model_loss}")
    ok = check_losses(r, steps, 402, "somatosensory path")
    series = [np.asarray(getattr(r, k)) for k in TUBE_SERIES]
    losses = [np.asarray(getattr(r, k))
              for k in ("pred_model_loss", "inv_model_loss")
              + TUBE_MODEL_LOSSES]
    if (any(len(x) != steps for x in series)
            or any(len(x) != 10 * n_outer for x in losses)
            or not all(np.isfinite(x).all() for x in series + losses)):
        print("somatosensory path: missing or non-finite tube series or "
              "model losses", file=sys.stderr)
        ok = False
    if (len(r.prod_tube_steps) != n_outer
            or r.prod_tube_steps[0][0].shape != (402, 10)
            or r.pred_tube.shape != (402, 10)
            or r.pred_tube_mel.shape != (201, 60)):
        print("somatosensory path: bad tube shapes", file=sys.stderr)
        ok = False
    if overlap_err > OVERLAP_RTOL:
        print("somatosensory path: overlap changed the results",
              file=sys.stderr)
        ok = False
    if tube_steps != 2 * 30 * n_outer:
        print(f"somatosensory path: {tube_steps} tube training steps, "
              f"expected {2 * 30 * n_outer}", file=sys.stderr)
        ok = False
    if not all(launches.values()):
        print("somatosensory path: a kernel was not launched",
              file=sys.stderr)
        ok = False
    return ok, shapes


def drive_speech_classifier(target):
    """A short run of ``Paule(use_speech_classifier=True)`` at full width:
    ``n_outer=1, n_inner=8``, no continue-learning; checks its losses and
    that B1-B4 each launched.  -> ok."""
    kw = dict(target_acoustic=target, initialize_from="acoustic",
              objective="acoustic_semvec", n_outer=1, n_inner=8, log_ii=1,
              continue_learning=False, verbose=False)
    paule = Paule(seed=7, use_speech_classifier=True)
    try:
        r, launches, t = timed_plan(
            paule, kw, "plan_resynth(use_speech_classifier=True, n_outer=1, "
            "n_inner=8, continue_learning=False)")
    finally:
        paule.close()
    sc = np.asarray(r.pred_speech_classifier_loss_steps
                    + r.prod_speech_classifier_loss_steps)
    print(f"  planning {t['planning'] / 8 * 1e3:.2f} ms per inner step (one "
          f"call, not warm); speech-classifier losses planned "
          f"{r.pred_speech_classifier_loss_steps[-1]:.6f}, produced "
          f"{r.prod_speech_classifier_loss_steps[-1]:.6f}; launches "
          f"{launches}")
    ok = check_losses(r, 8, 402, "speech-classifier path")
    if len(sc) != 16 or not np.isfinite(sc).all():
        print("speech-classifier path: missing or non-finite classifier "
              "losses", file=sys.stderr)
        ok = False
    if not all(launches.values()):
        print("speech-classifier path: a kernel was not launched",
              file=sys.stderr)
        ok = False
    return ok


#: the physical path's launches by kernel and (T, B, H) in the warm call of
#: :func:`drive_physical` (2 x 24 inner steps, continue-learning of the
#: inverse model): the inverse model's initialisation and its 60 training
#: steps at batch 8; the embedder in every inner step (forward and
#: backward), for the target, the initial and final semvecs and, at B=24,
#: the produced metrics.  No B1/B2 at T=402: the forward model is physics.
PHYSICAL_SHAPES = {
    ("lstm_fwd", 201, 1, H): 1, ("lstm_fwd", 201, 8, H): 60,
    ("lstm_bwd", 201, 8, H): 60, ("lstm_stack2_fwd", 201, 1, H): 53,
    ("lstm_stack2_fwd", 201, 24, H): 2, ("lstm_stack2_bwd", 201, 1, H): 48}
#: the spectral model in float32 on the card against float64 on the CPU at
#: full width (1, 402, 30): the normalised mel absolutely, the gradient of
#: a weighted sum of it relatively (Frobenius).  float32 against float64
#: on the CPU gives ~1.2e-6 and ~1.4e-5; the chain product's resonances
#: amplify rounding in 1 / |C Z + D|, and the card's complex sin/cos may
#: round differently, so the limits leave two orders of magnitude.
SPECTRAL_MEL_ATOL = 1e-4
SPECTRAL_GRAD_RTOL = 1e-3


def spectral_times(dev, cp):
    """The spectral model alone on the card at ``cp``'s shape: ms of a
    forward and of a forward plus backward (CUDA events over 10 calls), and
    the device activities of one forward plus backward."""
    model = SpectralForwardModel()
    x = cp.detach().clone().requires_grad_(True)
    w = torch.ones((1, cp.shape[1] // 2, 60), device=dev)

    def both():
        (model(x) * w).sum().backward()

    with torch.no_grad():
        fwd = cuda_ms(lambda: model(x), 10)
    fwd_bwd = cuda_ms(both, 10)
    return fwd, fwd_bwd, len(device_kernels(both))


def drive_physical(target, main_times):
    """The physical path: ``Paule(physical_forward=True)`` at full width
    (the physical forward model in place of the learned one; the release's
    inverse model and embedder at H=720, K=513 frequencies) on the main
    path's target and budget, ``objective="acoustic_semvec"``,
    continue-learning of the inverse model, ``n_outer=2, n_inner=24``.
    Called twice; the warm call's phase split, ms per inner step (beside
    the main path's, ``main_times``) and launches per kernel and per (T,
    B, H) (against :data:`PHYSICAL_SHAPES`) are reported, and the
    device-busy share and device activities per inner step of a shorter
    call (1 x 4 inner steps) traced; then the spectral model alone at
    (1, 402, 30).  -> (ok, launches of the
    warm call)."""
    n_outer, n_inner = 2, 24
    steps = n_outer * n_inner
    kw = dict(target_acoustic=target, initialize_from="acoustic",
              objective="acoustic_semvec", n_outer=n_outer, n_inner=n_inner,
              log_ii=1, continue_learning=True, continue_learning_inv=True,
              verbose=False)
    paule = Paule(seed=7, physical_forward=True)
    try:
        timed_plan(paule, kw, "plan_resynth(physical_forward=True, "
                   "continue_learning_inv=True, n_outer=2, n_inner=24, "
                   "log_ii=1), first call")
        inv0 = paule.inv_trainer.steps
        (r, launches, t), shapes = launches_by_shape(
            lambda: timed_plan(paule, kw, "  second call"))
        inv_steps = paule.inv_trainer.steps - inv0
        # the trace holds ~2,000 device activities per inner step, so it
        # covers a shorter call (1 x 4 inner steps), timed untraced first
        short = dict(kw, n_outer=1, n_inner=4)
        _r, _l, t_short = timed_plan(paule, short, "  1 x 4 inner steps")
        print("  device-busy share per phase (the same call, traced):")
        acts = {}
        busy = device_busy_share(lambda: paule.plan_resynth(**short),
                                 t_short, activities=acts)
    finally:
        paule.close()
    dev = torch.device("cuda")
    fwd, fwd_bwd, n_dev = spectral_times(
        dev, torch.tensor(r.planned_cp[None], dtype=torch.float32,
                          device=dev))
    print(f"  planning {t['planning'] / steps * 1e3:.2f} ms per inner step "
          f"(main path {main_times['planning'] / steps * 1e3:.2f}); "
          f"{acts.get('planning', 0) / 4:.0f} device activities per "
          f"inner step in the traced call; continue-learning "
          f"{t['continue_learning'] / n_outer:.3f} s per outer iteration "
          f"({inv_steps} Adam steps of the inverse model)")
    print(f"  spectral model alone at (1, 402, 30): forward {fwd:.3f} ms, "
          f"forward + backward {fwd_bwd:.3f} ms, {n_dev} device activities "
          "per forward + backward")
    print(f"  launches during the run: {launches}")
    print("  launches by kernel and (T, B, H): " + ", ".join(
        f"{k[0]} {k[1:]} {n}" for k, n in shapes.items())
        + f"; as predicted: {shapes == PHYSICAL_SHAPES}")
    print(f"  planned_loss_steps[0, -1] {r.planned_loss_steps[0]:.6f} "
          f"{r.planned_loss_steps[-1]:.6f}; prod_loss_steps[0, -1] "
          f"{r.prod_loss_steps[0]:.6f} {r.prod_loss_steps[-1]:.6f}")
    print(f"  inv_model_loss {r.inv_model_loss}")
    print(f"  pred_model_loss {r.pred_model_loss}")
    ok = check_losses(r, steps, 402, "physical path")
    if (r.pred_model_loss != [] or len(r.inv_model_loss) != 10 * n_outer
            or not np.isfinite(r.inv_model_loss).all()
            or inv_steps != 30 * n_outer):
        print("physical path: bad model losses or training steps",
              file=sys.stderr)
        ok = False
    if any(k[1] == 402 for k in shapes) or not all(launches.values()):
        print("physical path: a kernel launched at the forward model's "
              "shape, or one was not launched", file=sys.stderr)
        ok = False
    if "planning" not in busy:
        print("physical path: the trace shows no phase ranges",
              file=sys.stderr)
        ok = False
    return ok, launches


def check_physical_against_cpu():
    """The physical path on the card (float32) and on the CPU (float64):
    the spectral model's mel and the gradient of a weighted sum of it at
    full width (1, 402, 30), within :data:`SPECTRAL_MEL_ATOL` and
    :data:`SPECTRAL_GRAD_RTOL`; and a short ``Paule(physical_forward=True)``
    plan with continue-learning of the inverse model, whose planned,
    produced and training losses agree within :data:`PLAN_RTOL`."""
    rng = np.random.default_rng(3)
    cp = np.clip(rng.normal(0, 0.05, (1, 402, 30)).cumsum(1) * 0.2, -1, 1)
    w = rng.normal(size=(1, 201, 60))
    model, got = SpectralForwardModel(), {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        x = torch.tensor(cp, dtype=dtype, device=dev, requires_grad=True)
        mel = model(x)
        (mel * torch.tensor(w, dtype=dtype, device=dev)).sum().backward()
        got[dev] = (mel.detach().cpu().double(), x.grad.cpu().double())
    mel_err = float((got["cuda"][0] - got["cpu"][0]).abs().max())
    grad_err = rel_err(got["cuda"][1], got["cpu"][1])

    target = synth_target(42, seed=1)
    kw = dict(target_acoustic=target, objective="acoustic_semvec",
              n_outer=2, n_inner=3, log_ii=1, continue_learning=True,
              continue_learning_inv=True, verbose=False)
    series = ("planned_loss_steps", "prod_loss_steps",
              "prod_semvec_loss_steps", "inv_model_loss")
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        paule = Paule(device=dev, dtype=dtype, seed=7, physical_forward=True)
        try:
            r = paule.plan_resynth(**kw)
        finally:
            paule.close()
        out[dev] = {s: np.array(getattr(r, s)) for s in series}
    errs = rel_errs(out, series)
    err = max(errs.values())
    print(f"physical path, card f32 vs CPU f64: spectral mel max|err| "
          f"{mel_err:.3e} (tol {SPECTRAL_MEL_ATOL}), its gradient rel err "
          f"{grad_err:.3e} (tol {SPECTRAL_GRAD_RTOL}); short plan "
          f"{sum(len(v) for v in out['cpu'].values())} losses, max rel err "
          f"{err:.3e} (tol {PLAN_RTOL}); per series " + ", ".join(
              f"{s} {e:.1e}" for s, e in errs.items()))
    return (mel_err <= SPECTRAL_MEL_ATOL and grad_err <= SPECTRAL_GRAD_RTOL
            and err <= PLAN_RTOL)


def rel_errs(out, series):
    """Per series, the largest relative error of the card's run
    (``out["cuda"]``) against the CPU's."""
    return {s: float(np.max(np.abs(out["cuda"][s] - out["cpu"][s])
                            / np.abs(out["cpu"][s]), initial=0.0))
            for s in series}


def check_against_cpu(continue_learning, somatosensory=False):
    """The same short plan on the card (float32, kernels) and on the CPU
    (float64, plain versions): the planned and produced losses, and the
    models' training losses with ``continue_learning``, agree.  With
    ``somatosensory``, the somatosensory variant with continue-learning of
    the tube models too, its tube series held as well, and the tube
    embedder's dropout set to 0 on both sides (its masks are drawn on
    each device)."""
    target = synth_target(42, seed=1)
    kw = dict(target_acoustic=target, objective="acoustic_semvec",
              n_outer=2 if continue_learning else 1, n_inner=3, log_ii=1,
              continue_learning=continue_learning,
              continue_learning_inv=continue_learning,
              continue_learning_tube=continue_learning and somatosensory,
              verbose=False)
    series = ("planned_loss_steps", "prod_loss_steps",
              "prod_semvec_loss_steps", "pred_model_loss", "inv_model_loss")
    if somatosensory:
        series += TUBE_SERIES + TUBE_MODEL_LOSSES
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        paule = Paule(device=dev, dtype=dtype, seed=7,
                      use_somatosensory_feedback=somatosensory)
        if somatosensory:
            paule.tube_embedder.dropout = 0.0
        try:
            r = paule.plan_resynth(**kw)
        finally:
            paule.close()
        out[dev] = {s: np.array(getattr(r, s)) for s in series}
    errs = rel_errs(out, series)
    err = max(errs.values())
    print(f"short plan (continue_learning={continue_learning}, "
          f"somatosensory={somatosensory}), card f32 vs CPU f64: "
          f"{sum(len(v) for v in out['cpu'].values())} losses, max rel err "
          f"{err:.3e} (tol {PLAN_RTOL}); per series " + ", ".join(
              f"{s} {e:.1e}" for s, e in errs.items()))
    return err <= PLAN_RTOL


def check_semvec_against_cpu():
    """A short semvec-only plan on the card (float32) and on the CPU
    (float64) from the same seed, so the same noise (drawn in float64 on
    the CPU): the generators' target mel and initial trajectory, and the
    planned loss series, agree.  The produced losses are printed, not
    held: the synthesizer's audio is not continuous in the cp for the cp
    generator's trajectories, so float32 rounding moves it by ~1e-3
    (tests/test_torch_semvec.py)."""
    target = synth_target(42, seed=1)
    planned = ("planned_loss_steps", "planned_mel_loss_steps",
               "pred_semvec_loss_steps")
    produced = ("prod_loss_steps", "prod_semvec_loss_steps")
    out, arrays = {}, {}
    semvec = None
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        paule = Paule(device=dev, dtype=dtype, seed=7)
        try:
            if semvec is None:
                semvec = target_semvec(paule, target)
            r = paule.plan_resynth(
                target_acoustic=None, target_semvec=semvec,
                target_seq_length=21, initialize_from="semvec",
                objective="semvec", n_outer=1, n_inner=3, log_ii=1,
                continue_learning=False, verbose=False)
        finally:
            paule.close()
        out[dev] = {s: np.array(getattr(r, s)) for s in planned + produced}
        arrays[dev] = (r.target_mel, r.initial_cp)
    errs = rel_errs(out, planned)
    err = max(errs.values())
    gen_err = max(float(np.abs(a - b).max())
                  for a, b in zip(arrays["cuda"], arrays["cpu"]))
    print(f"short semvec-only plan, card f32 vs CPU f64: generators' target "
          f"mel and initial cp max|err| {gen_err:.3e} (tol {PLAN_RTOL}); "
          f"planned losses max rel err {err:.3e} (tol {PLAN_RTOL}); per "
          "series " + ", ".join(f"{s} {e:.1e}" for s, e in errs.items())
          + "; produced, not held: " + ", ".join(
              f"{s} {e:.1e}" for s, e in rel_errs(out, produced).items()))
    return err <= PLAN_RTOL and gen_err <= PLAN_RTOL

PHASES = ("planning", "synthesis", "metrics", "continue_learning")


def batched_calls(fn):
    """Run ``fn()`` with ``parallel.batched.plan_batch_resynth`` wrapped.
    -> (fn's result, [(B, cp frames, its result, its phase timings)] of
    each call)."""
    calls = []
    real = TB.plan_batch_resynth

    def wrapped(paule, mels, *args, **kwargs):
        out = real(paule, mels, *args, **kwargs)
        calls.append((len(mels), 2 * mels.shape[1], out,
                      dict(paule.last_planning_timings)))
        return out

    TB.plan_batch_resynth = wrapped
    try:
        return fn(), calls
    finally:
        TB.plan_batch_resynth = real


def drive_batched(paule, main_times):
    """Batched corpus planning: ``experiments.plan_corpus_batched`` over 10
    synthesised targets, 8 of 402 cp frames and 2 of 302 (two length
    buckets: a batch of 8 and a leftover batch of 2), ``max_batch=8,
    objective="acoustic_semvec", n_outer=2, n_inner=24``, continue-learning
    of the predictive model (2 epochs).  Called twice; the warm call's
    phase split per batch, launches per kernel and per (T, B, H), and
    utterances per second beside the main path's warm call
    (``main_times``) are reported, and one more warm call is traced for the
    device-busy share.  Checks every utterance's plan, audio and curves,
    and that its planned loss fell.  -> ok."""
    n_outer, n_inner = 2, 24
    lengths = [402] * 8 + [302] * 2
    targets = [synth_target(n, seed=10 + i) for i, n in enumerate(lengths)]

    def run():
        return X.plan_corpus_batched(
            paule, targets, max_batch=8, verbose=False, plan_kwargs=dict(
                objective="acoustic_semvec", n_outer=n_outer,
                n_inner=n_inner, continue_learning=True))

    t0 = time.perf_counter()
    run()
    print(f"plan_corpus_batched(10 utterances, max_batch=8, n_outer={n_outer}"
          f", n_inner={n_inner}), first call: "
          f"{time.perf_counter() - t0:.3f} s")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    (results, calls), shapes = launches_by_shape(lambda: batched_calls(run))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    steps = n_outer * n_inner
    print(f"  second call: {wall:.3f} s, {len(targets) / wall:.2f} "
          f"utterances per s (main path's warm plan_resynth: "
          f"{1 / main_times['wall']:.2f} per s, {main_times['wall']:.3f} s)")
    total = dict.fromkeys(PHASES, 0.0)
    for b, t_cp, _out, tm in calls:
        print(f"  batch B={b} T={t_cp}: planning "
              f"{tm['planning'] / steps * 1e3:.2f} ms per inner step "
              f"({tm['planning'] / steps / b * 1e3:.2f} per utterance), "
              f"synthesis {tm['synthesis']:.3f} s, metrics "
              f"{tm['metrics']:.3f} s, continue_learning "
              f"{tm['continue_learning']:.3f} s")
        for k in PHASES:
            total[k] += tm[k]
    print("  phases summed: " + ", ".join(f"{k} {v:.3f} s"
                                          for k, v in total.items())
          + f" (main path's warm call: planning "
          f"{main_times['planning'] / steps * 1e3:.2f} ms per inner step)")
    print(f"  launches during the run: {launches}")
    print("  launches by kernel and (T, B, H): " + ", ".join(
        f"{k[0]} {k[1:]} {n}" for k, n in shapes.items()))
    ok = [(b, t) for b, t, _o, _t in calls] == [(2, 302), (8, 402)]
    for b, t_cp, out, _tm in calls:
        totals = np.stack([s.total for s in out["sub_losses"]])
        fell = totals[-1, -1] < totals[0, 0]
        print(f"  B={b}: planned loss first {np.round(totals[0, 0], 4)}, "
              f"last {np.round(totals[-1, -1], 4)}; pred_model_loss "
              f"{np.round(out['pred_model_loss'], 5).tolist()}")
        ok = (ok and totals.shape == (n_outer, n_inner, b)
              and np.isfinite(totals).all() and fell.all()
              and len(out["pred_model_loss"]) == n_outer * 2
              and np.isfinite(out["pred_model_loss"]).all())
    for res, n_cp in zip(results, lengths):
        curves = [res["prod_loss_curve"], res["prod_semvec_loss_curve"]]
        ok = (ok and res["planned_cp"].shape == (n_cp, 30)
              and res["prod_sig"].shape == ((n_cp - 1) * 110,)
              and all(c.shape == (n_outer,) for c in curves)
              and np.isfinite(res["planned_cp"]).all()
              and np.isfinite(curves).all())
    if not ok:
        print("batched path: bad shapes, non-finite losses, or a planned "
              "loss that did not fall", file=sys.stderr)
    if not all(launches.values()):
        print("batched path: a kernel was not launched", file=sys.stderr)
        ok = False
    print("  device-busy share per phase (one traced warm call):")
    busy = device_busy_share(run, total, scope="plan_batch_resynth")
    if not {"planning", "continue_learning"} <= busy.keys():
        print("batched path: the trace shows no phase ranges",
              file=sys.stderr)
        ok = False
    return ok


def check_batched_against_cpu():
    """A short batched plan, three utterances of 24 cp frames (2 outer x 3
    inner steps, continue-learning), on the card (float32) and on the CPU
    (float64), from the same target mels: the planned losses of every step,
    the produced curves and the training losses agree."""
    targets = [synth_target(24, seed=30 + i) for i in range(3)]
    mels = np.stack([audio_target_to_mel(t, device="cpu",
                                         dtype=torch.float64)[2]
                     for t in targets])
    kw = dict(n_outer=2, n_inner=3, objective="acoustic_semvec",
              continue_learning=True, n_epochs=2, batch_size=2)
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        paule = Paule(device=dev, dtype=dtype, seed=7)
        try:
            r = TB.plan_batch_resynth(paule, mels, **kw)
        finally:
            paule.close()
        out[dev] = {"planned": np.stack([s.total for s in r["sub_losses"]]),
                    "prod_loss_curve": r["prod_loss_curve"],
                    "prod_semvec_loss_curve": r["prod_semvec_loss_curve"],
                    "pred_model_loss": np.array(r["pred_model_loss"])}
    errs = rel_errs(out, tuple(out["cpu"]))
    err = max(errs.values())
    print(f"short batched plan (B=3, T=24, continue-learning), card f32 vs "
          f"CPU f64: max rel err {err:.3e} (tol {PLAN_RTOL}); per series "
          + ", ".join(f"{s} {e:.1e}" for s, e in errs.items()))
    return err <= PLAN_RTOL


def drive_iterative(paule):
    """``Paule.plan_iterative`` on a synthesised target of ~400 mel frames
    in chunks of 64 (``overlap=8, n_outer=1, n_inner=8,
    objective="acoustic_semvec"``, the default continue-learning).  Checks
    that the stitched plan has twice the mel frames, its losses, and that
    B1-B4 launched.  -> ok."""
    target = synth_target(800, seed=3)
    n_mel = audio_target_to_mel(target, device=paule.device,
                                dtype=paule.dtype)[2].shape[0]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    planned, results = paule.plan_iterative(
        target_acoustic=target, chunk_size=64, overlap=8, n_outer=1,
        n_inner=8, objective="acoustic_semvec")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    losses = np.array([r.planned_loss_steps for r in results])
    print(f"plan_iterative({n_mel} mel frames, chunk_size=64, overlap=8, "
          f"n_outer=1, n_inner=8): {wall:.3f} s, {len(results)} chunks of "
          f"{[r.target_mel.shape[0] for r in results]} mel frames; planned_cp "
          f"{planned.shape}; launches {launches}")
    ok = (planned.shape == (2 * n_mel, 30) and np.isfinite(planned).all()
          and np.isfinite(losses).all()
          and (losses[:, -1] < losses[:, 0]).all())
    if not ok:
        print("iterative path: bad stitched plan or losses", file=sys.stderr)
    if not all(launches.values()):
        print("iterative path: a kernel was not launched", file=sys.stderr)
        ok = False
    return ok


def _request(port, method, path, body=None):
    """-> (status, json) of one request to ``127.0.0.1:port``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body).encode())
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def drive_serve(paule):
    """The HTTP service around ``paule`` (on the card) on 127.0.0.1, a free
    port: /health, /plan (one outer iteration of 4 steps,
    continue-learning), /plan_batch (4 signals of 302 cp frames, one outer
    iteration of 4 steps) and a request with an unknown key.  Checks the
    answers' codes and shapes and that B1-B4 launched.  -> ok."""
    server = S.make_server(S.PauleService(paule), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever)
    thread.start()
    port = server.server_address[1]
    try:
        status, health = _request(port, "GET", "/health")
        sig, sr = synth_target(402, seed=40)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        plan = _request(port, "POST", "/plan", {
            "signal": S.encode_array(sig), "sample_rate": sr, "n_outer": 1,
            "n_inner": 4, "objective": "acoustic_semvec"})
        t_plan = time.perf_counter() - t0
        sigs = [synth_target(302, seed=41 + i)[0] for i in range(4)]
        t0 = time.perf_counter()
        batch = _request(port, "POST", "/plan_batch", {
            "signals": [S.encode_array(x) for x in sigs], "sample_rate": sr,
            "n_outer": 1, "n_inner": 4})
        t_batch = time.perf_counter() - t0
        launches = counts()
        bad = _request(port, "POST", "/plan", {
            "signal": [0.0] * 10, "sample_rate": sr, "n_steps": 3})
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    print(f"HTTP service: /health {status} {health}; /plan {plan[0]} in "
          f"{t_plan:.3f} s; /plan_batch {batch[0]} in {t_batch:.3f} s; "
          f"unknown key {bad[0]}; launches {launches}")
    ok = (status == 200 and health["backend"] == "cuda"
          and health["status"] == "ok" and plan[0] == 200
          and batch[0] == 200 and bad[0] == 400)
    if ok:
        ok = (S.decode_array(plan[1]["planned_cp"]).shape == (402, 30)
              and len(plan[1]["planned_loss_steps"]) == 4
              and np.isfinite(plan[1]["prod_loss_steps"]).all()
              and len(batch[1]["results"]) == 4)
        for res in batch[1]["results"] if ok else ():
            ok = (ok and S.decode_array(res["planned_cp"]).shape == (302, 30)
                  and S.decode_array(res["audio"]).shape == (301 * 110,)
                  and np.isfinite(res["prod_loss_curve"]).all())
    if not ok:
        print("HTTP service: a bad answer", file=sys.stderr)
    if not all(launches.values()):
        print("HTTP service: a kernel was not launched", file=sys.stderr)
        ok = False
    return ok


def write_cp_file(path, cps):
    """``cps`` (T, 30) as a tract-sequence file in ``synth.read_cp``'s
    format: six header lines, the glottis model, the number of states, and
    per state a line of 11 glottis and one of 19 tract values."""
    lines = ["#"] * 6 + ["Geometric glottis", str(len(cps))]
    for row in cps:
        lines.append(" ".join(f"{v:.17g}" for v in row[19:]))
        lines.append(" ".join(f"{v:.17g}" for v in row[:19]))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_vtl_speaker(path):
    """A small VocalTractLab XML speaker: the default speaker's parameter
    tables, the anatomy elements of the length estimate, two tract shapes
    and a selected glottis model with a ``modal`` shape."""
    tables = {w: synth.get_param_info(w) for w in ("tract", "glottis")}

    def params(info):
        return "".join(
            f'<param index="{i}" name="{n}" min="{float(lo)!r}" '
            f'max="{float(hi)!r}" neutral="{float(ne)!r}"/>'
            for i, (n, lo, hi, ne) in enumerate(zip(
                info["names"], info["mins"], info["maxs"],
                info["neutrals"])))

    tract = tables["tract"]
    shapes = "".join(
        f'<shape name="{name}">' + "".join(
            f'<param name="{n}" value="{float(v)!r}"/>'
            for n, v in zip(tract["names"], (1 - a) * tract["mins"]
                            + a * tract["maxs"])) + "</shape>"
        for name, a in (("a", 0.3), ("i", 0.7)))
    with open(path, "w") as fh:
        fh.write(
            "<speaker><vocal_tract_model><anatomy>"
            '<palate><p0 x="0.5" y="1.0"/><p1 x="3.25" y="1.4"/></palate>'
            '<pharynx fulcrum_x="-1.5" fulcrum_y="2.0"/>'
            '<larynx><narrow points="0.0 -1.0 1.0 -2.25"/></larynx>'
            '<nasal_cavity length="11.4"/>' + params(tract)
            + "</anatomy><shapes>" + shapes + "</shapes></vocal_tract_model>"
            '<glottis_models><glottis_model type="Geometric glottis" '
            'selected="1"><static_params><param index="0" name="RL" '
            'min="0.5" max="2.0" neutral="1.6"/></static_params>'
            "<control_params>" + params(tables["glottis"])
            + "</control_params></glottis_model></glottis_models>"
            "</speaker>")


def drive_cli():
    """``python -m paule_tpu_torch`` through its ``main``: ``plan`` of one
    WAV and ``corpus --batched 4`` over a temporary corpus of 4 WAVs (two
    labels, 202 cp frames each), on the card (the default device), one
    outer iteration of 4 steps; then the host commands ``synth`` (a
    tract-sequence file written here), ``seg2wav`` (a three-segment word)
    and ``speaker-import`` (a small VTL XML speaker written here).  Checks
    the files they write, that the imported speaker loads and speaks, and
    that B1-B4 launched.  -> ok."""
    tiny = ["--n-outer", "1", "--n-inner", "4", "--n-epochs", "1",
            "--quiet"]
    with tempfile.TemporaryDirectory() as tmp:
        wavs = []
        for i, name in enumerate(("a1_ba", "a2_ba", "b1_da", "b2_da")):
            path = os.path.join(tmp, "data", name[-2:], name + ".wav")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            audio_io.write(path, *synth_target(202, seed=50 + i))
            wavs.append(path)
        save = os.path.join(tmp, "out", "word")
        K.reset_launch_counts()
        t0 = time.perf_counter()
        cli_main(["plan", "--target", wavs[0], "--save", save, *tiny])
        cli_main(["corpus", "--data-dir", os.path.join(tmp, "data"),
                  "--save-dir", os.path.join(tmp, "corpus_out"),
                  "--batched", "4", *tiny])
        wall = time.perf_counter() - t0
        launches = counts()
        with open(save + ".pkl", "rb") as fh:
            planned = pickle.load(fh).planned_cp
        ok = (planned.shape == (202, 30)
              and os.path.exists(save + "_state.pkl")
              and any(os.path.exists(save + "_planned" + ext)
                      for ext in (".wav", ".flac")))
        for path in wavs:
            stem = os.path.splitext(os.path.basename(path))[0]
            with open(os.path.join(tmp, "corpus_out", stem[-2:],
                                   stem + "_batched.pkl"), "rb") as fh:
                res = pickle.load(fh)
            ok = (ok and res["planned_cp"].shape == (202, 30)
                  and np.isfinite(res["prod_loss_curve"]).all())
        ok = drive_host_commands(tmp) and ok
    print(f"command line: plan and corpus --batched 4, {wall:.3f} s "
          f"(two Paule() builds included); launches {launches}")
    if not ok:
        print("command line: missing or bad result files", file=sys.stderr)
    if not all(launches.values()):
        print("command line: a kernel was not launched", file=sys.stderr)
        ok = False
    return ok


def drive_host_commands(tmp):
    """The CLI's ``synth``, ``seg2wav`` and ``speaker-import`` in ``tmp``.
    -> ok."""
    rng = np.random.default_rng(8)
    cps = inv_normalize_cp(np.clip(
        rng.normal(0, 0.05, (81, 30)).cumsum(0) * 0.2, -1, 1))
    cp_file, seg = (os.path.join(tmp, n) for n in ("word.txt", "word.seg"))
    write_cp_file(cp_file, cps)
    with open(seg, "w") as fh:
        fh.write("name = a; duration_s = 0.10;\nname = t; duration_s = "
                 "0.05;\nname = a; duration_s = 0.10;\n")
    xml, ini = (os.path.join(tmp, n) for n in ("vtl.speaker", "vtl.ini"))
    write_vtl_speaker(xml)
    t0 = time.perf_counter()
    outs = {}
    for cmd, args in (("synth", ["--cps", cp_file]),
                      ("seg2wav", ["--seg", seg])):
        outs[cmd] = os.path.join(tmp, cmd + ".wav")
        cli_main([cmd, *args, "--out", outs[cmd]])
    cli_main(["speaker-import", xml, "-o", ini, "--name", "smoke"])
    wall = time.perf_counter() - t0
    sig, sr = audio_io.read(outs["synth"])
    seg_sig, _ = audio_io.read(outs["seg2wav"])
    synth.initialize(ini)
    try:
        names = synth.get_param_info("tract")["names"]
        spoken, _ = synth.speak(cps)
    finally:
        synth.initialize()
    ok = (sr == 44100 and len(sig) == 80 * 110 and len(seg_sig) > 10000
          and np.isfinite(spoken).all() and len(names) == 19)
    print(f"  synth, seg2wav and speaker-import: {wall:.3f} s; synth "
          f"{len(sig)} samples, seg2wav {len(seg_sig)}, the imported "
          f"speaker speaks: {bool(np.abs(spoken).max() > 0)}")
    if not ok:
        print("command line: bad output of synth, seg2wav or "
              "speaker-import", file=sys.stderr)
    return ok


#: the training path's corpus: 4 lexicon classes of 18 variants (16 for
#: training, all of one length: 4 full batches of 16 an epoch) and 100
#: babbled utterances (83 for training, 4 lengths), 2 epochs a stage and a
#: generator step every 2 critic steps, at the release's widths and batch
PRETRAIN = dict(classes=4, variants=18, babble=100, n_critic=2)
PRETRAIN_EPOCHS = 2
#: least Adam steps a stage takes in the run: 4 a model and epoch
#: (the tube stage trains 3 models; a GAN stage counts its critic steps)
PRETRAIN_MIN_STEPS = {"tube": 3 * 4 * PRETRAIN_EPOCHS}


def pretrain_cfg(**kw):
    cfg = R.settings({})
    cfg.update(PRETRAIN, **kw)
    cfg["epochs"] = dict.fromkeys(cfg["epochs"], PRETRAIN_EPOCHS)
    return cfg


def tree_leaves(tree):
    """The array leaves of a parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [np.asarray(tree)]


def _changed(a, b):
    return any(not np.array_equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def drive_pretrain(tmp):
    """The training path: the port's release recipe
    (``paule_tpu_torch.tools.train_release_weights.run``) at the release's
    widths and batch 16 on :data:`PRETRAIN`'s corpus, writing the release
    to ``tmp``.  Per stage: wall time, Adam steps, ms per step, first and
    last loss, and B1-B4 launches by (T, B, H); one more forward stage
    traced for the device-busy share.  Checks finite losses, the steps per
    stage, that every trained tree moved and each generator block's batch
    norm statistics too, that the release loads back equal to the trained
    trees after float16 rounding, and that a ``Paule`` built from it plans.
    -> (ok, {(kernel, T, B, H): launches} of the whole run)."""
    stage_shapes, stage_counts = {}, {}

    @contextlib.contextmanager
    def observe(name):
        K.reset_launch_counts()
        with shape_tally() as tally:
            yield
        stage_shapes[name] = dict(sorted(tally.items()))
        stage_counts[name] = counts()

    out = os.path.join(tmp, "release.npz")
    t0 = time.perf_counter()
    modules, ctx, report = R.run(out, device="cuda", cfg=pretrain_cfg(),
                                 observe=observe, log=lambda _line: None)
    wall = time.perf_counter() - t0
    ok = True
    print(f"release recipe at full width, batch 16: {wall:.3f} s in all "
          f"(corpus {report['corpus']})")
    total = collections.Counter()
    for rep in report["stages"]:
        name = rep["stage"]
        total.update(stage_shapes[name])
        gen_steps = rep.get("generator_steps", 0)
        steps = rep["adam_steps"] - gen_steps
        print(f"  {name}: {rep['seconds']:.3f} s, {rep['adam_steps']} Adam "
              f"steps ({gen_steps} of them the generator's), "
              f"{rep['ms_per_step'] or float('nan'):.2f} ms per step; loss first "
              f"{rep['first_loss']} last {rep['last_loss']}; launches "
              f"{stage_counts[name]}; by kernel and (T, B, H): " + ", ".join(
                  f"{k[0]} {k[1:]} {n}" for k, n in stage_shapes[name].items()))
        losses = np.array([rep["first_loss"], rep["last_loss"]], float)
        if not np.isfinite(losses).all():
            print(f"training path: {name}: non-finite loss", file=sys.stderr)
            ok = False
        least = PRETRAIN_MIN_STEPS.get(name, 4 * PRETRAIN_EPOCHS)
        if steps < least or (name.endswith("_gan") and gen_steps < 2):
            print(f"training path: {name}: {steps} steps, {gen_steps} of the "
                  f"generator; expected >= {least} (and >= 2)",
                  file=sys.stderr)
            ok = False
    for key, module in modules.items():
        if not _changed(REL.params_to_jax(module), ctx.initial[key]):
            print(f"training path: {key} did not change", file=sys.stderr)
            ok = False
    for key in ("cp_gan", "mel_gan"):
        for i, block in enumerate(modules[key].blocks):
            stats = [block.bn.mean.cpu().numpy(), block.bn.var.cpu().numpy()]
            before = ctx.initial[key]["blocks"][i]["bn"]
            if (not all(np.isfinite(x).all() for x in stats)
                    or np.array_equal(stats[0], before["mean"])
                    or np.array_equal(stats[1], before["var"])):
                print(f"training path: {key} block {i}: batch-norm "
                      "statistics unchanged or not finite", file=sys.stderr)
                ok = False
    loaded, meta = REL.load_release(out)
    same = all(
        all(np.array_equal(a, b.astype(np.float16)) for a, b in zip(
            tree_leaves(loaded[key]),
            tree_leaves(REL.params_to_jax(modules[key]))))
        for key in REL.MODEL_KEYS)
    print(f"  release {os.path.getsize(out) / 1e6:.1f} MB, models "
          f"{meta['models']}, trained on {meta['trained_on']!r}; equal to "
          f"the trained trees after float16 rounding: {same}")
    ok = ok and same and meta["models"] == sorted(REL.MODEL_KEYS)
    paule = Paule(device="cuda", seed=7, pred_model=loaded["predictive"],
                  inv_model=loaded["inverse"], embedder=loaded["embedder"],
                  cp_gen_model=loaded["cp_gan"],
                  mel_gen_model=loaded["mel_gan"])
    try:
        r = paule.plan_resynth(
            target_acoustic=synth_target(42, seed=1), n_outer=1, n_inner=4,
            log_ii=1, continue_learning=False, verbose=False)
    finally:
        paule.close()
    planned = np.array(r.planned_loss_steps + r.prod_loss_steps)
    print(f"  Paule from the release: planned_loss_steps "
          f"{np.round(r.planned_loss_steps, 5).tolist()}, prod_loss_steps "
          f"{np.round(r.prod_loss_steps, 5).tolist()}")
    if len(r.planned_loss_steps) != 4 or not np.isfinite(planned).all():
        print("training path: the release's Paule gave bad losses",
              file=sys.stderr)
        ok = False
    forward = report["stages"][0]
    print("  device-busy share of the forward stage (one more, traced):")
    device_busy_share(
        lambda: R.run_stage(ctx, "forward", R.stage_forward, ctx.data),
        {"forward": forward["seconds"]}, scope="train_release_weights")
    launches = collections.Counter()
    for c in stage_counts.values():
        launches.update(c)
    print(f"  launches during the recipe's stages: {dict(launches)}")
    if not all(launches[k.__name__] for k in K.KERNELS):
        print("training path: a kernel was not launched", file=sys.stderr)
        ok = False
    return ok, dict(sorted(total.items()))


def drive_zoo(dev):
    """One Adam step of each zoo model that only the training slice has,
    at batch 16 and T=100 on the card: ``SemVecToCpModel``,
    ``SemVecToMelModel``, ``ForwardModelMelTimeSmoothResidual`` and
    ``MelEmbeddingModelMelSmoothResidualUpsampling`` (each 4 layers at
    H=180, their default widths: B3/B4 twice), and
    ``LSTMCritic`` and ``LSTMGenerator`` (H=200) in training (dropout 0.5,
    masks drawn on the card: B1/B2 per layer) and in eval (B3/B4).  ->
    (ok, {(kernel, T, B, H): launches})."""
    gen = torch.Generator().manual_seed(3)
    drop = torch.Generator(device=dev).manual_seed(3)
    b, t = 16, 100
    x300 = _normal(gen, (b, t, 300), 0.5, dev)
    vec = _normal(gen, (b, 300), 0.3, dev)
    noise = _normal(gen, (b, t, 60), 1.0, dev)
    x30 = _normal(gen, (b, t, 30), 0.5, dev)
    cases = [
        ("SemVecToCpModel", TM.SemVecToCpModel(), lambda m: m(x300), True),
        ("SemVecToMelModel", TM.SemVecToMelModel(), lambda m: m(x300), True),
        ("ForwardModelMelTimeSmoothResidual",
         TM.ForwardModelMelTimeSmoothResidual(), lambda m: m(x30), True),
        ("MelEmbeddingModelMelSmoothResidualUpsampling",
         TM.MelEmbeddingModelMelSmoothResidualUpsampling(),
         lambda m: m(noise), True),
    ]
    for training in (True, False):
        kw = {"generator": drop} if training else {}
        cases += [
            (f"LSTMCritic train={training}", TM.LSTMCritic(),
             lambda m, kw=kw: m(x30, None, vec, **kw), training),
            (f"LSTMGenerator train={training}", TM.LSTMGenerator(),
             lambda m, kw=kw: m(noise, None, vec, **kw), training)]
    ok = True
    K.reset_launch_counts()
    with shape_tally() as tally:
        for name, model, call, training in cases:
            init_random(model.to(dev), gen).train(training)
            opt = torch.optim.Adam(model.parameters(), lr=1e-4)
            before = [p.detach().clone() for p in model.parameters()]
            loss = call(model).pow(2).mean()
            loss.backward()
            opt.step()
            loss = float(loss.detach())
            moved = any(not torch.equal(p, q)
                        for p, q in zip(model.parameters(), before))
            ok = ok and np.isfinite(loss) and moved
            print(f"  {name}: loss {loss:.6f}, parameters moved: "
                  f"{moved}")
    shapes = dict(sorted(tally.items()))
    print(f"  launches {counts()}; by kernel and (T, B, H): " + ", ".join(
        f"{k[0]} {k[1:]} {n}" for k, n in shapes.items()))
    if not ok or not all(counts().values()):
        print("zoo: a non-finite loss, a model that did not move or a kernel "
              "not launched", file=sys.stderr)
        ok = False
    return ok, shapes


def check_pretrain_against_cpu():
    """The same training on the card (float32) and on the CPU (float64),
    from the same initial parameters and corpus (2 classes of 18 variants:
    2 full batches of 16 an epoch): two epochs of ``train_forward`` and
    one of ``train_embedder`` at the release's widths, and one epoch of
    ``train_gan`` (``Generator()`` + ``Critic()``, a generator step after
    every critic step) with the random draws made on the CPU and handed to
    both through ``draw``.  Per-epoch losses agree within
    :data:`PLAN_RTOL`."""
    data = R.splits(R.build_corpus(pretrain_cfg(classes=2, babble=0),
                                   "cuda"))["lex_train"]
    init = torch.Generator().manual_seed(11)
    f64 = dict(dtype=torch.float64)
    models = {
        "forward": init_random(TM.ForwardModel(num_lstm_layers=1,
                                                 hidden_size=720).to(**f64),
                                 init),
        "embedder": init_random(TM.EmbeddingModel(
            num_lstm_layers=2, hidden_size=720).to(**f64), init),
        "generator": init_random(TM.Generator().to(**f64), init),
        "critic": init_random(TM.Critic().to(**f64), init)}

    def draws():
        gen = torch.Generator().manual_seed(5)

        def draw(what, shape):
            sample = torch.rand if what == "eps" else torch.randn
            return sample(shape, generator=gen, dtype=torch.float64)
        return draw

    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        m = {k: copy.deepcopy(v).to(device=dev, dtype=dtype)
             for k, v in models.items()}
        fit = dict(batch_size=16, exact_batch_only=True)
        _f, fwd = PT.train_forward(m["forward"], data, n_epochs=2, **fit)
        _e, emb = PT.train_embedder(m["embedder"], data, n_epochs=1, **fit)
        _g, _c, gan = PT.train_gan(m["generator"], m["critic"], data,
                                   n_epochs=1, n_critic=1, draw=draws(),
                                   **fit)
        out[dev] = {"train_forward": np.array(fwd),
                    "train_embedder": np.array(emb),
                    "train_gan": np.array(gan)}
    errs = rel_errs(out, tuple(out["cpu"]))
    err = max(errs.values())
    print(f"training, card f32 vs CPU f64 (batch 16, full width): max rel err "
          f"{err:.3e} (tol {PLAN_RTOL}); per series " + ", ".join(
              f"{s} {e:.1e}" for s, e in errs.items()) + "; card losses "
          + ", ".join(f"{s} {np.round(v, 6).tolist()}"
                      for s, v in out["cuda"].items()))
    return err <= PLAN_RTOL


# ---------------------------------------------------------------------------
# the last modules of the port: the release fallback (F1), Griffin-Lim's
# overlap-add (F2), synthesis overlapped with planning (8e), data
# parallelism over a mesh (item 11) and the reference bridge (item 12)
# ---------------------------------------------------------------------------

#: the overlap phase's settings against one segment (relative, float32)
OVERLAP_RTOL = 1e-6
#: the sharded batched planner against the unsharded one (relative, f32)
SHARD_RTOL = 1e-5
OVERLAP_SERIES = ("planned_loss_steps", "planned_mel_loss_steps",
                  "prod_loss_steps", "pred_semvec_loss_steps",
                  "prod_semvec_loss_steps", "pred_model_loss",
                  "inv_model_loss")


def max_rel(a, b):
    """The largest ``|a - b|`` relative to ``max |b|``."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max(initial=0.0) / max(np.abs(b).max(
        initial=0.0), 1e-30))


def check_release_fallback(target):
    """F1: under ``PAULE_TPU_NO_RELEASE=1``, two ``Paule()`` on the card
    build with the seeded random weights of ``pretrained_dir="random"`` and
    print the fallback hint once between them; one plans a few steps.
    -> ok."""
    REL._PRINTED_FALLBACK_HINT = False
    os.environ["PAULE_TPU_NO_RELEASE"] = "1"
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            made = [Paule(seed=7) for _ in range(2)]
    finally:
        del os.environ["PAULE_TPU_NO_RELEASE"]
    rand = Paule(seed=7, pretrained_dir="random")
    try:
        same = all(torch.equal(a, b) for p in made for a, b in zip(
            p.pred_model.state_dict().values(),
            rand.pred_model.state_dict().values()))
        r = made[0].plan_resynth(
            target_acoustic=target, objective="acoustic", n_outer=1,
            n_inner=4, log_ii=1, continue_learning=False, verbose=False)
    finally:
        for p in (*made, rand):
            p.close()
    hints = out.getvalue().count("no pretrained weight release found")
    print(f"  PAULE_TPU_NO_RELEASE=1: two Paule() on {made[0].device}, the "
          f"hint printed {hints} time(s); weights equal to "
          f"pretrained_dir='random': {same}; planned_loss_steps "
          f"{np.round(r.planned_loss_steps, 5).tolist()}")
    ok = (hints == 1 and same and len(r.planned_loss_steps) == 4
          and np.isfinite(r.planned_loss_steps).all())
    if not ok:
        print("release fallback: no single hint, other weights or a bad "
              "plan", file=sys.stderr)
    return ok


def overlap_add_index_add(istft, spec):
    """The overlap-add Griffin-Lim had before (an atomic ``index_add_``),
    on the same inputs as ``istft``, for the timing beside it."""
    frames = spec.shape[0]
    time_frames = torch.fft.irfft(spec, GL.N_FFT, dim=-1) * istft.win
    idx = (torch.arange(frames, device=spec.device)[:, None] * GL.HOP
           + torch.arange(GL.N_FFT, device=spec.device)[None, :]).reshape(-1)
    y = torch.zeros(GL.HOP * (frames - 1) + GL.N_FFT, dtype=istft.win.dtype,
                    device=spec.device)
    y.index_add_(0, idx, time_frames.reshape(-1))
    pad = GL.N_FFT // 2
    return (y / istft.wss)[pad:pad + istft.length]


def check_griffin_lim(target):
    """F2: two card runs of ``mel_to_sig`` on the target's mel (201 frames)
    are equal bit for bit; the overlap-add (one inverse STFT) timed against
    the ``index_add_`` one it replaced, in the same run.  -> ok."""
    mel = audio_target_to_mel(target, device="cuda",
                              dtype=torch.float32)[2]
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(mel_to_sig(mel, device="cuda", dtype=torch.float32)[0])
        wall = time.perf_counter() - t0
    equal = np.array_equal(runs[0], runs[1])
    frames = mel.shape[0]
    gen = torch.Generator().manual_seed(5)
    spec = torch.complex(torch.randn((frames, 513), generator=gen),
                         torch.randn((frames, 513), generator=gen)).cuda()
    istft = GL._Istft(frames, GL.HOP * (frames - 1), torch.float32,
                      torch.device("cuda"))
    new_ms = cuda_ms(lambda: istft(spec), 50)
    old_ms = cuda_ms(lambda: overlap_add_index_add(istft, spec), 50)
    diff = float((istft(spec) - overlap_add_index_add(istft, spec)).abs()
                 .max())
    old_same = torch.equal(overlap_add_index_add(istft, spec),
                           overlap_add_index_add(istft, spec))
    print(f"  mel_to_sig on the card ({frames} frames, 32 iterations): two "
          f"runs bit-equal: {equal}; {wall:.3f} s a run (host clock)")
    print(f"  inverse STFT of {frames} frames: ordered overlap-add "
          f"{new_ms:.4f} ms, index_add_ {old_ms:.4f} ms (CUDA events, 50 "
          f"calls); max|difference| {diff:.3e}; two index_add_ calls "
          f"bit-equal: {old_same}")
    if not equal:
        print("griffin-lim: two card runs differ", file=sys.stderr)
    return equal


#: rounds of :func:`time_overlap`
OVERLAP_ROUNDS = 7


def time_overlap(paule, kw, state):
    """The main path's warm call in :data:`OVERLAP_ROUNDS` rounds, each
    round running every setting once in turn, so that drift across the
    rounds touches them alike: one segment; two chunks on the default
    synthesizer pool; two chunks on a pool of one synthesizer fewer (a
    core left to the thread that queues the kernels while a chunk
    synthesises); two chunks on a pool of 4.  Prints each setting's
    median wall, planning and synthesis time, and every wall."""
    default_plant = paule.plant
    n_pool = len(default_plant._handles)
    pools = {n: synth.SynthPool(size=n) for n in (n_pool - 1, 4)}
    settings = {"one segment": (False, default_plant),
                "2 chunks": (2, default_plant),
                **{f"2 chunks, a pool of {n}": (2, pool)
                   for n, pool in pools.items()}}
    times = {name: [] for name in settings}
    try:
        for _ in range(OVERLAP_ROUNDS):
            for name, (setting, plant) in settings.items():
                CK.restore_paule_state(paule, state)
                paule.plan_overlap = setting
                paule.plant = plant
                t0 = time.perf_counter()
                paule.plan_resynth(**kw)
                torch.cuda.synchronize()
                t = paule.last_planning_timings
                times[name].append((time.perf_counter() - t0,
                                    t["planning"], t["synthesis"]))
    finally:
        paule.plant = default_plant
        for pool in pools.values():
            pool.close()
    print(f"  warm call, median of {OVERLAP_ROUNDS} interleaved rounds "
          f"(default pool {n_pool} synthesizers, {os.cpu_count()} cores):")
    for name, rows in times.items():
        wall, plan, syn = np.median(np.array(rows), axis=0)
        print(f"    {name}: wall {wall:.3f} s, planning {plan:.3f} s, "
              f"synthesis {syn:.3f} s; walls "
              + ", ".join(f"{r[0]:.3f}" for r in rows))


def drive_overlap(paule, target):
    """8e: the main path's warm call (``drive_continue_learning``'s budget,
    seed 7) from one state with ``plan_overlap`` False, 2 and 3 chunks,
    and with 2 chunks and ``async_chunk_fetch=False``: the planned cp and
    every loss series agree to :data:`OVERLAP_RTOL` relative (and are
    compared bit for bit; the blocking copies must give the same bits),
    each setting's phase split, the timing of :func:`time_overlap`, and
    the device-busy share per phase of one traced call without and with
    overlap.  -> ok."""
    kw = dict(target_acoustic=target, initialize_from="acoustic",
              objective="acoustic_semvec", n_outer=2, n_inner=24, log_ii=1,
              continue_learning=True, continue_learning_inv=True, seed=7,
              verbose=False)
    state = CK.paule_state(paule)
    runs = {}
    try:
        for setting in (False, 2, 3):
            CK.restore_paule_state(paule, state)
            paule.plan_overlap = setting
            runs[setting] = timed_plan(paule, kw,
                                       f"  plan_overlap={setting}")
        CK.restore_paule_state(paule, state)
        paule.plan_overlap = 2
        paule.async_chunk_fetch = False
        runs["blocking"] = timed_plan(
            paule, kw, "  plan_overlap=2, async_chunk_fetch=False")
        paule.async_chunk_fetch = True
        ok = True
        for setting in (2, 3, "blocking"):
            a, b = runs[setting][0], runs[False][0]
            err = max([max_rel(a.planned_cp, b.planned_cp)]
                      + [max_rel(getattr(a, s), getattr(b, s))
                         for s in OVERLAP_SERIES])
            bits = np.array_equal(a.planned_cp, b.planned_cp) and all(
                np.array_equal(getattr(a, s), getattr(b, s))
                for s in OVERLAP_SERIES)
            print(f"  plan_overlap={setting} against False: max rel err "
                  f"{err:.3e} (tol {OVERLAP_RTOL}); bit-equal: {bits}; "
                  f"launches {runs[setting][1]} (False: {runs[False][1]})")
            ok = ok and err <= OVERLAP_RTOL
        a, b = runs["blocking"][0], runs[2][0]
        same = np.array_equal(a.planned_cp, b.planned_cp) and all(
            np.array_equal(getattr(a, s), getattr(b, s))
            for s in OVERLAP_SERIES)
        print(f"  async_chunk_fetch=False against True (2 chunks): "
              f"bit-equal: {same}; wall {runs['blocking'][2]['wall']:.3f} s "
              f"against {runs[2][2]['wall']:.3f} s")
        ok = ok and same
        time_overlap(paule, kw, state)
        for setting in (False, 2):
            CK.restore_paule_state(paule, state)
            paule.plan_overlap = setting
            print(f"  device-busy share per phase, plan_overlap={setting} "
                  "(one traced call):")
            busy = device_busy_share(lambda: paule.plan_resynth(**kw),
                                     runs[setting][2])
            ok = ok and "planning" in busy
    finally:
        paule.plan_overlap = True
        paule.async_chunk_fetch = True
        CK.restore_paule_state(paule, state)
    if not ok:
        print("overlap: the settings disagree, or no phase ranges",
              file=sys.stderr)
    return ok


def _step_errs(a, b, steps=(0, 2, 11, 23)):
    """The planning sub-losses' largest relative difference (all fields,
    every utterance) at each of ``steps``, ``a`` and ``b`` two
    :class:`~paule_tpu_torch.planning.engine.SubLosses` of ``(n_steps,
    B)`` arrays."""
    errs = [max(max_rel(getattr(a, f)[i], getattr(b, f)[i])
                for f in a._fields) for i in steps]
    return ", ".join(f"step {i + 1} {e:.1e}" for i, e in zip(steps, errs))


def check_sharded_train_step(paule, mesh, n_frames):
    """Continue-learning's step with a mesh, on the card: two Adam steps
    of the predictive model on batches of 8 seeded (cp, mel) pairs
    (``n_frames`` mel frames, twice as many cp frames) split
    over ``mesh`` (two shards of 4), the second shard predicted by a copy
    of the model, so that its gradients are reduced into the model's and
    the copy is synced after each step (what a second card would run),
    against ``train_batch`` on the whole batches, from the same weights
    and a fresh Adam each: the losses and every updated weight agree to
    :data:`SHARD_RTOL` relative, and the copy holds the model's weights.
    -> ok."""
    gen = torch.Generator(device=paule.device).manual_seed(11)
    whole, sharded = (ModelTrainer(copy.deepcopy(paule.pred_model))
                      for _ in range(2))
    twin = copy.deepcopy(sharded.model)
    replicas = [sharded.model, twin]
    loss_err = 0.0
    for _ in range(2):
        x = torch.rand((8, 2 * n_frames, 30), generator=gen,
                       device=paule.device) * 2 - 1
        y = torch.randn((8, n_frames, 60), generator=gen,
                        device=paule.device)
        ref = whole.train_batch(x, y)
        out = sharded.train_batch(TMesh.shard_batch(mesh, x),
                                  TMesh.shard_batch(mesh, y),
                                  replicas=replicas)
        TMesh.sync_replicas(sharded.model, replicas)
        loss_err = max(loss_err, max_rel(out.item(), ref.item()))
    w_err = max(max_rel(a.cpu(), b.cpu()) for a, b in zip(
        sharded.model.parameters(), whole.model.parameters()))
    synced = all(torch.equal(a, b) for a, b in zip(
        sharded.model.parameters(), twin.parameters()))
    print(f"  training step over the mesh, the second shard on a copy of "
          f"the model, against train_batch on the whole batch of 8 (2 Adam "
          f"steps): loss max rel err {loss_err:.3e}, weights {w_err:.3e} "
          f"(tol {SHARD_RTOL}); the copy synced: {synced}")
    return loss_err <= SHARD_RTOL and w_err <= SHARD_RTOL and synced


def drive_sharded(paule, main_times):
    """Item 11 on ``drive_batched``'s 8 targets of 402 cp frames over
    ``make_mesh(devices=["cuda:0", "cuda:0"])`` (dp=2: two shards of 4 on
    one card).  First the sharding alone: ``plan_batch`` (24 steps, no
    training, which would couple the shards) sharded against the
    unsharded plans of the same two halves, each at batch 4 as a shard:
    the cp and sub-losses agree to :data:`SHARD_RTOL` relative (bit-equal
    expected: B1-B4 give a row the same bits wherever it sits in a
    batch).  Both against the unsharded plan of all 8, step by step: the
    witness that batch size alone sets how far a sharded plan drifts from
    the unsharded one.  Then continue-learning's sharded training step
    (:func:`check_sharded_train_step`).  Then ``plan_batch_resynth``
    (``objective="acoustic_semvec", n_outer=2, n_inner=24``,
    continue-learning, 2 epochs of batches of 8) unsharded and sharded
    from one state: launches by (T, B, H), utterances per second, and the
    difference of every series, of which the first planning step's
    sub-losses are held to :data:`SHARD_RTOL` (later steps are not: the
    kernels at batch 4 and 8 round a row differently, by ~1e-8, and Adam's
    first steps move every cp whose gradient is near its ``eps`` by up to
    the learning rate, whatever the gradient's size).  -> ok."""
    targets = [synth_target(402, seed=10 + i) for i in range(8)]
    mels = np.stack([audio_target_to_mel(t, device=paule.device,
                                         dtype=paule.dtype)[2]
                     for t in targets])
    mesh = TMesh.make_mesh(devices=["cuda:0", "cuda:0"])
    plan_kw = dict(n_steps=24, objective="acoustic_semvec",
                   log_semantics=True, synthesize=False)
    sharded = TB.plan_batch(paule, mels, mesh=mesh, **plan_kw)
    halves = [TB.plan_batch(paule, mels[i:i + 4], **plan_kw) for i in (0, 4)]
    full = TB.plan_batch(paule, mels, **plan_kw)
    joined = {"planned_cp": np.concatenate([h["planned_cp"]
                                            for h in halves]),
              "sub_losses": type(full["sub_losses"])(*(np.concatenate(
                  [getattr(h["sub_losses"], f) for h in halves], axis=1)
                  for f in full["sub_losses"]._fields))}
    exact = [(sharded["planned_cp"], joined["planned_cp"])] + [
        (getattr(sharded["sub_losses"], f), getattr(joined["sub_losses"], f))
        for f in full["sub_losses"]._fields]
    exact_err = max(max_rel(a, b) for a, b in exact)
    bits = all(np.array_equal(a, b) for a, b in exact)
    print(f"  plan_batch, 24 steps, dp=2 against the unsharded halves at "
          f"batch 4: max rel err {exact_err:.3e} (tol {SHARD_RTOL}); "
          f"bit-equal: {bits}")
    for name, run in (("dp=2", sharded), ("the unsharded halves", joined)):
        steps = _step_errs(run["sub_losses"], full["sub_losses"])
        cp_err = max_rel(run["planned_cp"], full["planned_cp"])
        print(f"  plan_batch, {name} against the unsharded batch of 8, not "
              f"held: sub-losses {steps}; planned_cp {cp_err:.1e}")
    ok_train = check_sharded_train_step(paule, mesh, mels.shape[1])

    kw = dict(objective="acoustic_semvec", n_outer=2, n_inner=24,
              continue_learning=True)
    state = CK.paule_state(paule)
    runs = {}
    try:
        # the first sharded call pays for the B=4 shapes' set-up
        TB.plan_batch_resynth(paule, mels, mesh=mesh, **kw)
        for name, m in (("mesh=None", None), (f"mesh={mesh}", mesh)):
            CK.restore_paule_state(paule, state)
            paule._py_rng.seed(7)
            K.reset_launch_counts()
            t0 = time.perf_counter()
            out, shapes = launches_by_shape(
                lambda m=m: TB.plan_batch_resynth(paule, mels, mesh=m, **kw))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[name] = (out, shapes, wall, counts(),
                          dict(paule.last_planning_timings))
    finally:
        CK.restore_paule_state(paule, state)
    (one, _s1, w1, _l1, _t1), (two, shapes, w2, launches, t2) = runs.values()
    errs = {"planned_cp": max_rel(two["planned_cp"], one["planned_cp"])}
    for key in ("prod_loss_curve", "prod_semvec_loss_curve",
                "pred_model_loss"):
        errs[key] = max_rel(two[key], one[key])
    errs["sub_losses"] = max(
        max_rel(getattr(a, f), getattr(b, f))
        for a, b in zip(two["sub_losses"], one["sub_losses"])
        for f in a._fields)
    first_err = max(max_rel(getattr(two["sub_losses"][0], f)[0],
                            getattr(one["sub_losses"][0], f)[0])
                    for f in two["sub_losses"][0]._fields)
    print(f"  plan_batch_resynth unsharded: {w1:.3f} s, {8 / w1:.2f} "
          f"utterances per s; dp=2 on one card: {w2:.3f} s, {8 / w2:.2f} "
          f"utterances per s (main path's warm plan_resynth: "
          f"{1 / main_times['wall']:.2f} per s)")
    print("  dp=2 phases: " + ", ".join(f"{k} {v:.3f} s"
                                        for k, v in t2.items()))
    print(f"  dp=2 against unsharded: first planning step's sub-losses max "
          f"rel err {first_err:.3e} (tol {SHARD_RTOL}); the whole run, not "
          "held: " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
          + "; its first outer iteration's sub-losses "
          + _step_errs(two["sub_losses"][0], one["sub_losses"][0]))
    print(f"  dp=2 launches: {launches}; by kernel and (T, B, H): "
          + ", ".join(f"{k[0]} {k[1:]} {n}" for k, n in shapes.items()))
    ok = (exact_err <= SHARD_RTOL and first_err <= SHARD_RTOL and ok_train
          and all(shapes.get((name, t, 4, H), 0) > 0 for name, t in (
              ("lstm_fwd", 402), ("lstm_bwd", 402), ("lstm_stack2_fwd", 201),
              ("lstm_stack2_bwd", 201))))
    if not ok:
        print("sharded path: disagrees with the unsharded plans, or B1-B4 "
              "did not run at the shards' batch of 4", file=sys.stderr)
    return ok


TP_RTOL = 1e-6
#: the planning steps whose sub-losses (b) prints, from 0
TP_STEPS = (0, 1, 2, 11, 23)


def tp_meshes():
    """``2 x 2`` and ``2 x 1`` meshes of the one card, listed 4 and 2
    times: the tensor-parallel code on one device."""
    return (TMesh.make_mesh(devices=["cuda:0"] * 4, dp=2, tp=2),
            TMesh.make_mesh(devices=["cuda:0"] * 2, dp=2, tp=1))


def check_tp_forward(paule, mesh):
    """(a): the release forward model with its LSTM split over row 0 of
    ``mesh`` (tp=2) against itself whole, on a seeded (4, 402, 30) input:
    the output and the gradients to the input and to every weight (the
    blocks' summed into their columns), to :data:`TP_RTOL` relative
    (bit-equal expected); one call launches exactly one B1 and its
    backward exactly one B2.  -> ok."""
    model = copy.deepcopy(paule.pred_model).requires_grad_(True)
    split = copy.deepcopy(model)
    rep = TMesh.replicate(mesh, split)[0]
    gen = torch.Generator(device=paule.device).manual_seed(12)
    x = torch.rand((4, 402, 30), generator=gen, device=paule.device) * 2 - 1
    cot = torch.randn((4, 201, 60), generator=gen, device=paule.device)
    runs = {}
    for name, m in (("whole", model), ("tp=2", rep)):
        xg = x.clone().requires_grad_(True)
        K.reset_launch_counts()
        out = m(xg)
        torch.cuda.synchronize()
        fwd = counts()
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        runs[name] = (out.detach(), xg.grad, fwd, counts())
    (out1, dx1, _f1, _b1), (out2, dx2, fwd, bwd) = runs.values()
    TMesh.reduce_grads(split, [rep])
    pairs = [("output", out2, out1), ("d input", dx2, dx1)] + [
        (f"d {n}", q.grad, p.grad) for (n, p), q in zip(
            model.named_parameters(), split.parameters())]
    errs = {name: max_rel(a.cpu(), b.cpu()) for name, a, b in pairs}
    bits = all(torch.equal(a, b) for _n, a, b in pairs)
    on_blocks = all(w.grad.device == w.device for w in rep.lstm[0].w_hh)
    print("  (a) release forward model, LSTM over tp=2, against itself "
          "whole at (4, 402, 30): max rel err " + ", ".join(
              f"{k} {v:.1e}" for k, v in errs.items())
          + f" (tol {TP_RTOL}); bit-equal: {bits}; launches of one call "
          f"{fwd}, after its backward {bwd}; w_hh gradient blocks on their "
          f"blocks' devices: {on_blocks}")
    want_fwd = dict.fromkeys(fwd, 0) | {"lstm_fwd": 1}
    return (max(errs.values()) <= TP_RTOL and on_blocks and fwd == want_fwd
            and bwd == want_fwd | {"lstm_bwd": 1})


def check_tp_train_step(paule, tp2, tp1, n_frames):
    """(c): two Adam steps of a copy of the release forward model on seeded
    batches of 8 split over ``tp2`` (its replicas' LSTMs split over tp=2,
    their gradients reduced into the model's columns, the replicas synced
    after each step) against the same over ``tp1``: the losses and every
    weight agree to :data:`TP_RTOL` relative, and each replica's blocks
    hold the model's columns.  -> ok."""
    gen = torch.Generator(device=paule.device).manual_seed(11)
    trainers = {m: ModelTrainer(copy.deepcopy(paule.pred_model))
                for m in (tp1, tp2)}
    replicas = {m: TMesh.replicate(m, t.model) for m, t in trainers.items()}
    loss_err = 0.0
    for _ in range(2):
        x = torch.rand((8, 2 * n_frames, 30), generator=gen,
                       device=paule.device) * 2 - 1
        y = torch.randn((8, n_frames, 60), generator=gen,
                        device=paule.device)
        losses = []
        for m, t in trainers.items():
            losses.append(t.train_batch(
                TMesh.shard_batch(m, x), TMesh.shard_batch(m, y),
                replicas=replicas[m]).item())
            TMesh.sync_replicas(t.model, replicas[m])
        loss_err = max(loss_err, max_rel(losses[1], losses[0]))
    w_err = max(max_rel(a.cpu(), b.cpu()) for a, b in zip(
        trainers[tp2].model.parameters(), trainers[tp1].model.parameters()))
    synced = all(torch.equal(q, p if cols is None else p[..., cols])
                 for rep in replicas[tp2]
                 for p, q, cols in TMesh.param_pairs(trainers[tp2].model,
                                                     rep))
    print(f"  (c) training step over dp=2 x tp=2 against dp=2 x tp=1 (2 Adam "
          f"steps, batches of 8): loss max rel err {loss_err:.3e}, weights "
          f"{w_err:.3e} (tol {TP_RTOL}); the replicas' blocks synced: "
          f"{synced}")
    return loss_err <= TP_RTOL and w_err <= TP_RTOL and synced


def drive_tp(paule, main_times):
    """The mesh's ``tp`` axis at full width, the counterpart of
    ``__graft_entry__.dryrun_multichip``'s three parts: the release
    weights (H=720) on ``drive_sharded``'s 8 targets of 402 cp frames over
    ``make_mesh(devices=["cuda:0"] * 4, dp=2, tp=2)`` (one card listed
    four times), against ``dp=2, tp=1``: (a) the forward model split
    against itself whole (:func:`check_tp_forward`); (b) ``plan_batch``,
    24 steps, step by step (both sides run the kernels at B=4, so
    bit-equal is expected; if not, the difference at steps 1, 2, 3, 12
    and 24 is printed and step 1 held to :data:`TP_RTOL`), beside the
    same steps of dp=2 x tp=1 against the unsharded batch of 8 (the drift
    of another batch size's rounding, the witness in the same run), with
    the bytes moved between leads and blocks per inner step and dp row
    (``ops.lstm.gather.bytes``, the 24-step run's less a 1-step run's,
    over 23); (c) the training step
    (:func:`check_tp_train_step`); (d) ``plan_corpus_batched``, 2 x 24
    steps with continue-learning, warm, timed tp=1, tp=2, tp=2, tp=1 from
    one state: utterances per second, launches by (T, B, H), bytes
    moved per inner step and the difference of the results (not held;
    training reduces the weight gradients in another order).  -> (ok,
    the tp=2 run's launches)."""
    targets = [synth_target(402, seed=10 + i) for i in range(8)]
    mels = np.stack([audio_target_to_mel(t, device=paule.device,
                                         dtype=paule.dtype)[2]
                     for t in targets])
    tp2, tp1 = tp_meshes()
    dp = tp2.shape["dp"]
    ok_fwd = check_tp_forward(paule, tp2)

    plan_kw = dict(objective="acoustic_semvec", log_semantics=True,
                   synthesize=False)
    one = TB.plan_batch(paule, mels, mesh=tp1, n_steps=24, **plan_kw)
    gathered = {}
    for n in (1, 24):
        LS.gather.bytes = 0
        K.reset_launch_counts()
        two, shapes = launches_by_shape(lambda n=n: TB.plan_batch(
            paule, mels, mesh=tp2, n_steps=n, **plan_kw))
        gathered[n] = LS.gather.bytes
    step_bytes = (gathered[24] - gathered[1]) / 23 / dp
    exact = [(two["planned_cp"], one["planned_cp"])] + [
        (getattr(two["sub_losses"], f), getattr(one["sub_losses"], f))
        for f in one["sub_losses"]._fields]
    bits = all(np.array_equal(a, b) for a, b in exact)
    first_err = max(max_rel(getattr(two["sub_losses"], f)[0],
                            getattr(one["sub_losses"], f)[0])
                    for f in one["sub_losses"]._fields)
    print(f"  (b) plan_batch, 24 steps, dp=2 x tp=2 against dp=2 x tp=1: "
          f"bit-equal: {bits}; step 1 max rel err {first_err:.3e} (tol "
          f"{TP_RTOL})")
    # the witness beside it: the rounding of another batch size (B=8
    # against the rows' 4) grows over the same 24 steps of the same run
    full = TB.plan_batch(paule, mels, n_steps=24, **plan_kw)
    for name, a, b in (("dp=2 x tp=2 against dp=2 x tp=1", two, one),
                       ("dp=2 x tp=1 against the unsharded batch of 8", one,
                        full)):
        print(f"  (b) {name}, not held: sub-losses "
              f"{_step_errs(a['sub_losses'], b['sub_losses'], TP_STEPS)}; "
              f"planned_cp {max_rel(a['planned_cp'], b['planned_cp']):.1e}")
    print(f"  (b) bytes moved between the rows' leads and blocks per inner "
          f"step and dp row (ops.lstm.gather.bytes): {step_bytes:.0f} "
          f"({step_bytes / 1e6:.1f} MB); launches of the 24 steps by kernel "
          "and (T, B, H): " + ", ".join(f"{k[0]} {k[1:]} {n}"
                                        for k, n in shapes.items()))
    ok_train = check_tp_train_step(paule, tp2, tp1, mels.shape[1])

    n_outer, n_inner = 2, 24
    kw = dict(max_batch=8, verbose=False, plan_kwargs=dict(
        objective="acoustic_semvec", n_outer=n_outer, n_inner=n_inner,
        continue_learning=True))
    state = CK.paule_state(paule)
    runs = collections.defaultdict(list)
    try:
        for m in (tp1, tp2):   # the first call of each pays its set-up
            X.plan_corpus_batched(paule, list(mels), mesh=m, **kw)
            CK.restore_paule_state(paule, state)
        for m in (tp1, tp2, tp2, tp1):
            paule._py_rng.seed(7)
            LS.gather.bytes = 0
            K.reset_launch_counts()
            t0 = time.perf_counter()
            out, shapes = launches_by_shape(
                lambda m=m: X.plan_corpus_batched(paule, list(mels), mesh=m,
                                                  **kw))
            torch.cuda.synchronize()
            runs[m].append((out, shapes, time.perf_counter() - t0, counts(),
                            LS.gather.bytes))
            CK.restore_paule_state(paule, state)
    finally:
        CK.restore_paule_state(paule, state)
    res1, res2 = runs[tp1][0][0], runs[tp2][0][0]
    errs = {key: max(max_rel(a[key], b[key]) for a, b in zip(res2, res1))
            for key in ("planned_cp", "prod_loss_curve",
                        "prod_semvec_loss_curve")}
    _o, shapes, _w, launches, run_bytes = runs[tp2][-1]
    walls = {m: [r[2] for r in rs] for m, rs in runs.items()}
    print(f"  (d) plan_corpus_batched, 8 x 402 cp frames, {n_outer} x "
          f"{n_inner} steps, continue-learning: dp=2 x tp=1 "
          + ", ".join(f"{w:.3f} s ({8 / w:.2f} utterances per s)"
                      for w in walls[tp1])
          + "; dp=2 x tp=2 " + ", ".join(
              f"{w:.3f} s ({8 / w:.2f} utterances per s)" for w in walls[tp2])
          + f" (main path's warm plan_resynth: {1 / main_times['wall']:.2f} "
          "per s)")
    print(f"  (d) tp=2 launches: {launches}; by kernel and (T, B, H): "
          + ", ".join(f"{k[0]} {k[1:]} {n}" for k, n in shapes.items())
          + f"; bytes moved between leads and blocks per inner step and "
          f"dp row: {run_bytes / (n_outer * n_inner) / dp / 1e6:.1f} MB "
          f"(planning, metrics and training)")
    print("  (d) tp=2 against tp=1, not held: " + ", ".join(
        f"{k} {v:.1e}" for k, v in errs.items()))
    ok_corpus = all(np.isfinite(r["planned_cp"]).all()
                    and r["planned_cp"].shape == (402, 30) for r in res2)
    ok_shapes = all(shapes.get((name, t, 4, H), 0) > 0 for name, t in (
        ("lstm_fwd", 402), ("lstm_bwd", 402), ("lstm_stack2_fwd", 201),
        ("lstm_stack2_bwd", 201)))
    ok = (ok_fwd and (bits or first_err <= TP_RTOL) and ok_train
          and ok_corpus and ok_shapes)
    if not ok:
        print("tp path: disagrees with tp=1, launched other than one B1 and "
              "one B2 per call, or B1-B4 did not run at the rows' batch of 4",
              file=sys.stderr)
    return ok, launches


def check_reference_bridge():
    """Item 12: the librosa, soundfile and toml stand-ins installed; each
    librosa stand-in against the port's own function on a seeded signal
    (float64, host).  -> ok."""
    before = set(sys.modules)
    RB.install_shims()
    added = sorted(set(sys.modules) - before)
    import librosa

    y = np.random.default_rng(9).normal(size=44100 // 2) * 0.1
    amp = librosa.feature.melspectrogram(
        y=y, sr=44100, n_fft=1024, hop_length=220, n_mels=60, power=1.0,
        fmin=10, fmax=12000)
    own = MEL.mel_amplitude_44100(torch.as_tensor(y)).numpy().T
    errs = {
        "melspectrogram": max_rel(amp, own),
        "amplitude_to_db": max_rel(
            librosa.amplitude_to_db(amp, ref=0.15).T,
            MEL.melspec_44100(torch.as_tensor(y)).numpy()),
        "resample": max_rel(
            librosa.resample(y, orig_sr=44100, target_sr=16000),
            resample(y, 44100, 16000)),
        "mel_to_audio": max_rel(
            librosa.feature.inverse.mel_to_audio(
                amp[:, :40], sr=44100, n_fft=1024, hop_length=220),
            GL.mel_amplitude_to_audio(amp[:, :40].T, device="cpu",
                                      dtype=torch.float64))}
    print(f"  stand-ins installed: {added}; reference_available(): "
          f"{RB.reference_available()}; against the port's own functions, "
          "max rel err: " + ", ".join(f"{k} {v:.1e}"
                                      for k, v in errs.items()))
    ok = max(errs.values()) == 0.0
    if not ok:
        print("reference bridge: a stand-in differs from the port's "
              "function", file=sys.stderr)
    return ok


#: the measurement tools at a cut budget (``drive_tools``): each tool's
#: ``run`` and its keywords
TOOL_RUNS = {
    "hot_timing": (hot_timing.run, dict(n_outer=1)),
    "roofline": (roofline.run, dict(batches=(1, 32), step_counts=(2, 4, 8),
                                    reps=3, step_reps=3)),
    "batch_scaling": (batch_scaling.run, dict(batches=(1, 32),
                                              step_counts=(2, 4, 8), reps=3)),
    "step_decomposition": (step_decomposition.run,
                           dict(step_counts=(2, 4, 8), reps=3)),
    "profile_device": (profile_device.run, dict(n_outer=1)),
    "bench_serve": (bench_serve.run, dict(n=2, plan_n=1)),
    "corpus_quality_run": (corpus_quality_run.run, dict(
        n_utt=8, n_outer=1, n_inner=5, babble_n=16, babble_epochs=2,
        n_long=200)),
    "release_quality_run": (release_quality_run.run,
                            dict(n_utt=8, n_outer=1, n_inner=5)),
    # the probe's own sweep at full budget, its roofline cut as above
    "launch_overhead_probe": (launch_overhead_probe.run, dict(
        roofline_kw=dict(step_counts=(2, 4, 8), reps=3, step_reps=3))),
    "synthesis_breakdown": (synthesis_breakdown.run, dict(
        reps=2, outers_per_rep=1, n_inner=5, n_epochs=1, n_batches=1,
        batch_size=4)),
    "bench_variants": (bench_variants.run, dict(
        reps=2, outers_per_rep=1, n_inner=5, n_epochs=1, n_batches=1,
        batch_size=4)),
}


def drive_tools():
    """The port's measurement and corpus-quality tools
    (``paule_tpu_torch/tools/``), each ``run`` on the card at the cut
    budget of :data:`TOOL_RUNS`: checks that every number of each result
    is finite (none missing), that each result names the card, and that
    ``profile_device``'s trace has every ``plan_resynth.<phase>`` range
    with its device time, above 0 in each phase that launches device work
    (all but the host's synthesis).  Prints each tool's headline numbers.
    -> ok."""
    ok = True
    out = {}
    for name, (tool_run, kw) in TOOL_RUNS.items():
        t0 = time.perf_counter()
        out[name] = res = tool_run(device="cuda", **kw)
        bad = [k for k, v in timing.leaf_numbers(res)
               if v is None or not np.isfinite(v)]
        if bad or res.get("device") != "cuda" or not res.get("card"):
            print(f"tools: {name} gave missing or non-finite numbers "
                  f"{bad[:8]} or no card", file=sys.stderr)
            ok = False
        print(f"  {name}: {time.perf_counter() - t0:.1f} s")
    t = out["hot_timing"]
    print(f"  hot_timing (1 outer): hot wall {t['hot_wall_s']:.3f} s; "
          + ", ".join(f"{k} {v:.3f} s" for k, v in t["timings"].items())
          + f"; final produced loss {t['final_prod_loss']:.4f}")
    for b, r in out["roofline"]["derived_vs_measured"].items():
        kern = out["roofline"]["per_step_us"][b]["kernels"]
        print(f"  roofline {b}: floor {r['derived_floor_ms']:.3f} ms, "
              f"measured {r['measured_ms_per_inner_step']:.3f} ms per inner "
              f"step (x{r['ratio']:.2f}); µs per step " + ", ".join(
                  f"{k} {v['slope_us']:.2f}" for k, v in kern.items()))
    print("  batch_scaling: " + ", ".join(
        f"{b} {r['per_inner_step_ms']:.3f} ms "
        f"({r['utterance_steps_per_s']:.0f} utterance-steps per s)"
        for b, r in out["batch_scaling"]["batches"].items()))
    print("  step_decomposition, ms per inner step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in
        out["step_decomposition"]["per_inner_step_ms"].items()))
    prof = out["profile_device"]
    trace = prof["profiler_trace"]
    print(f"  profile_device: planning {prof['planning_flops_per_s']:.3e} "
          f"FLOP/s ({prof['mfu_vs_f32_peak_B1']:.2%} of the f32 peak); "
          "traced phases: " + ", ".join(
              f"{k} busy {v['device_busy_s']:.3f} of {v['wall_s']:.3f} s "
              f"({v['device_busy_share_of_untraced']:.1%} of the untraced "
              f"{v['untraced_wall_s_per_outer']:.3f} s)"
              for k, v in trace.items()))
    # synthesis is host C++ (with plan_overlap only its tail waits here),
    # so its device time is measured but may be 0
    if set(trace) != set(PHASES) or not all(
            v["device_busy_s"] > 0 for k, v in trace.items()
            if k != "synthesis"):
        print(f"tools: profile_device's trace lacks a phase or its device "
              f"time ({sorted(trace)})", file=sys.stderr)
        ok = False
    print("  bench_serve, p50 ms: " + ", ".join(
        f"{k} {v.get('p50_ms', v.get('req_per_s')):.2f}"
        for k, v in out["bench_serve"]["metrics"].items()))
    c = out["corpus_quality_run"]
    print(f"  corpus_quality_run: corpus wall {c['corpus_wall_s']:.3f} s, "
          f"final produced loss median {c['final_prod_loss']['median']:.4f} "
          f"(pre-plan {c['preplan_prod_loss_median']:.4f}); long utterance "
          f"chunked / single {c['long_utterance']['chunked_over_single']:.3f}")
    print("  release_quality_run: " + ", ".join(
        f"{k} wall {v['corpus_wall_s']:.3f} s, median "
        f"{v['median_final_prod_loss']:.4f}"
        for k, v in out["release_quality_run"]["rows"].items()))
    return check_new_tools(out) and ok


def check_new_tools(out):
    """Prints the headline numbers of ``launch_overhead_probe``,
    ``synthesis_breakdown`` and ``bench_variants`` (``drive_tools``' run)
    and checks them: the probe's chains of 8 calls slower than its single
    calls at both lengths with a finite per-step cost; ``per_snapshot``
    synthesising snapshot by snapshot and the batch strategies in batch
    calls, each strategy's plant calls exactly as many as its plans,
    outer iterations and inner steps give; each variant's paired ratio
    finite.  -> ok."""
    ok = True
    lo = out["launch_overhead_probe"]
    for tag, fit in lo["per_launch"].items():
        dev = lo["per_launch_device"][tag]
        walls = lo["walls_ms"][tag]
        print(f"  launch_overhead_probe {tag}: per step "
              f"{fit['per_step_us']:.4f} µs host / {dev['per_step_us']:.4f} "
              f"device, fixed per call {fit['per_launch_fixed_us']:.2f} µs "
              f"host / {dev['per_launch_fixed_us']:.2f} device; walls ms "
              f"{walls}")
        t_lens = sorted({key.split("_")[0] for key in walls})
        if not (np.isfinite(fit["per_step_us"]) and all(
                walls[f"{t}_K8"] > walls[f"{t}_K1"] for t in t_lens)):
            print(f"tools: launch_overhead_probe {tag}: K=8 not slower "
                  f"than K=1, or a non-finite per-step cost", file=sys.stderr)
            ok = False
    proj = lo["projection"]
    print(f"  launch_overhead_probe projection: fixed-cost bill "
          f"{proj['fixed_cost_bill_ms']:.4f} ms host / "
          f"{proj['device_fixed_cost_bill_ms']:.4f} device per inner step "
          f"against measured - floor {proj['measured_minus_floor_ms']:.3f} "
          "ms")
    sb = out["synthesis_breakdown"]
    print(f"  synthesis_breakdown: C++ floor "
          f"{sb['standalone_cpp_ms_per_snapshot']} ms per snapshot; " +
          "; ".join(f"{n} {sb[n]['s_per_outer_median']} s per outer, "
                    f"synthesis {sb[n]['synthesis_ms_per_snapshot']} ms per "
                    f"snapshot, plant calls {sb[n]['native_calls']}"
                    for n in synthesis_breakdown.STRATEGIES))
    n_inner = TOOL_RUNS["synthesis_breakdown"][1]["n_inner"]
    for name in synthesis_breakdown.STRATEGIES:
        res = sb[name]
        plans, outers = res["plan_resynth_calls"], res["outers_run"]
        # one speak per plan for the initial trajectory; then one speak
        # per snapshot (one per inner step), one batch call per outer
        # iteration, or one per chunk of plan_overlap=2
        want = {"per_snapshot": {"speak": plans + outers * n_inner,
                                 "speak_batch": 0},
                "batch": {"speak": plans, "speak_batch": outers},
                "batch_overlap": {"speak": plans,
                                  "speak_batch": 2 * outers}}[name]
        if res["native_calls"] != want:
            print(f"tools: synthesis_breakdown {name} called the plant "
                  f"{res['native_calls']}, not {want}", file=sys.stderr)
            ok = False
    bv = out["bench_variants"]
    print("  bench_variants, s per outer: " + ", ".join(
        f"{n} {bv[n]['s_per_outer_median']}" + (
            f" (x{bv[n]['vs_acoustic_semvec_median']} of acoustic_semvec)"
            if n != "acoustic_semvec" else "")
        for n, _kw in bench_variants.VARIANTS))
    for name in ("speech_classifier", "somatosensory"):
        if not np.isfinite(bv[name]["vs_acoustic_semvec_median"]):
            print(f"tools: bench_variants {name} has no finite ratio",
                  file=sys.stderr)
            ok = False
    return ok


def header(name, t_start):
    """A phase's heading, with the seconds since the script started."""
    print(f"{name} ({time.perf_counter() - t_start:.1f} s in):")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = timing.card_line()
    print(card)
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(0)
    header("kernels against their plain versions", t_start)
    ok_c, core = check_core(dev, gen, 402, 1)
    # B=8: continue-learning's training batch, T=402 for the forward model
    ok_c8, core8 = check_core(dev, gen, 402, 8)
    # B=4: a shard of batched planning's 8 utterances over dp=2, and its
    # training batches of 8 split in two
    ok_c4, core4 = check_core(dev, gen, 402, 4)
    ok_s1, stack = check_stack2(dev, gen, 201, 1)
    ok_s4, stack4 = check_stack2(dev, gen, 201, 4)
    # B=24: the produced-audio metrics at the default budget (24 logged
    # snapshots per outer iteration); several row passes per warp
    ok_s24, stack24 = check_stack2(dev, gen, 201, 24)
    # B=8: batched planning's embedder (parallel.batched at max_batch=8),
    # forward and backward in every inner step
    ok_s8, stack8 = check_stack2(dev, gen, 201, 8)
    # T=201, B=8: the inverse model's training shape (201 mel frames)
    ok_ci8, core_inv8 = check_core(dev, gen, 201, 8)
    # T=201, B=1: the inverse model's initialisation of every plan from an
    # acoustic target (the physical path's only B1 launch at B=1)
    ok_ci1, core_inv1 = check_core(dev, gen, 201, 1)
    # the somatosensory variant: the cp->tube and tube->mel models at H=360
    # in planning (B=1), training (B=8) and the produced metrics (B=24,
    # forward only on the path); the tube embedder's two layers at T=402 as
    # the fused pair in eval mode (B=1: initial and final values, B=24: the
    # produced metrics)
    tube, ok_tube = {}, True
    for batch in (1, 8, 24):
        ok_t, tube[batch] = check_core(dev, gen, 402, batch, H_TUBE)
        ok_tube = ok_tube and ok_t
    ok_t1, tstack1 = check_stack2(dev, gen, 402, 1)
    ok_t24, tstack24 = check_stack2(dev, gen, 402, 24)
    # the training path (the release recipe at batch 16): B1/B2 at the
    # forward model's longest cp length, the inverse model's longest mel
    # length (and the embedder-free cp lengths), the tube models (H=360)
    # and the zoo's LSTMCritic/LSTMGenerator in training (H=200); B3/B4 at
    # the embedder's and the tube embedder's longest lengths, the zoo's
    # SemVecTo* pairs (H=180) and LSTM* in eval (H=200)
    train_core, train_stack, ok_train = {}, {}, True
    for seq, hidden in TRAIN_CORE_SHAPES:
        ok_t, train_core[(seq, hidden)] = check_core(dev, gen, seq, 16,
                                                     hidden)
        ok_train = ok_train and ok_t
    for seq, hidden in TRAIN_STACK_SHAPES:
        ok_t, train_stack[(seq, hidden)] = check_stack2(dev, gen, seq, 16,
                                                        hidden)
        ok_train = ok_train and ok_t
    ok_edges = check_edges(dev, gen)
    ok_layouts = check_bwd_layouts(dev)
    ok_one = check_one_kernel_per_call(dev, gen)
    ok = (ok_c and ok_c8 and ok_c4 and ok_s1 and ok_s4 and ok_s24 and ok_s8
          and ok_ci8 and ok_ci1 and ok_tube and ok_t1 and ok_t24 and ok_train
          and ok_edges and ok_layouts and ok_one)
    results = {**core, **stack}
    for name in core:
        merge_errors(name, results, core8, core4, core_inv8, core_inv1,
                     *tube.values(),
                     *train_core.values())
    for name in stack:
        merge_errors(name, results, stack4, stack24, stack8, tstack1,
                     tstack24, *train_stack.values())
    print_times("", results)
    print_times(" T=402 B=8", core8)
    print_times(" T=402 B=4", core4)
    print_times(" T=201 B=8", core_inv8)
    print_times(" T=201 B=1", core_inv1)
    print_times(" B=4", stack4)
    print_times(" B=24", stack24)
    print_times(" B=8", stack8)
    for batch, res in tube.items():
        print_times(f" T=402 B={batch} H={H_TUBE}", res)
    print_times(" T=402 B=1", tstack1)
    print_times(" T=402 B=24", tstack24)
    for (seq, hidden), res in [*train_core.items(), *train_stack.items()]:
        print_times(f" T={seq} B=16 H={hidden}", res)

    header("ceiling probes", t_start)
    ok_p, probe, probe_launches = run_probes()

    target = synth_target(402, seed=0)
    header(f"release fallback (F1), {card}", t_start)
    ok_f1 = check_release_fallback(synth_target(42, seed=1))
    header(f"Griffin-Lim (F2), {card}", t_start)
    ok_f2 = check_griffin_lim(target)

    header("main path", t_start)
    t0 = time.perf_counter()
    paule = Paule(seed=7)
    print(f"Paule() on {paule.device}: {time.perf_counter() - t0:.1f} s")
    try:
        ok_plan = drive_planning(paule, target)
        ok_cl, launches, main_times = drive_continue_learning(
            paule, target, {
                "pred": core8["lstm_fwd"]["ms"] + core8["lstm_bwd"]["ms"],
                "inv": (core_inv8["lstm_fwd"]["ms"]
                        + core_inv8["lstm_bwd"]["ms"])})
        header(f"synthesis overlapped with planning (8e), {card}", t_start)
        ok_ovl = drive_overlap(paule, target)
        header("semvec path", t_start)
        ok_sem = drive_semvec(paule, target)
        header("batched path", t_start)
        ok_bat = drive_batched(paule, main_times)
        header(f"batched path over a mesh (item 11), {card}", t_start)
        ok_dp = drive_sharded(paule, main_times)
        header(f"the mesh's tp axis (dryrun_multichip's three parts), "
               f"{card}", t_start)
        ok_tp, tp_launches = drive_tp(paule, main_times)
        header("iterative path", t_start)
        ok_it = drive_iterative(paule)
        header("HTTP service", t_start)
        ok_srv = drive_serve(paule)
    finally:
        paule.close()
    header("command line", t_start)
    ok_cli = drive_cli()
    header("somatosensory path", t_start)
    ok_som, _shapes = drive_somatosensory(target, launches, main_times)
    header("speech-classifier path", t_start)
    ok_sc = drive_speech_classifier(target)
    header("physical path", t_start)
    ok_phy, phy_launches = drive_physical(target, main_times)
    header("training path", t_start)
    with tempfile.TemporaryDirectory() as tmp:
        ok_pre, _pre_shapes = drive_pretrain(tmp)
    header("model zoo, one Adam step each", t_start)
    ok_zoo, _zoo_shapes = drive_zoo(dev)
    header("reference bridge (item 12)", t_start)
    ok_rb = check_reference_bridge()
    header(f"measurement and corpus-quality tools, {card}", t_start)
    ok_tools = drive_tools()
    header("card against the CPU", t_start)
    ok_cpu = check_against_cpu(False)
    ok_cpu_cl = check_against_cpu(True)
    ok_cpu_sem = check_semvec_against_cpu()
    ok_cpu_som = check_against_cpu(True, somatosensory=True)
    ok_cpu_bat = check_batched_against_cpu()
    ok_cpu_pre = check_pretrain_against_cpu()
    ok_cpu_phy = check_physical_against_cpu()
    ok = (ok and ok_p and ok_plan and ok_cl and ok_sem and ok_som and ok_sc
          and ok_phy and ok_bat and ok_it and ok_srv and ok_cli and ok_pre
          and ok_zoo and ok_cpu and ok_cpu_cl and ok_cpu_sem and ok_cpu_som
          and ok_cpu_bat and ok_cpu_pre and ok_cpu_phy and ok_f1 and ok_f2
          and ok_ovl and ok_dp and ok_tp and ok_rb and ok_tools)

    kernels = []
    for k in K.KERNELS:
        r = results[k.__name__]
        kernels.append({
            "name": k.__name__, "route": "cuda", "source": LSTM_SOURCE,
            "replaces": REPLACES[k.__name__],
            "launches": (launches[k.__name__] + phy_launches[k.__name__]
                         + tp_launches[k.__name__]),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    for k in P.KERNELS:
        name = k.__name__
        rows = [probe_row(name, probe[shape]) for shape in PROBE_SHAPES]
        kernels.append({
            "name": f"probe_{name}", "route": "cuda", "source": PROBE_SOURCE,
            "replaces": REPLACES[name], "launches": probe_launches[name],
            **{key: rows[0][key] for key in (
                "ms", "us_per_step", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape")},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "shapes": rows})
    print(f"whole script: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
