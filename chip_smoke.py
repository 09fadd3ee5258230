"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. prints the card's name and power limit, and builds the LSTM kernels
   from ``paule_tpu_torch/csrc/lstm.cu``;
2. holds each kernel (B1-B4) against its plain PyTorch version on the card
   at the shapes of the planning path, and times the kernel, the plain
   version and ``torch.nn.LSTM`` (cuDNN, a yardstick the port never calls);
3. drives ``paule_tpu_torch.api.Paule.plan_resynth`` once at full width
   (H=720, the in-repo release weights) on a synthesised target, checks its
   losses, and checks that every kernel was launched during that run;
4. prints one JSON line with the kernels' numbers and, last, one JSON line
   with the device.

Exits non-zero on any failure, and when no CUDA device is present.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from paule_tpu_torch import synth
from paule_tpu_torch.api import Paule
from paule_tpu_torch.ops import lstm_kernels as K
from paule_tpu_torch.ops.normalize import inv_normalize_cp

H = 720
#: tolerances of a kernel against its plain version in float32: the forward
#: outputs in absolute terms; gradients (dgates, input and weight grads) as
#: the relative Frobenius error, since ~400 steps of f32 recurrence summed
#: in another order drift by a few ulps per step
FWD_ATOL = 1e-4
GRAD_RTOL = 1e-3
#: a short plan in float32 on the card against float64 on the CPU: the
#: losses of three Adam steps, relative
PLAN_RTOL = 1e-3
#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: float32 FLOP/s outside the tensor cores (the kernels use FMA units)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

SOURCE = "paule_tpu_torch/csrc/lstm.cu"
REPLACES = {
    "lstm_fwd": "paule_tpu/ops/pallas_lstm.py:214",
    "lstm_bwd": "paule_tpu/ops/pallas_lstm.py:264",
    "lstm_stack2_fwd": "paule_tpu/ops/pallas_lstm.py:554",
    "lstm_stack2_bwd": "paule_tpu/ops/pallas_lstm.py:601",
}


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls, after one
    warm-up call (CUDA events around the whole run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def max_abs(pairs):
    return max(float((a - b).abs().max()) for a, b in pairs)


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _uniform(gen, shape, bound, dev):
    return ((torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1)
            * bound).to(dev)


def _normal(gen, shape, scale, dev):
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * scale).to(dev)


def cudnn_lstm_ms(n_in, n_layers, seq, batch, dev, backward):
    """``torch.nn.LSTM`` (cuDNN) at the kernel's shape: forward, or the
    backward of a retained graph."""
    lstm = torch.nn.LSTM(n_in, H, num_layers=n_layers).to(dev)
    x = torch.randn(seq, batch, n_in, device=dev, requires_grad=True)
    if not backward:
        with torch.no_grad():
            return cuda_ms(lambda: lstm(x), 20)
    out, _ = lstm(x)
    g = torch.randn_like(out)
    params = [x, *lstm.parameters()]
    return cuda_ms(lambda: torch.autograd.grad(out, params, g,
                                               retain_graph=True), 20)


def check_core(dev, gen, seq, batch):
    """B1 and B2 at (seq, batch, H) against their plain versions."""
    gx = _normal(gen, (seq, batch, 4 * H), 0.5, dev)
    w = _uniform(gen, (H, 4 * H), H ** -0.5, dev)
    h0 = _normal(gen, (batch, H), 0.1, dev)
    c0 = _normal(gen, (batch, H), 0.1, dev)
    gout = _normal(gen, (seq, batch, H), 1.0, dev)

    hs, cs = K.lstm_fwd(gx, w, h0, c0)
    hs_p, cs_p = K.lstm_fwd_plain(gx, w, h0, c0)
    fwd_err = max_abs([(hs, hs_p), (cs, cs_p)])

    hs_prev = torch.cat([h0[None], hs_p[:-1]])
    cs_prev = torch.cat([c0[None], cs_p[:-1]]).contiguous()
    acts = K.activate(gx + hs_prev @ w, H).contiguous()
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

    f32 = 4
    out = {
        "lstm_fwd": dict(
            max_abs_err=fwd_err, rel_err=None,
            ms=cuda_ms(lambda: K.lstm_fwd(gx, w, h0, c0), 20),
            plain_ms=cuda_ms(lambda: K.lstm_fwd_plain(gx, w, h0, c0), 3),
            library_ms=cudnn_lstm_ms(30, 1, seq, batch, dev, False),
            bound=bound_ms(f32 * (seq * batch * 6 * H + 4 * H * H
                                  + 2 * batch * H),
                           seq * batch * (8 * H * H + 13 * H))),
        "lstm_bwd": dict(
            max_abs_err=bwd_err, rel_err=max(bwd_rel, grad_rel),
            ms=cuda_ms(lambda: K.lstm_bwd(acts, cs_prev, gout, w), 20),
            plain_ms=cuda_ms(lambda: K.lstm_bwd_plain(acts, cs_prev, gout,
                                                      w), 3),
            library_ms=cudnn_lstm_ms(30, 1, seq, batch, dev, True),
            bound=bound_ms(f32 * (seq * batch * 10 * H + 4 * H * H
                                  + 2 * batch * H),
                           seq * batch * (8 * H * H + 20 * H))),
    }
    print(f"  B1 lstm_fwd  T={seq} B={batch}: fwd max|err| {fwd_err:.3e} "
          f"(tol {FWD_ATOL})")
    print(f"  B2 lstm_bwd  T={seq} B={batch}: dgates/dh0/dc0 max|err| "
          f"{bwd_err:.3e}, rel {bwd_rel:.3e}; input/weight grads rel "
          f"{grad_rel:.3e} (tol {GRAD_RTOL})")
    ok = fwd_err <= FWD_ATOL and bwd_rel <= GRAD_RTOL and grad_rel <= GRAD_RTOL
    return ok, out


def check_stack2(dev, gen, seq, batch):
    """B3 and B4 at (seq, batch, H) against their plain versions."""
    g1 = _normal(gen, (seq, batch, 4 * H), 0.5, dev)
    w1 = _uniform(gen, (H, 4 * H), H ** -0.5, dev)
    w2 = _uniform(gen, (2 * H, 4 * H), H ** -0.5, dev)
    b2 = _uniform(gen, (4 * H,), H ** -0.5, dev)
    z = torch.zeros((batch, H), device=dev)
    gout = _normal(gen, (seq, batch, H), 1.0, dev)

    outs = K.lstm_stack2_fwd(g1, w1, w2, b2, z, z, z, z)
    outs_p = K.lstm_stack2_fwd_plain(g1, w1, w2, b2, z, z, z, z)
    fwd_err = max_abs(zip(outs, outs_p))

    hs1, cs1, hs2, cs2 = outs_p
    shift = lambda a: torch.cat([z[None], a[:-1]]).contiguous()  # noqa: E731
    cat2 = torch.cat([hs1, shift(hs2)], dim=-1)
    acts1 = K.activate(g1 + shift(hs1) @ w1, H).contiguous()
    acts2 = K.activate(b2 + cat2 @ w2, H).contiguous()
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
            max_abs_err=fwd_err, rel_err=None,
            ms=cuda_ms(lambda: K.lstm_stack2_fwd(g1, w1, w2, b2, z, z, z, z),
                       20),
            plain_ms=cuda_ms(lambda: K.lstm_stack2_fwd_plain(
                g1, w1, w2, b2, z, z, z, z), 3),
            library_ms=cudnn_lstm_ms(60, 2, seq, batch, dev, False),
            bound=bound_ms(f32 * (seq * batch * 8 * H + 12 * H * H + 4 * H
                                  + 4 * batch * H),
                           seq * batch * (24 * H * H + 26 * H))),
        "lstm_stack2_bwd": dict(
            max_abs_err=bwd_err, rel_err=max(bwd_rel, grad_rel),
            ms=cuda_ms(lambda: K.lstm_stack2_bwd(*args), 20),
            plain_ms=cuda_ms(lambda: K.lstm_stack2_bwd_plain(*args), 3),
            library_ms=cudnn_lstm_ms(60, 2, seq, batch, dev, True),
            bound=bound_ms(f32 * (seq * batch * 19 * H + 12 * H * H),
                           seq * batch * (24 * H * H + 40 * H))),
    }
    print(f"  B3 lstm_stack2_fwd  T={seq} B={batch}: fwd max|err| "
          f"{fwd_err:.3e} (tol {FWD_ATOL})")
    print(f"  B4 lstm_stack2_bwd  T={seq} B={batch}: dgates max|err| "
          f"{bwd_err:.3e}, rel {bwd_rel:.3e}; input/weight grads rel "
          f"{grad_rel:.3e} (tol {GRAD_RTOL})")
    ok = fwd_err <= FWD_ATOL and bwd_rel <= GRAD_RTOL and grad_rel <= GRAD_RTOL
    return ok, out


def synth_target(n_frames, seed):
    """``(sig, sr)`` synthesised by the port from a seeded smooth cp
    trajectory of ``n_frames`` frames."""
    rng = np.random.default_rng(seed)
    cp = np.clip(rng.normal(0, 0.05, (n_frames, 30)).cumsum(0) * 0.2, -1, 1)
    return synth.speak(inv_normalize_cp(cp))


def drive_main_path():
    """``Paule.plan_resynth`` at full width on the card; checks the losses
    and that every kernel launched during the run.  -> (ok, launches)."""
    # ~1 s of audio: 402 frames of 2.5 ms -> 201 mel frames; the forward
    # model then runs at T=402
    target = synth_target(402, seed=0)
    t0 = time.perf_counter()
    paule = Paule(seed=7)
    print(f"Paule() on {paule.device}: {time.perf_counter() - t0:.1f} s")

    kw = dict(target_acoustic=target, initialize_from="acoustic",
              objective="acoustic_semvec", n_outer=2, n_inner=8, log_ii=4,
              continue_learning=False, verbose=False)
    # the first call pays the CUDA libraries' set-up; the second is the run
    # whose launches and phase times are reported
    for run in ("first", "second"):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        r = paule.plan_resynth(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timings = paule.last_planning_timings
        per_step = timings["planning"] / 16 * 1e3
        print(f"plan_resynth(acoustic_semvec, n_outer=2, n_inner=8, "
              f"log_ii=4), {run} call: {wall:.3f} s; planning "
              f"{timings['planning']:.3f} s ({per_step:.2f} ms per inner "
              f"step), synthesis {timings['synthesis']:.3f} s, metrics "
              f"{timings['metrics']:.3f} s")
    launches = {k.__name__: k.launches for k in K.KERNELS}
    paule.close()

    print(f"  planned_loss_steps {r.planned_loss_steps}")
    print(f"  prod_loss_steps {r.prod_loss_steps}")
    print(f"  prod_semvec_loss_steps {r.prod_semvec_loss_steps}")
    print(f"  launches during the run: {launches}")
    losses = (r.planned_loss_steps + r.prod_loss_steps
              + r.pred_semvec_loss_steps + r.prod_semvec_loss_steps)
    ok = True
    if len(r.planned_loss_steps) != 4 or not np.isfinite(losses).all():
        print("main path: missing or non-finite losses", file=sys.stderr)
        ok = False
    if not r.planned_loss_steps[-1] < r.planned_loss_steps[0]:
        print("main path: planned loss did not fall", file=sys.stderr)
        ok = False
    if r.planned_cp.shape != (402, 30) or not np.isfinite(
            r.planned_cp).all():
        print("main path: bad planned_cp", file=sys.stderr)
        ok = False
    if not all(launches.values()):
        print("main path: a kernel was not launched", file=sys.stderr)
        ok = False
    return ok, launches


def check_against_cpu():
    """The same short plan on the card (float32, kernels) and on the CPU
    (float64, plain versions): the planned and produced losses agree."""
    target = synth_target(42, seed=1)
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        paule = Paule(device=dev, dtype=dtype, seed=7)
        r = paule.plan_resynth(
            target_acoustic=target, objective="acoustic_semvec",
            n_outer=1, n_inner=3, log_ii=1, continue_learning=False,
            verbose=False)
        paule.close()
        out[dev] = np.array(r.planned_loss_steps + r.prod_loss_steps
                            + r.prod_semvec_loss_steps)
    err = float(np.max(np.abs(out["cuda"] - out["cpu"]) / np.abs(out["cpu"])))
    print(f"short plan, card f32 vs CPU f64: losses max rel err {err:.3e} "
          f"(tol {PLAN_RTOL})")
    return err <= PLAN_RTOL


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    K.build(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(0)
    print("kernels against their plain versions:")
    ok_c, core = check_core(dev, gen, 402, 1)
    ok_s1, stack = check_stack2(dev, gen, 201, 1)
    ok_s4, stack4 = check_stack2(dev, gen, 201, 4)
    # B=24: the produced-audio metrics at the default budget (24 logged
    # snapshots per outer iteration); several row passes per warp
    ok_s24, stack24 = check_stack2(dev, gen, 201, 24)
    ok = ok_c and ok_s1 and ok_s4 and ok_s24
    results = {**core, **stack}
    for name in ("lstm_stack2_fwd", "lstm_stack2_bwd"):
        for key in ("max_abs_err", "rel_err"):
            vals = [r[name][key] for r in (results, stack4, stack24)
                    if r[name][key] is not None]
            results[name][key] = max(vals) if vals else None
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}"
              f" ms, cuDNN {r['library_ms']:.3f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    for batch, res in ((4, stack4), (24, stack24)):
        for name, r in res.items():
            print(f"  {name} B={batch}: kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms, cuDNN {r['library_ms']:.3f} ms,"
                  f" bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")

    print("main path:")
    ok_main, launches = drive_main_path()
    ok = check_against_cpu() and ok and ok_main

    kernels = []
    for k in K.KERNELS:
        r = results[k.__name__]
        kernels.append({
            "name": k.__name__, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[k.__name__],
            "launches": launches[k.__name__],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
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
