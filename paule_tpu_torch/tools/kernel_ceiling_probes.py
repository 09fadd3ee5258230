"""Ceiling probes of the LSTM recurrence on the card (the port's counterpart
of ``tools/kernel_ceiling_probes.py``).

Two kernels compute B1's function (the forward recurrence) and two compute
B2's (the reverse recurrence), each pair in the two layouts of the TPU
probes: ``wide``, one product over all 4H gate columns per step, and
``split``, four per-gate products kept with the block that owns the hidden
unit.  On the card the layouts differ in what crosses the grid between
steps (``pre_t`` or ``h_t`` forward, ``dh`` or ``dgates_t`` backward);
``csrc/ceiling_probes.cu`` says how each maps to the card.  Each probe is
one persistent cooperative launch per call, with its block's share of
W_hh resident in shared memory; the probes put microseconds per time step
beside B1's and B2's at the same shape, to show where a step's time goes.

Kernel <-> TPU kernel it replaces (``tools/kernel_ceiling_probes.py``):

* :func:`fwd_wide`   <- ``run_fwd`` (``:79``) with ``fwd_kernel_wide`` (``:12``)
* :func:`fwd_split`  <- ``run_fwd`` (``:79``) with ``fwd_kernel_split`` (``:44``)
* :func:`bwd_wide`   <- ``run_bwd`` (``:219``) with ``bwd_kernel_wide`` (``:111``)
* :func:`bwd_split`  <- ``run_bwd`` (``:219``) with ``bwd_kernel_split`` (``:162``)

Their plain versions are B1's and B2's, :func:`~paule_tpu_torch.ops.
lstm_kernels.lstm_fwd_plain` and :func:`~paule_tpu_torch.ops.lstm_kernels.
lstm_bwd_plain`.  A wrapper takes the plain version for CPU tensors only;
for a CUDA tensor it launches its kernel (float32, contiguous) or raises:
a width whose plan does not fit raises ``ValueError`` (:func:`probe_plan`),
a grid that cannot be co-resident ``RuntimeError`` (CUDA error 720).  Each
counts its launches in ``<wrapper>.launches``.  The kernels of one device
share a grid-barrier counter (:func:`_barrier_counter`), so calls on one
device run one after another on one stream.

Run on the card, or on the CPU (plain versions, no timings)::

    python -m paule_tpu_torch.tools.kernel_ceiling_probes [--seq 402 --batch 8]
    python -m paule_tpu_torch.tools.kernel_ceiling_probes --device cpu
"""

import argparse
import collections
import functools
import json
import sys

import torch

from ..ops import lstm_kernels as K
from ..ops.cuda_build import CudaLibrary, check_tensor
from . import timing

LIBRARY = CudaLibrary("ceiling_probes.cu", {
    "paule_probe_fwd_wide": (8, 8), "paule_probe_fwd_split": (7, 8),
    "paule_probe_bwd_wide": (9, 8), "paule_probe_bwd_split": (8, 8)})
build = LIBRARY.build

#: the TPU probe's shape (tools/kernel_ceiling_probes.py:268)
SEQ, BATCH, HIDDEN = 1024, 1, 720
#: a probe against its plain version in float32: forward outputs in
#: absolute terms; gradients as the relative Frobenius error (the sums of
#: ~1000 recurrent steps run in another order)
FWD_ATOL = 1e-4
GRAD_RTOL = 1e-3
VARIANTS = ("wide", "split")
KINDS = ("fwd_wide", "fwd_split", "bwd_wide", "bwd_split")

F32 = 4
#: batch rows a pass holds in registers; the kernels are built for these,
#: and the wide forms hold the whole batch in one pass
ROWS_PER_PASS = (1, 4, 8)
#: most hidden units (split forms and bwd_wide) a block owns
MAX_UNITS = 8
#: a wide-form block: 12 warps; fwd_wide gives each two gate columns,
#: bwd_wide each thread two hidden units
WIDE_WARPS = 12
WIDE_THREADS = 32 * WIDE_WARPS
MAX_COLS = 2 * WIDE_WARPS
UNITS_PER_THREAD = 2
#: dynamic shared bytes before the first float: the mbarriers
HEADER = 16

#: one cooperative launch: ``blocks`` blocks of ``units`` hidden units
#: (fwd_wide: gate columns), ``rows`` batch rows per pass, ``chunk`` rows
#: staged in shared memory at a time, ``smem`` dynamic shared bytes a block
ProbePlan = collections.namedtuple("ProbePlan",
                                   "blocks units rows chunk smem")

# B1's and B2's plain versions are the probes' plain versions
fwd_plain = K.lstm_fwd_plain
bwd_plain = K.lstm_bwd_plain


def probe_plan(kind, hidden, batch, n_sm, smem_limit):
    """The launch plan of probe ``kind`` (one of :data:`KINDS`) on a card
    of ``n_sm`` SMs and ``smem_limit`` opt-in shared bytes per block:
    as few columns or units per block as keep one block per SM, their
    share of W_hh resident in shared memory.

    * ``fwd_wide``: a block holds its gate columns of W_hh (``H`` floats
      each), the exchanged ``pre_t`` (``B x 4H``), the cell states and
      hidden states of all units (``B x H`` each, ``h`` padded to a pass).
    * ``bwd_wide``: its W_hh rows (``4H`` floats a unit), the step's
      ``acts`` (``B x 4H``), the exchanged ``dh`` and the carries of all
      units (``B x H`` each) and its warps' partial products; ``cs_prev``
      and ``ghs`` go to registers.
    * ``fwd_split`` / ``bwd_split``: its W_hh rows, its units' carries and
      a chunk of staged ``h`` (``H`` floats) or ``dgates`` (``4H``) rows.

    Raises ``ValueError`` where the width cannot fit: H not a multiple of 4
    (the bulk copies move 16-byte words), more columns or units per block
    than the kernel takes, a wide form above 8 rows (every block holds the
    whole batch in one pass), or shared memory over ``smem_limit``."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    where = f"{kind} at H={hidden}, B={batch}"
    if hidden < 1 or batch < 1 or hidden % 4:
        raise ValueError(f"{where}: H must be a positive multiple of 4")
    gates = 4 * hidden
    owned = gates if kind == "fwd_wide" else hidden
    per = K._ceil_div(owned, n_sm)
    most = MAX_COLS if kind == "fwd_wide" else MAX_UNITS
    if per > most:
        what = "columns" if kind == "fwd_wide" else "units"
        raise ValueError(f"{where}: {per} {what} per block on {n_sm} SMs, "
                         f"more than the kernel's {most}")
    blocks = K._ceil_div(owned, per)
    if kind.endswith("wide"):
        if batch > ROWS_PER_PASS[-1]:
            raise ValueError(f"{where}: the wide forms hold the whole batch "
                             f"in one pass of at most {ROWS_PER_PASS[-1]} "
                             f"rows")
        rows = next(r for r in ROWS_PER_PASS if r >= batch)
        if kind == "fwd_wide":
            floats = (per * hidden + batch * gates + batch * hidden
                      + rows * hidden)
        else:
            if hidden > UNITS_PER_THREAD * WIDE_THREADS:
                raise ValueError(f"{where}: more units than the block's "
                                 f"{WIDE_THREADS} threads take, "
                                 f"{UNITS_PER_THREAD} each")
            floats = (per * gates + batch * gates + 2 * batch * hidden
                      + WIDE_WARPS * MAX_UNITS * rows)
        smem = HEADER + F32 * floats
        if smem > smem_limit:
            raise ValueError(f"{where}: {smem} bytes of shared memory per "
                             f"block, more than {smem_limit}")
        return ProbePlan(blocks, per, rows, batch, smem)
    row_floats = hidden if kind == "fwd_split" else gates
    fixed = HEADER + F32 * per * (gates + batch)
    fit = (smem_limit - fixed) // (F32 * row_floats)
    if fit < 1:
        raise ValueError(f"{where}: {smem_limit - fixed} bytes of shared "
                         f"memory per block are left, no room for one "
                         f"staged row of {F32 * row_floats} bytes")
    chunk = min(batch, fit)
    rows = next(r for r in ROWS_PER_PASS
                if r >= min(chunk, ROWS_PER_PASS[-1]))
    if K._round_up(chunk, rows) > fit:
        rows = max(r for r in ROWS_PER_PASS if r <= fit)
        chunk = min(chunk, fit // rows * rows)
    return ProbePlan(blocks, per, rows, chunk,
                     fixed + F32 * K._round_up(chunk, rows) * row_floats)


@functools.lru_cache(maxsize=None)
def _barrier_counter(index):
    """The grid-barrier counter of CUDA device ``index``: made (zeroed) once
    per process; every launch leaves its low 31 bits at 0 again, so no
    call writes it from the host (``csrc/ceiling_probes.cu``)."""
    return torch.zeros(32, dtype=torch.int32, device=f"cuda:{index}")


def _fwd_dims(gates, w_hh, h0, c0):
    seq, batch, four_h = gates.shape
    hidden = four_h // 4
    dev = gates.device
    check_tensor("gates", gates, (seq, batch, 4 * hidden), dev)
    check_tensor("w_hh", w_hh, (hidden, 4 * hidden), dev)
    check_tensor("h0", h0, (batch, hidden), dev)
    check_tensor("c0", c0, (batch, hidden), dev)
    if seq < 1:
        raise ValueError("empty sequence")
    return seq, batch, hidden, dev


def _bwd_dims(acts, cs_prev, ghs, w_hh):
    seq, batch, four_h = acts.shape
    hidden = four_h // 4
    dev = acts.device
    check_tensor("acts", acts, (seq, batch, 4 * hidden), dev)
    check_tensor("cs_prev", cs_prev, (seq, batch, hidden), dev)
    check_tensor("ghs", ghs, (seq, batch, hidden), dev)
    check_tensor("w_hh", w_hh, (hidden, 4 * hidden), dev)
    if seq < 1:
        raise ValueError("empty sequence")
    return seq, batch, hidden, dev


def _check_aligned(name, t):
    """A tensor that a kernel copies in bulk starts on a 16-byte boundary."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _plan(kind, hidden, batch, dev):
    return probe_plan(kind, hidden, batch, *K.device_limits(dev.index))


def _empty(dev, *shape):
    return torch.empty(shape, device=dev, dtype=torch.float32)


def fwd_wide(gates, w_hh, h0, c0):
    """P1, wide form: ``gates (T, B, 4H)``, ``w_hh (H, 4H)``, ``h0, c0
    (B, H)`` -> ``hs, cs (T, B, H)``; plain version :func:`fwd_plain`."""
    if gates.device.type == "cpu":
        return fwd_plain(gates, w_hh, h0, c0)
    seq, batch, hidden, dev = _fwd_dims(gates, w_hh, h0, c0)
    plan = _plan("fwd_wide", hidden, batch, dev)
    pre = _empty(dev, 2, batch, 4 * hidden)
    hs, cs = _empty(dev, seq, batch, hidden), _empty(dev, seq, batch, hidden)
    LIBRARY.launch("paule_probe_fwd_wide", dev,
                   (gates, w_hh, h0, c0, pre, hs, cs,
                    _barrier_counter(dev.index)), (seq, batch, hidden, *plan))
    fwd_wide.launches += 1
    return hs, cs


def fwd_split(gates, w_hh, h0, c0):
    """P1, split form; contract of :func:`fwd_wide` (``h0`` copied in bulk:
    16-byte aligned)."""
    if gates.device.type == "cpu":
        return fwd_plain(gates, w_hh, h0, c0)
    seq, batch, hidden, dev = _fwd_dims(gates, w_hh, h0, c0)
    plan = _plan("fwd_split", hidden, batch, dev)
    _check_aligned("h0", h0)
    hs, cs = _empty(dev, seq, batch, hidden), _empty(dev, seq, batch, hidden)
    LIBRARY.launch("paule_probe_fwd_split", dev,
                   (gates, w_hh, h0, c0, hs, cs, _barrier_counter(dev.index)),
                   (seq, batch, hidden, *plan))
    fwd_split.launches += 1
    return hs, cs


def bwd_wide(acts, cs_prev, ghs, w_hh):
    """P2, wide form: ``acts (T, B, 4H)``, ``cs_prev, ghs (T, B, H)``,
    ``w_hh (H, 4H)`` -> ``dgates (T, B, 4H), dh0, dc0 (B, H)``; plain
    version :func:`bwd_plain` (``acts`` copied in bulk: 16-byte
    aligned)."""
    if acts.device.type == "cpu":
        return bwd_plain(acts, cs_prev, ghs, w_hh)
    seq, batch, hidden, dev = _bwd_dims(acts, cs_prev, ghs, w_hh)
    plan = _plan("bwd_wide", hidden, batch, dev)
    _check_aligned("acts", acts)
    dh_buf = _empty(dev, 2, batch, hidden)
    dgates = _empty(dev, seq, batch, 4 * hidden)
    dh0, dc0 = _empty(dev, batch, hidden), _empty(dev, batch, hidden)
    LIBRARY.launch("paule_probe_bwd_wide", dev,
                   (acts, cs_prev, ghs, w_hh, dh_buf, dgates, dh0, dc0,
                    _barrier_counter(dev.index)), (seq, batch, hidden, *plan))
    bwd_wide.launches += 1
    return dgates, dh0, dc0


def bwd_split(acts, cs_prev, ghs, w_hh):
    """P2, split form; contract of :func:`bwd_wide`."""
    if acts.device.type == "cpu":
        return bwd_plain(acts, cs_prev, ghs, w_hh)
    seq, batch, hidden, dev = _bwd_dims(acts, cs_prev, ghs, w_hh)
    plan = _plan("bwd_split", hidden, batch, dev)
    dgates = _empty(dev, seq, batch, 4 * hidden)
    dh0, dc0 = _empty(dev, batch, hidden), _empty(dev, batch, hidden)
    LIBRARY.launch("paule_probe_bwd_split", dev,
                   (acts, cs_prev, ghs, w_hh, dgates, dh0, dc0,
                    _barrier_counter(dev.index)), (seq, batch, hidden, *plan))
    bwd_split.launches += 1
    return dgates, dh0, dc0


KERNELS = (fwd_wide, fwd_split, bwd_wide, bwd_split)
for _k in KERNELS:
    _k.launches = 0
_FWD = {"wide": fwd_wide, "split": fwd_split}
_BWD = {"wide": bwd_wide, "split": bwd_split}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def run_fwd(variant, gates, w_hh, h0, c0):
    """The forward probe ``variant`` ("wide" or "split")."""
    if variant not in _FWD:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    return _FWD[variant](gates, w_hh, h0, c0)


def run_bwd(variant, acts, cs_prev, ghs, w_hh):
    """The backward probe ``variant`` ("wide" or "split")."""
    if variant not in _BWD:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    return _BWD[variant](acts, cs_prev, ghs, w_hh)


def make_inputs(seq, batch, hidden, seed, device):
    """The TPU probe's inputs (``:268-294``) from a seeded generator:
    ``w_hh`` and ``gates`` N(0, 0.02^2), ``acts`` sigmoid(N(0, 1)),
    ``cs_prev`` N(0, 0.1^2), ``ghs`` N(0, 1), zero initial state;
    float32."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * scale).to(device)

    zeros = torch.zeros((batch, hidden), device=device)
    return {"w_hh": normal((hidden, 4 * hidden), 0.02),
            "gates": normal((seq, batch, 4 * hidden), 0.02),
            "acts": torch.sigmoid(normal((seq, batch, 4 * hidden), 1.0)),
            "cs_prev": normal((seq, batch, hidden), 0.1),
            "ghs": normal((seq, batch, hidden), 1.0),
            "h0": zeros, "c0": zeros}


def _max_abs(outs, refs):
    return max(float((a - b).abs().max()) for a, b in zip(outs, refs))


def _rel(outs, refs):
    return max(float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
               for a, b in zip(outs, refs))


def check(inp):
    """Each probe against its plain version and against the other form.
    -> ``{name: {"max_abs_err", "rel_err", "vs_other"}}``."""
    fwd_args = (inp["gates"], inp["w_hh"], inp["h0"], inp["c0"])
    bwd_args = (inp["acts"], inp["cs_prev"], inp["ghs"], inp["w_hh"])
    fwd_ref = fwd_plain(*fwd_args)
    bwd_ref = bwd_plain(*bwd_args)
    fwd = {v: run_fwd(v, *fwd_args) for v in VARIANTS}
    bwd = {v: run_bwd(v, *bwd_args) for v in VARIANTS}
    out = {}
    for v, other in zip(VARIANTS, VARIANTS[::-1]):
        out[f"fwd_{v}"] = {"max_abs_err": _max_abs(fwd[v], fwd_ref),
                           "rel_err": _rel(fwd[v], fwd_ref),
                           "vs_other": _max_abs(fwd[v], fwd[other])}
        out[f"bwd_{v}"] = {"max_abs_err": _max_abs(bwd[v], bwd_ref),
                           "rel_err": _rel(bwd[v], bwd_ref),
                           "vs_other": _max_abs(bwd[v], bwd[other])}
    return out


def within_tolerance(errors):
    return all((e["max_abs_err"] <= FWD_ATOL) if name.startswith("fwd")
               else (e["rel_err"] <= GRAD_RTOL)
               for name, e in errors.items())


def _chained_fwd(fn, inp, k):
    """``k`` dependent calls: each starts from the previous final state."""
    def run():
        h, c = inp["h0"], inp["c0"]
        for _ in range(k):
            hs, cs = fn(inp["gates"], inp["w_hh"], h, c)
            h, c = hs[-1], cs[-1]
        return h
    return run


def _chained_bwd(fn, inp, k):
    """``k`` dependent calls: dh0 feeds the next call's cotangent."""
    def run():
        g = inp["ghs"]
        for _ in range(k):
            _dg, dh0, _dc0 = fn(inp["acts"], inp["cs_prev"], g, inp["w_hh"])
            g = g + 1e-6 * dh0
        return g
    return run


def time_kernels(inp, reps=3):
    """Per kernel (the four probes, B1 ``lstm_fwd`` and B2 ``lstm_bwd``):
    ms per call and µs per time step, ``(t(K=20) - t(K=5)) / 15 / T`` over
    chained dependent calls (the TPU probe's ``:297-332``), CUDA events;
    with the plain version's ms, cuDNN's ms and the bound."""
    seq, batch, four_h = inp["gates"].shape
    hidden = four_h // 4
    dev = inp["gates"].device
    fwd_args = (inp["gates"], inp["w_hh"], inp["h0"], inp["c0"])
    bwd_args = (inp["acts"], inp["cs_prev"], inp["ghs"], inp["w_hh"])
    kernels = {"fwd_wide": (fwd_wide, True), "fwd_split": (fwd_split, True),
               "bwd_wide": (bwd_wide, False),
               "bwd_split": (bwd_split, False),
               "lstm_fwd": (K.lstm_fwd, True), "lstm_bwd": (K.lstm_bwd, False)}
    plain = {True: timing.cuda_ms(lambda: fwd_plain(*fwd_args), 2),
             False: timing.cuda_ms(lambda: bwd_plain(*bwd_args), 2)}
    library = {is_fwd: timing.cudnn_lstm_ms(30, hidden, 1, seq, batch, dev,
                                            backward=not is_fwd)
               for is_fwd in (True, False)}
    bound = {True: timing.lstm_fwd_bound(seq, batch, hidden),
             False: timing.lstm_bwd_bound(seq, batch, hidden)}
    out = {}
    for name, (fn, is_fwd) in kernels.items():
        chained = _chained_fwd if is_fwd else _chained_bwd
        t5 = timing.cuda_ms(chained(fn, inp, 5), reps)
        t20 = timing.cuda_ms(chained(fn, inp, 20), reps)
        out[name] = {"ms": t20 / 20, "us_per_step": (t20 - t5) / 15 / seq
                     * 1e3, "plain_ms": plain[is_fwd],
                     "library_ms": library[is_fwd], "bound": bound[is_fwd]}
    return out


def run(seq=SEQ, hidden=HIDDEN, device="cuda", batch=BATCH):
    """The probes on the TPU probe's inputs (seed 0) at ``(seq, batch,
    hidden)``: each form against its plain version and the other form and,
    on the card, the times of the four probes and of B1/B2.  -> ``{"shape",
    "device", "errors", "times"}`` (``times`` empty on the CPU)."""
    device = torch.device(device)
    inp = make_inputs(seq, batch, hidden, 0, device)
    errors = check(inp)
    times = time_kernels(inp) if device.type == "cuda" else {}
    return {"shape": (seq, batch, hidden), "device": str(device),
            "errors": errors, "times": times}


def report(result):
    """Print what :func:`run` found, one line per kernel."""
    seq, batch, hidden = result["shape"]
    print(f"T={seq} B={batch} H={hidden}, float32 on {result['device']}")
    for name, e in result["errors"].items():
        print(f"  {name}: max|err| vs plain {e['max_abs_err']:.3e}, rel "
              f"{e['rel_err']:.3e}; vs the other form {e['vs_other']:.3e}")
    for name, t in result["times"].items():
        print(f"  {name}: {t['ms']:.3f} ms per call, "
              f"{t['us_per_step']:.3f} us per step; plain "
              f"{t['plain_ms']:.3f} ms, cuDNN {t['library_ms']:.3f} ms, "
              f"bound {t['bound'][0]:.4f} ms ({t['bound'][1]})")
    if not result["times"]:
        print("  times: not measured (they need the card)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="LSTM ceiling probes (wide and split forms of B1/B2)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("kernel_ceiling_probes: no CUDA device (pass --device cpu "
                  "for the plain versions)", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(timing.card_line())
    result = run(seq=args.seq, device=args.device, batch=args.batch)
    report(result)
    print(json.dumps({"errors": result["errors"], "times": result["times"]}))
    if not within_tolerance(result["errors"]):
        print(f"kernel_ceiling_probes: error above tolerance (forward "
              f"{FWD_ATOL} absolute, gradients {GRAD_RTOL} relative)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
