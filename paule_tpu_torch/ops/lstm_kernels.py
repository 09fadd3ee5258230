"""The four LSTM recurrence kernels (``csrc/lstm.cu``), their plain PyTorch
versions, and the two ``autograd.Function``s that wrap them.

Kernel <-> TPU kernel it replaces (``paule_tpu/ops/pallas_lstm.py``):

* B1 :func:`lstm_fwd`         <- ``_lstm_core_fwd_impl`` (``:214``)
* B2 :func:`lstm_bwd`         <- ``_lstm_core_bwd`` (``:264``)
* B3 :func:`lstm_stack2_fwd`  <- ``_stack2_fwd_impl`` (``:554``)
* B4 :func:`lstm_stack2_bwd`  <- ``_stack2_bwd`` (``:601``)

Each wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches its kernel (float32, contiguous, one device) or
raises; nothing falls back.  Each wrapper counts its launches in a plain
integer attribute, ``<wrapper>.launches``, so a run can show that it went
through the kernel; B2's also counts those that took its tiled layout
(``lstm_bwd.tiled``; from B=8 on, :func:`bwd_plan`).  While a traced call
is open (:mod:`..tracing`), each wrapper also records the call as an LSTM
op: family (``single``: B1/B2, ``pair``: B3/B4), direction, T, B and H,
timed on the card by an event pair recorded right around the kernel's
launch, whatever kernel
implements it, and the model that launched it: a forward takes
``tracing.MODEL``, the autograd functions save it for their backward.
The kernel library is built with ``nvcc`` on first use into
``paule_tpu_torch/_build/`` and rebuilt when the source changes
(:mod:`.cuda_build`).

All four are persistent kernels: one cooperative launch per call, whose
blocks must all be co-resident on the card.  Their launch plans
(:func:`fwd_plan`, :func:`bwd_plan`, :func:`stack2_plan`,
:func:`stack2_bwd_plan`) are computed here from the card's SM count and
opt-in shared memory per block; a grid that cannot be co-resident raises
(CUDA error ``cudaErrorCooperativeLaunchTooLarge``, 720).

What bounds the kernels and what their design does about it is written at
the top of ``csrc/lstm.cu``.
"""

import collections
import functools

import torch
from torch.autograd.function import once_differentiable

from .. import tracing
from .cuda_build import CudaLibrary, check_tensor as _check

LIBRARY = CudaLibrary("lstm.cu", {
    "paule_lstm_fwd": (6, 9), "paule_lstm_bwd": (7, 9),
    "paule_lstm_bwd_tiled": (7, 9),
    "paule_lstm_stack2_fwd": (14, 9), "paule_lstm_stack2_bwd": (9, 9)})
build = LIBRARY.build
_launch = LIBRARY.launch

F32 = 4
#: batch rows a warp carries in registers per pass over its weights; the
#: persistent kernels are built for these
ROWS_PER_PASS = (1, 4, 8, 16, 24)
#: most hidden units (one warp each) a block of the persistent kernels owns
MAX_UNITS = 12
#: B3 and B4 stream each warp's weight rows through a ring of 2 to 8 tiles
#: in shared memory: 512 float32 a tile (B3: 128 columns of its 4 gate
#: rows; B4: 512 columns of its one row)
TILE_BYTES = F32 * 4 * 128
MIN_STAGES, MAX_STAGES = 2, 8
#: floats per batch row of a backward step's prefetched inputs: the acts of
#: the four gates, the previous cell state, the hidden cotangent
IN_FLOATS = 6
#: B2 takes the tiled layout from this batch on (where its plan fits);
#: below it, the owner layout, which measured faster at B=2 and B=4
TILED_MIN_BATCH = 8
#: the tiled B2: warps splitting a row group's reduction axis (128 columns
#: each per ring slot), columns of dgates per ring slot, units a pass sums,
#: rows a row group sums, most row groups a block
SLICES = 8
SLOT_COLS = SLICES * 128
TILED_UNITS = 6
TILED_ROWS = 8
ROW_GROUPS = 2

#: one cooperative launch: ``blocks`` blocks of ``units`` hidden units (B3,
#: B4: half the blocks per layer), ``rows`` batch rows per pass, ``chunk``
#: rows staged in shared memory at a time, ``stages`` tiles in each warp's
#: weight ring (B3, B4; 0 for B1 and B2's owner layout), ``smem`` dynamic
#: shared bytes a block
LaunchPlan = collections.namedtuple("LaunchPlan",
                                    "blocks units rows chunk stages smem")


class TiledPlan(LaunchPlan):
    """A plan of B2's tiled layout (:func:`bwd_tiled_plan`), launched by
    the library's ``paule_lstm_bwd_tiled``: ``rows`` a row group, ``chunk``
    rows a pass, ``stages`` slots of its ``dgates`` ring."""
    __slots__ = ()


def _ceil_div(a, b):
    return -(-a // b)


def _round_up(n, m):
    return _ceil_div(n, m) * m


def _pad4(n):
    return _round_up(n, 4)


def _chunk_and_rows(what, hidden, batch, free, row_bytes):
    """Rows staged at a time and rows per pass: the staging buffer holds
    the chunk rounded up to a whole pass (the kernels run every row of a
    pass), within ``free`` bytes."""
    fit = free // row_bytes
    if fit < 1:
        raise ValueError(f"{what} at H={hidden}, B={batch}: {free} bytes of "
                         f"shared memory per block are left, no room for one "
                         f"staged row of {row_bytes} bytes")
    chunk = min(batch, fit)
    rows = next(r for r in ROWS_PER_PASS
                if r >= min(chunk, ROWS_PER_PASS[-1]))
    if _round_up(chunk, rows) > fit:
        rows = max(r for r in ROWS_PER_PASS if r <= fit)
        chunk = min(chunk, fit // rows * rows)
    return chunk, rows


def _check_units(what, hidden, units):
    if units > MAX_UNITS:
        raise ValueError(f"{what} at H={hidden}: {units} units per block, "
                         f"more than the kernel's {MAX_UNITS}")


def _one_layer_plan(what, hidden, batch, n_sm, smem_limit, unit_floats,
                    in_floats, row_floats):
    """A one-layer kernel's plan: as few units per block as keep one block
    per SM.  A block holds in shared memory ``unit_floats`` per unit (its
    resident weights) and its units' carries (``units x B``), the next
    step's inputs of one pass (``units x in_floats x rows``) and a chunk of
    staged rows (``row_floats`` each); raises if not even one row fits."""
    units = _ceil_div(hidden, n_sm)
    _check_units(what, hidden, units)
    fixed = F32 * units * (unit_floats + batch)
    inputs = F32 * units * in_floats             # bytes per row of a pass
    chunk, rows = _chunk_and_rows(
        what, hidden, batch, smem_limit - fixed - inputs * ROWS_PER_PASS[-1],
        F32 * row_floats)
    return LaunchPlan(_ceil_div(hidden, units), units, rows, chunk, 0,
                      fixed + inputs * rows
                      + _round_up(chunk, rows) * F32 * row_floats)


def fwd_plan(hidden, batch, n_sm, smem_limit):
    """B1's launch plan on a card of ``n_sm`` SMs and ``smem_limit`` opt-in
    shared bytes per block.  A block holds its units' W_hh columns (``4 x
    Hp`` floats a unit, ``Hp`` = H rounded up to a multiple of 4), their
    cell states, the next step's input gates (4 floats a row) and staged
    ``h`` rows (``Hp`` floats each)."""
    hp = _pad4(hidden)
    return _one_layer_plan("B1", hidden, batch, n_sm, smem_limit, 4 * hp, 4,
                           hp)


def bwd_plan(hidden, batch, n_sm, smem_limit):
    """B2's launch plan at (H, B), whose type names its layout: the tiled
    layout's (a :class:`TiledPlan`, :func:`bwd_tiled_plan`) from
    :data:`TILED_MIN_BATCH` rows on where it fits, else the owner layout's
    (a :class:`LaunchPlan`, ``stages`` 0): a block holds its units'
    W_hh rows (``4H`` floats a unit), their cell-gradient carries, the next
    step's inputs (:data:`IN_FLOATS` a row) and staged ``dgates`` rows
    (``4H`` floats each)."""
    if batch >= TILED_MIN_BATCH:
        plan = bwd_tiled_plan(hidden, batch, n_sm, smem_limit)
        if plan is not None:
            return plan
    return _one_layer_plan("B2", hidden, batch, n_sm, smem_limit, 4 * hidden,
                           IN_FLOATS, 4 * hidden)


def bwd_tiled_plan(hidden, batch, n_sm, smem_limit):
    """The tiled B2's plan, or ``None`` where not even one ring slot fits:
    as few units per block as keep one block per SM; :data:`TILED_ROWS`
    rows per row group of :data:`SLICES` warps, up to :data:`ROW_GROUPS`
    groups (fewer where the ring would not fit), whose rows (``chunk``)
    make a pass; ``stages`` ring slots of ``dgates`` columns
    (:data:`SLOT_COLS` of each of the pass's rows), as many as fit up to
    one per slot of the step.  A block holds in shared memory its units'
    W_hh rows, the ring, the slices' sums (``SLICES x rows x TILED_UNITS``)
    and the first pass's next inputs (``TILED_UNITS x rows x
    IN_FLOATS``)."""
    units = _ceil_div(hidden, n_sm)
    _check_units("B2", hidden, units)
    g = 4 * hidden
    for groups in range(min(ROW_GROUPS, _ceil_div(batch, TILED_ROWS)), 0,
                        -1):
        alloc = TILED_ROWS * groups
        fixed = F32 * (units * g + (SLICES + IN_FLOATS) * TILED_UNITS * alloc)
        slot = F32 * alloc * SLOT_COLS
        stages = min(_ceil_div(g, SLOT_COLS), MAX_STAGES,
                     (smem_limit - fixed) // slot)
        if stages >= 1:
            return TiledPlan(_ceil_div(hidden, units), units, TILED_ROWS,
                             min(batch, alloc), stages,
                             fixed + stages * slot)
    return None


def _two_layer_plan(what, hidden, batch, n_sm, smem_limit, in_floats,
                    row_floats):
    """A two-layer wavefront's plan: both layers' blocks, the same units
    per block, one block per SM.  The weights stay in global memory (L2); a
    block holds in shared memory its units' carries, the next step's inputs
    of one pass (``in_floats`` a row), each warp's weight ring and a chunk
    of staged rows (``row_floats`` each): as many rows as fit beside the
    shortest ring, then as deep a ring as fits."""
    if n_sm < 2:
        raise ValueError(f"{what} needs at least 2 SMs, one per layer")
    units = _ceil_div(2 * hidden, n_sm)
    while 2 * _ceil_div(hidden, units) > n_sm:
        units += 1
    _check_units(what, hidden, units)
    ring = units * TILE_BYTES
    fixed = F32 * units * batch
    inputs = F32 * units * in_floats
    row_bytes = F32 * row_floats
    chunk, rows = _chunk_and_rows(
        what, hidden, batch,
        smem_limit - fixed - inputs * ROWS_PER_PASS[-1] - MIN_STAGES * ring,
        row_bytes)
    used = fixed + inputs * rows + _round_up(chunk, rows) * row_bytes
    stages = min(MAX_STAGES, (smem_limit - used) // ring)
    return LaunchPlan(2 * _ceil_div(hidden, units), units, rows, chunk,
                      stages, used + stages * ring)


def stack2_plan(hidden, batch, n_sm, smem_limit):
    """B3's launch plan: layer 1's next input gates are 4 floats a row,
    the staged rows ``[h1; h2]`` ``2 Hp`` floats."""
    return _two_layer_plan("B3", hidden, batch, n_sm, smem_limit, 4,
                           2 * _pad4(hidden))


def stack2_bwd_plan(hidden, batch, n_sm, smem_limit):
    """B4's launch plan: a step's inputs are :data:`IN_FLOATS` a row, the
    staged rows ``[dgates2_t; dgates1_{t+1}]`` ``8H`` floats."""
    return _two_layer_plan("B4", hidden, batch, n_sm, smem_limit, IN_FLOATS,
                           8 * hidden)


@functools.lru_cache(maxsize=None)
def device_limits(index):
    """``(SM count, opt-in shared bytes per block)`` of CUDA device
    ``index``, the inputs of the launch plans."""
    props = torch.cuda.get_device_properties(index)
    smem = getattr(props, "shared_memory_per_block_optin", None)
    if smem is None:
        raise RuntimeError("torch.cuda.get_device_properties gives no "
                           "shared_memory_per_block_optin")
    return props.multi_processor_count, smem


def _split(x, hidden):
    return (x[..., :hidden], x[..., hidden:2 * hidden],
            x[..., 2 * hidden:3 * hidden], x[..., 3 * hidden:])


def activate(pre, hidden):
    """(i, f, g, o) pre-activations -> sigmoid/tanh activations, (..., 4H)."""
    i, f, g, o = _split(pre, hidden)
    return torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o)], dim=-1)


def _gate_grads(acts, c_prev, dh, dc_in, hidden):
    """One reverse cell step: -> (dgates (B, 4H), dc carried to t-1)."""
    gi, gf, gg, go = _split(acts, hidden)
    tc = torch.tanh(gf * c_prev + gi * gg)
    d_o = dh * tc
    dc = dc_in + dh * go * (1.0 - tc * tc)
    dgates = torch.cat([dc * gg * gi * (1.0 - gi),
                        dc * c_prev * gf * (1.0 - gf),
                        dc * gi * (1.0 - gg * gg),
                        d_o * go * (1.0 - go)], dim=-1)
    return dgates, dc * gf


# ---------------------------------------------------------------------------
# B1: forward recurrence
# ---------------------------------------------------------------------------

def lstm_fwd_plain(gates_x, w_hh, h0, c0):
    """``gates_x (T, B, 4H)`` -> ``hs, cs (T, B, H)``, one step at a time."""
    hidden = w_hh.shape[0]
    h, c = h0, c0
    hs, cs = [], []
    for t in range(gates_x.shape[0]):
        gi, gf, gg, go = _split(activate(gates_x[t] + h @ w_hh, hidden),
                                hidden)
        c = gf * c + gi * gg
        h = go * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_fwd(gates_x, w_hh, h0, c0):
    """B1.  Same contract as :func:`lstm_fwd_plain`."""
    if gates_x.device.type == "cpu":
        if tracing.ON:
            tracing.op("single", "fwd", *gates_x.shape[:2], w_hh.shape[0],
                       model=tracing.MODEL)
        return lstm_fwd_plain(gates_x, w_hh, h0, c0)
    seq, batch, four_h = gates_x.shape
    hidden = four_h // 4
    dev = gates_x.device
    _check("gates_x", gates_x, (seq, batch, 4 * hidden), dev)
    _check("w_hh", w_hh, (hidden, 4 * hidden), dev)
    _check("h0", h0, (batch, hidden), dev)
    _check("c0", c0, (batch, hidden), dev)
    if seq < 1:
        raise ValueError("empty sequence")
    plan = fwd_plan(hidden, batch, *device_limits(dev.index))
    hs = torch.empty((seq, batch, hidden), device=dev, dtype=torch.float32)
    cs = torch.empty_like(hs)
    args = ("paule_lstm_fwd", dev, (gates_x, w_hh, h0, c0, hs, cs),
            (seq, batch, hidden, *plan))
    if tracing.ON:
        events = tracing.op_events(dev)
        _launch(*args, events=events)
        tracing.op("single", "fwd", seq, batch, hidden, events, dev,
                   tracing.MODEL)
    else:
        _launch(*args)
    lstm_fwd.launches += 1
    return hs, cs


lstm_fwd.launches = 0


# ---------------------------------------------------------------------------
# B2: reverse recurrence over precomputed activations
# ---------------------------------------------------------------------------

def lstm_bwd_plain(acts, cs_prev, ghs, w_hh):
    """Reverse recurrence carrying ``(dh, dc)``: activated gates
    ``acts (T, B, 4H)``, ``cs_prev, ghs (T, B, H)`` -> ``dgates (T, B, 4H),
    dh0, dc0 (B, H)``."""
    hidden = w_hh.shape[0]
    dh_rec = torch.zeros_like(ghs[0])
    dc = torch.zeros_like(ghs[0])
    dgates = torch.empty_like(acts)
    for t in range(acts.shape[0] - 1, -1, -1):
        dgates[t], dc = _gate_grads(acts[t], cs_prev[t], ghs[t] + dh_rec, dc,
                                    hidden)
        dh_rec = dgates[t] @ w_hh.t()
    return dgates, dh_rec, dc


def lstm_bwd(acts, cs_prev, ghs, w_hh, model=None):
    """B2.  Same contract as :func:`lstm_bwd_plain`; ``model``: the name of
    the model whose forward this is, for a traced call's op record."""
    if acts.device.type == "cpu":
        if tracing.ON:
            tracing.op("single", "bwd", *acts.shape[:2], w_hh.shape[0],
                       model=model)
        return lstm_bwd_plain(acts, cs_prev, ghs, w_hh)
    seq, batch, four_h = acts.shape
    hidden = four_h // 4
    dev = acts.device
    _check("acts", acts, (seq, batch, 4 * hidden), dev)
    _check("cs_prev", cs_prev, (seq, batch, hidden), dev)
    _check("ghs", ghs, (seq, batch, hidden), dev)
    _check("w_hh", w_hh, (hidden, 4 * hidden), dev)
    if seq < 1:
        raise ValueError("empty sequence")
    plan = bwd_plan(hidden, batch, *device_limits(dev.index))
    tiled = isinstance(plan, TiledPlan)
    dgates = torch.empty_like(acts)
    dh0 = torch.empty((batch, hidden), device=dev, dtype=torch.float32)
    dc0 = torch.empty_like(dh0)
    args = ("paule_lstm_bwd_tiled" if tiled else "paule_lstm_bwd", dev,
            (acts, cs_prev, ghs, w_hh, dgates, dh0, dc0),
            (seq, batch, hidden, *plan))
    if tracing.ON:
        events = tracing.op_events(dev)
        _launch(*args, events=events)
        tracing.op("single", "bwd", seq, batch, hidden, events, dev,
                   model)
        if tiled:
            tracing.count("lstm_bwd_tiled")
    else:
        _launch(*args)
    lstm_bwd.launches += 1
    lstm_bwd.tiled += tiled
    return dgates, dh0, dc0


lstm_bwd.launches = 0
#: launches that took the tiled layout
lstm_bwd.tiled = 0


# ---------------------------------------------------------------------------
# B3: two equal-H layers, forward
# ---------------------------------------------------------------------------

def lstm_stack2_fwd_plain(gates1, w_hh1, w2, b2, h01, c01, h02, c02):
    """``gates1 (T, B, 4H)``, ``w2 = [w_ih2; w_hh2] (2H, 4H)`` ->
    ``hs1, cs1, hs2, cs2 (T, B, H)``."""
    hidden = w_hh1.shape[0]
    h1, c1, h2, c2 = h01, c01, h02, c02
    out = ([], [], [], [])
    for t in range(gates1.shape[0]):
        gi, gf, gg, go = _split(activate(gates1[t] + h1 @ w_hh1, hidden),
                                hidden)
        c1 = gf * c1 + gi * gg
        h1 = go * torch.tanh(c1)
        qi, qf, qg, qo = _split(
            activate(b2 + torch.cat([h1, h2], dim=-1) @ w2, hidden), hidden)
        c2 = qf * c2 + qi * qg
        h2 = qo * torch.tanh(c2)
        for lst, v in zip(out, (h1, c1, h2, c2)):
            lst.append(v)
    return tuple(torch.stack(v) for v in out)


def lstm_stack2_fwd(gates1, w_hh1, w2, b2, h01, c01, h02, c02):
    """B3.  Same contract as :func:`lstm_stack2_fwd_plain`."""
    if gates1.device.type == "cpu":
        if tracing.ON:
            tracing.op("pair", "fwd", *gates1.shape[:2], w_hh1.shape[0],
                       model=tracing.MODEL)
        return lstm_stack2_fwd_plain(gates1, w_hh1, w2, b2, h01, c01, h02,
                                     c02)
    seq, batch, four_h = gates1.shape
    hidden = four_h // 4
    dev = gates1.device
    _check("gates1", gates1, (seq, batch, 4 * hidden), dev)
    _check("w_hh1", w_hh1, (hidden, 4 * hidden), dev)
    _check("w2", w2, (2 * hidden, 4 * hidden), dev)
    _check("b2", b2, (4 * hidden,), dev)
    for name, t in (("h01", h01), ("c01", c01), ("h02", h02), ("c02", c02)):
        _check(name, t, (batch, hidden), dev)
    if seq < 1:
        raise ValueError("empty sequence")
    plan = stack2_plan(hidden, batch, *device_limits(dev.index))
    # scratch for the kernel's transposed, zero-padded weight rows
    hp = _pad4(hidden)
    w1_t = torch.empty((4 * hidden, hp), device=dev, dtype=torch.float32)
    w2_t = torch.empty((4 * hidden, 2 * hp), device=dev, dtype=torch.float32)
    outs = [torch.empty((seq, batch, hidden), device=dev,
                        dtype=torch.float32) for _ in range(4)]
    args = ("paule_lstm_stack2_fwd", dev,
            (gates1, w_hh1, w2, b2, h01, c01, h02, c02, w1_t, w2_t, *outs),
            (seq, batch, hidden, *plan))
    if tracing.ON:
        events = tracing.op_events(dev)
        _launch(*args, events=events)
        tracing.op("pair", "fwd", seq, batch, hidden, events, dev,
                   tracing.MODEL)
    else:
        _launch(*args)
    lstm_stack2_fwd.launches += 1
    return tuple(outs)


lstm_stack2_fwd.launches = 0


# ---------------------------------------------------------------------------
# B4: two equal-H layers, reverse
# ---------------------------------------------------------------------------

def lstm_stack2_bwd_plain(acts1, acts2, cs1_prev, cs2_prev, ghs2, w_hh1, w2):
    """Fused reverse recurrence of both layers; only ``hs2`` carries an
    incoming cotangent.  -> ``dgates1, dgates2 (T, B, 4H)``."""
    hidden = w_hh1.shape[0]
    zero = torch.zeros_like(ghs2[0])
    dh1_rec, dh2_rec, dc1, dc2 = zero, zero, zero, zero
    dgates1 = torch.empty_like(acts1)
    dgates2 = torch.empty_like(acts2)
    for t in range(acts1.shape[0] - 1, -1, -1):
        dgates2[t], dc2 = _gate_grads(acts2[t], cs2_prev[t],
                                      ghs2[t] + dh2_rec, dc2, hidden)
        dcat = dgates2[t] @ w2.t()
        dh2_rec = dcat[:, hidden:]
        dgates1[t], dc1 = _gate_grads(acts1[t], cs1_prev[t],
                                      dcat[:, :hidden] + dh1_rec, dc1, hidden)
        dh1_rec = dgates1[t] @ w_hh1.t()
    return dgates1, dgates2


def lstm_stack2_bwd(acts1, acts2, cs1_prev, cs2_prev, ghs2, w_hh1, w2,
                    model=None):
    """B4.  Same contract as :func:`lstm_stack2_bwd_plain`; ``model`` as
    for :func:`lstm_bwd`."""
    if acts1.device.type == "cpu":
        if tracing.ON:
            tracing.op("pair", "bwd", *acts1.shape[:2], w_hh1.shape[0],
                       model=model)
        return lstm_stack2_bwd_plain(acts1, acts2, cs1_prev, cs2_prev, ghs2,
                                     w_hh1, w2)
    seq, batch, four_h = acts1.shape
    hidden = four_h // 4
    dev = acts1.device
    _check("acts1", acts1, (seq, batch, 4 * hidden), dev)
    _check("acts2", acts2, (seq, batch, 4 * hidden), dev)
    for name, t in (("cs1_prev", cs1_prev), ("cs2_prev", cs2_prev),
                    ("ghs2", ghs2)):
        _check(name, t, (seq, batch, hidden), dev)
    _check("w_hh1", w_hh1, (hidden, 4 * hidden), dev)
    _check("w2", w2, (2 * hidden, 4 * hidden), dev)
    if seq < 1:
        raise ValueError("empty sequence")
    plan = stack2_bwd_plan(hidden, batch, *device_limits(dev.index))
    dgates1 = torch.empty_like(acts1)
    dgates2 = torch.empty_like(acts2)
    args = ("paule_lstm_stack2_bwd", dev,
            (acts1, acts2, cs1_prev, cs2_prev, ghs2, w_hh1, w2, dgates1,
             dgates2), (seq, batch, hidden, *plan))
    if tracing.ON:
        events = tracing.op_events(dev)
        _launch(*args, events=events)
        tracing.op("pair", "bwd", seq, batch, hidden, events, dev, model)
    else:
        _launch(*args)
    lstm_stack2_bwd.launches += 1
    return dgates1, dgates2


lstm_stack2_bwd.launches = 0

KERNELS = (lstm_fwd, lstm_bwd, lstm_stack2_fwd, lstm_stack2_bwd)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
    lstm_bwd.tiled = 0


# ---------------------------------------------------------------------------
# autograd contracts (the JAX custom_vjp rules of pallas_lstm.py)
# ---------------------------------------------------------------------------

def first_order_only(backward):
    """``once_differentiable`` for the kernels' backward, which also raises
    as soon as it runs under ``create_graph=True``: B2 and B4 return no
    graph, and ``once_differentiable`` alone would drop the second-order
    terms silently when the incoming gradient carries no graph of its
    own."""
    inner = once_differentiable(backward)

    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "trying to differentiate twice through the LSTM kernels "
                "(create_graph=True): their backward (B2, B4) is "
                "differentiable once")
        return inner(ctx, *grads)
    return wrapper


def _shift(first, seq):
    """``[first, seq[:-1]]`` along time: the previous step's states."""
    return torch.cat([first[None], seq[:-1]], dim=0)


def core_bwd(gates_x, w_hh, h0, c0, hs, cs, ghs, model=None):
    """:class:`LSTMCore`'s backward through B2 from its saved tensors and
    the cotangent of ``hs``: -> ``(hs_prev, dgates, dh0, dc0)``, the
    previous step's hidden states for the weight gradient (``model`` as
    for :func:`lstm_bwd`)."""
    hidden = w_hh.shape[0]
    hs_prev = _shift(h0, hs)
    acts = activate(gates_x + hs_prev @ w_hh, hidden)
    dgates, dh0, dc0 = lstm_bwd(acts, _shift(c0, cs), ghs.contiguous(), w_hh,
                                model)
    return hs_prev, dgates, dh0, dc0


class LSTMCore(torch.autograd.Function):
    """``(gates_x, w_hh, h0, c0) -> (hs, cs)``.  Gradients through ``hs``
    are exact; the cotangent of ``cs`` is ignored (``lstm_core``,
    ``pallas_lstm.py:203-210``).  The backward runs B2, whose outputs carry
    no graph, so it is differentiable once: a second-order gradient (a
    WGAN-GP penalty through an LSTM critic) raises, on the card and on the
    CPU alike, where the JAX scan path would take it."""

    @staticmethod
    def forward(ctx, gates_x, w_hh, h0, c0):
        hs, cs = lstm_fwd(gates_x, w_hh, h0, c0)
        ctx.save_for_backward(gates_x, w_hh, h0, c0, hs, cs)
        ctx.model = tracing.MODEL if tracing.ON else None
        return hs, cs

    @staticmethod
    @first_order_only
    def backward(ctx, ghs, _gcs):
        hs_prev, dgates, dh0, dc0 = core_bwd(*ctx.saved_tensors, ghs,
                                             model=ctx.model)
        dw_hh = (torch.einsum("tbh,tbg->hg", hs_prev, dgates)
                 if ctx.needs_input_grad[1] else None)
        return dgates, dw_hh, dh0, dc0


class LSTMStack2(torch.autograd.Function):
    """``(gates1, w_hh1, w2, b2, h01, c01, h02, c02) -> (hs1, cs1, hs2,
    cs2)``.  Gradients flow only through ``hs2``; the initial-carry grads
    are zeros (``lstm_stack2_core``, ``pallas_lstm.py:540-551, 672-674``).
    Differentiable once, as :class:`LSTMCore`."""

    @staticmethod
    def forward(ctx, gates1, w_hh1, w2, b2, h01, c01, h02, c02):
        hs1, cs1, hs2, cs2 = lstm_stack2_fwd(gates1, w_hh1, w2, b2, h01, c01,
                                             h02, c02)
        ctx.save_for_backward(gates1, w_hh1, w2, b2, hs1, cs1, hs2, cs2,
                              h01, c01, h02, c02)
        ctx.model = tracing.MODEL if tracing.ON else None
        return hs1, cs1, hs2, cs2

    @staticmethod
    @first_order_only
    def backward(ctx, _ghs1, _gcs1, ghs2, _gcs2):
        (gates1, w_hh1, w2, b2, hs1, cs1, hs2, cs2,
         h01, c01, h02, c02) = ctx.saved_tensors
        hidden = w_hh1.shape[0]
        hs1_prev = _shift(h01, hs1)
        cat2 = torch.cat([hs1, _shift(h02, hs2)], dim=-1)
        acts1 = activate(gates1 + hs1_prev @ w_hh1, hidden)
        acts2 = activate(b2 + cat2 @ w2, hidden)
        dgates1, dgates2 = lstm_stack2_bwd(
            acts1, acts2, _shift(c01, cs1), _shift(c02, cs2),
            ghs2.contiguous(), w_hh1, w2, ctx.model)
        need = ctx.needs_input_grad
        dw_hh1 = (torch.einsum("tbh,tbg->hg", hs1_prev, dgates1)
                  if need[1] else None)
        dw2 = torch.einsum("tbh,tbg->hg", cat2, dgates2) if need[2] else None
        db2 = dgates2.sum(dim=(0, 1)) if need[3] else None
        zc = torch.zeros_like(h01)
        return dgates1, dw_hh1, dw2, db2, zc, zc, zc, zc
