"""LSTM layers and stacks in the JAX package's layout (counterpart of
``paule_tpu/ops/lstm.py``).

Weights: ``w_ih (in, 4H)``, ``w_hh (H, 4H)``, ``b (4H,)`` (the sum of torch's
``b_ih + b_hh``), gate order i, f, g, o.  The input projection
``x @ w_ih + b`` runs for all steps as one matrix product; only the
recurrence goes through :mod:`.lstm_kernels`: the CUDA kernels for float32
tensors on the card, their plain versions for tensors on the CPU.

A layer's weights may also come with the gate axis split over devices
(:class:`ShardedParams`, a mesh's ``tp`` axis): the input projection then
runs block by block on each block's device, and the recurrence on the
lead device, one kernel launch per call as for a whole layer.
"""

from typing import NamedTuple

import torch

from .lstm_kernels import (LSTMCore, LSTMStack2, core_bwd, first_order_only,
                           lstm_fwd)


def _copy(t, device):
    """``t`` on ``device``, its bytes added to :func:`gather`'s count."""
    gather.bytes += t.numel() * t.element_size()
    return t.to(device)


def gather(blocks, device):
    """``blocks`` joined along their last axis on ``device``; under
    autograd each block gets its columns of the gradient on its own
    device.  ``gather.bytes`` counts the bytes a split layer moves between
    its lead and its blocks' devices: ``x`` copied to each block, the gate
    blocks and ``w_hh`` (or a fused pair's weights) joined on the lead,
    and in :class:`ShardedLSTMCore`'s backward B2's ``dgates`` handed
    back, the previous hidden states copied to each block for its
    ``w_hh`` gradient and each block's part of ``x``'s gradient brought
    back.  Every block is counted, the lead's own too (on distinct cards
    ``1/tp`` of the count stays on the lead); left out are a trained
    fused pair's weight gradients."""
    return torch.cat([_copy(b, device) for b in blocks], dim=-1)


gather.bytes = 0


class ShardedParams(NamedTuple):
    """One layer's weights with the 4H gate axis in contiguous column
    blocks, block ``t`` (``w_ih[t] (in, 4H/tp)``, ``w_hh[t] (H, 4H/tp)``,
    ``b[t] (4H/tp,)``) on its own device, the first block's device the
    lead (:class:`paule_tpu_torch.models.blocks.TPLSTMLayer`)."""
    w_ih: tuple
    w_hh: tuple
    b: tuple

    @property
    def lead(self):
        return self.w_hh[0].device

    def gathered(self):
        """The whole weights on the lead device, as a params dict whose
        gradients flow back to the blocks (:func:`gather`)."""
        return {k: gather(getattr(self, k), self.lead) for k in self._fields}


def _rows(params, key):
    """The leading size of ``params[key]``, of a params dict or a
    :class:`ShardedParams` (split on the last axis only)."""
    if isinstance(params, ShardedParams):
        return getattr(params, key)[0].shape[0]
    return params[key].shape[0]


class ShardedLSTMCore(torch.autograd.Function):
    """``(x, h0, c0, n, *w_ih_blocks, *b_blocks, *w_hh_blocks) -> (hs,
    cs)``: one layer over ``x (B, T, in)`` whose gate axis comes in ``n``
    column blocks, each block's weights on its own device.  Forward: each
    block's input projection ``x @ w_ih_t + b_t`` on its device (``x``
    copied there); the gate blocks and ``w_hh`` joined on ``h0``'s device
    (the lead), where B1 runs, one launch per call.  Backward: B2 on the
    lead; each block gets its columns of ``dgates`` on its device and
    computes its weight gradients there (``w_hh_t``'s as ``hs_prev^T
    dgates_t``, the product the split spreads over the devices) and its
    part of ``x``'s gradient, which comes back to ``x``'s device and is
    summed in block order.  One autograd node for the whole layer, so
    ``x`` gets one gradient summed in a fixed order: run as separate
    nodes, the blocks' backward ops would run on their own devices'
    autograd threads, and ``x``'s gradient would sum its parts in the
    order they arrived, which on distinct cards changes from run to
    run."""

    @staticmethod
    def forward(ctx, x, h0, c0, n, *blocks):
        w_ih, b, w_hh = blocks[:n], blocks[n:2 * n], blocks[2 * n:]
        xs = [_copy(x, w.device) for w in w_ih]
        gates_x = gather([(xt @ w + bt).transpose(0, 1)
                          for xt, w, bt in zip(xs, w_ih, b)], h0.device)
        w_hh = gather(w_hh, h0.device)
        hs, cs = lstm_fwd(gates_x, w_hh, h0, c0)
        ctx.n, ctx.x_device = n, x.device
        ctx.save_for_backward(gates_x, w_hh, h0, c0, hs, cs, *xs, *w_ih)
        return hs, cs

    @staticmethod
    @first_order_only
    def backward(ctx, ghs, _gcs):
        n, need = ctx.n, ctx.needs_input_grad
        saved = ctx.saved_tensors
        xs, w_ih = saved[6:6 + n], saved[6 + n:]
        hs_prev, dgates, dh0, dc0 = core_bwd(*saved[:6], ghs)
        dx, dw_ih, db, dw_hh = None, [None] * n, [None] * n, [None] * n
        widths = [w.shape[-1] for w in w_ih]
        for t, (d, xt, w) in enumerate(zip(dgates.split(widths, dim=-1),
                                           xs, w_ih)):
            d = _copy(d, w.device)                           # (T, B, 4H/n)
            d2 = d.transpose(0, 1).reshape(-1, widths[t])    # (B*T, 4H/n)
            if need[4 + t]:
                dw_ih[t] = xt.reshape(-1, xt.shape[-1]).t() @ d2
            if need[4 + n + t]:
                db[t] = d.sum((0, 1))
            if need[4 + 2 * n + t]:
                dw_hh[t] = torch.einsum("tbh,tbg->hg",
                                        _copy(hs_prev, w.device), d)
            if need[0]:
                part = _copy((d2 @ w.t()).view(xt.shape), ctx.x_device)
                dx = part if dx is None else dx + part
        return (dx, dh0, dc0, None, *dw_ih, *db, *dw_hh)


def lstm_layer(params, x, h0=None, c0=None):
    """One layer over ``x (B, T, in)`` -> ``(out (B, T, H), (h_T, c_T))``;
    ``c_T`` carries no gradient.  ``params`` is a dict of whole weights or
    a :class:`ShardedParams`: then each block's input projection runs on
    its device, and the recurrence on the lead device
    (:class:`ShardedLSTMCore`), where ``out`` lies."""
    sharded = isinstance(params, ShardedParams)
    device = params.lead if sharded else x.device
    batch = x.shape[0]
    hidden = _rows(params, "w_hh")
    if h0 is None:
        h0 = x.new_zeros((batch, hidden), device=device)
    if c0 is None:
        c0 = x.new_zeros((batch, hidden), device=device)
    if sharded:
        hs, cs = ShardedLSTMCore.apply(x, h0, c0, len(params.w_hh),
                                       *params.w_ih, *params.b,
                                       *params.w_hh)
    else:
        gates_x = (x @ params["w_ih"] + params["b"]).transpose(
            0, 1).contiguous()   # (T, B, 4H)
        hs, cs = LSTMCore.apply(gates_x, params["w_hh"], h0, c0)
    return hs.transpose(0, 1), (hs[-1], cs[-1])


def lstm_stack2(params1, params2, x):
    """Two layers of equal hidden size, zero initial state, through the
    fused pair: ``-> (out (B, T, H), [(h1_T, c1_T), (h2_T, c2_T)])``.
    Only ``out`` carries gradients.  A :class:`ShardedParams` is gathered
    whole on its lead device first (:meth:`ShardedParams.gathered`), and
    the pair runs there as for whole weights; its weight gradients come
    back to the blocks through the gather (no caller trains a sharded
    pair: planning differentiates the trajectory only)."""
    params1, params2 = (p.gathered() if isinstance(p, ShardedParams) else p
                        for p in (params1, params2))
    batch = x.shape[0]
    hidden = params1["w_hh"].shape[0]
    zeros = x.new_zeros((batch, hidden))
    gates1 = (x @ params1["w_ih"] + params1["b"]).transpose(0, 1).contiguous()
    w2 = torch.cat([params2["w_ih"], params2["w_hh"]], dim=0)
    hs1, cs1, hs2, cs2 = LSTMStack2.apply(
        gates1, params1["w_hh"], w2, params2["b"], zeros, zeros, zeros, zeros)
    return hs2.transpose(0, 1), [(hs1[-1], cs1[-1]), (hs2[-1], cs2[-1])]


def _on(generator, x):
    """Whether ``generator`` draws on ``x``'s device (an unset index
    matches any)."""
    if generator is None or generator.device.type != x.device.type:
        return False
    a, b = generator.device.index, x.device.index
    return a is None or b is None or a == b


def draw_keep_masks(layers, batch, seq, dropout, generator, device=None):
    """The dropout keep masks of :func:`lstm` over ``layers`` for a batch
    of ``batch`` sequences of ``seq`` steps: one boolean ``(batch, seq,
    H)`` tensor per layer boundary, in order, drawn from ``generator`` on
    ``device`` (default: the generator's)."""
    device = generator.device if device is None else device
    return [torch.rand((batch, seq, _rows(layer, "w_hh")),
                       generator=generator, device=device) >= dropout
            for layer in layers[:-1]]


def lstm(layers, x, *, dropout=0.0, training=False, generator=None,
         keep_masks=None):
    """Stacked LSTM over a sequence of per-layer parameter dicts.

    Two adjacent layers of equal hidden size (the upper one's input being
    the lower one's hidden) run as the fused pair when no dropout is active,
    as ``paule_tpu/ops/lstm.py:116-140`` does.  ``dropout`` applies between
    layers only, like ``torch.nn.LSTM(dropout=...)``, as
    ``where(keep, out / (1 - p), 0)`` (``paule_tpu/ops/lstm.py:143-148``).
    When ``training``, the keep masks of the layer boundaries are drawn on
    ``x``'s device from ``generator`` (:func:`draw_keep_masks`), which
    must live there (no mask is drawn on the host and copied), or taken
    from ``keep_masks``, one boolean ``(B, T, H)`` tensor per boundary in
    order (a mask drawn elsewhere, e.g. JAX's, replayed)."""
    n = len(layers)
    dropout_active = dropout > 0.0 and training
    if dropout_active and keep_masks is None:
        if not _on(generator, x):
            raise ValueError("dropout in training needs a generator on the "
                             f"input's device ({x.device}) or keep_masks")
        keep_masks = draw_keep_masks(layers, x.shape[0], x.shape[1],
                                     dropout, generator, x.device)
    masks = iter(keep_masks or ())
    h_ns, c_ns = [], []
    out = x
    li = 0
    while li < n:
        hidden = _rows(layers[li], "w_hh")
        if (li + 1 < n and not dropout_active
                and _rows(layers[li + 1], "w_hh") == hidden
                and _rows(layers[li + 1], "w_ih") == hidden):
            out, states = lstm_stack2(layers[li], layers[li + 1], out)
            for h_n, c_n in states:
                h_ns.append(h_n)
                c_ns.append(c_n)
            li += 2
            continue
        out, (h_n, c_n) = lstm_layer(layers[li], out)
        if dropout_active and li < n - 1:
            out = torch.where(next(masks), out / (1.0 - dropout), 0.0)
        h_ns.append(h_n)
        c_ns.append(c_n)
        li += 1
    return out, (torch.stack(h_ns), torch.stack(c_ns))
