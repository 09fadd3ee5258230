"""LSTM layers and stacks in the JAX package's layout (counterpart of
``paule_tpu/ops/lstm.py``).

Weights: ``w_ih (in, 4H)``, ``w_hh (H, 4H)``, ``b (4H,)`` (the sum of torch's
``b_ih + b_hh``), gate order i, f, g, o.  The input projection
``x @ w_ih + b`` runs for all steps as one matrix product; only the
recurrence goes through :mod:`.lstm_kernels`: the CUDA kernels for float32
tensors on the card, their plain versions for tensors on the CPU.
"""

import torch

from .lstm_kernels import LSTMCore, LSTMStack2


def lstm_layer(params, x, h0=None, c0=None):
    """One layer over ``x (B, T, in)`` -> ``(out (B, T, H), (h_T, c_T))``;
    ``c_T`` carries no gradient."""
    w_ih, w_hh, b = params["w_ih"], params["w_hh"], params["b"]
    batch = x.shape[0]
    hidden = w_hh.shape[0]
    if h0 is None:
        h0 = x.new_zeros((batch, hidden))
    if c0 is None:
        c0 = x.new_zeros((batch, hidden))
    gates_x = (x @ w_ih + b).transpose(0, 1).contiguous()   # (T, B, 4H)
    hs, cs = LSTMCore.apply(gates_x, w_hh, h0, c0)
    return hs.transpose(0, 1), (hs[-1], cs[-1])


def lstm_stack2(params1, params2, x):
    """Two layers of equal hidden size, zero initial state, through the
    fused pair: ``-> (out (B, T, H), [(h1_T, c1_T), (h2_T, c2_T)])``.
    Only ``out`` carries gradients."""
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
    return [torch.rand((batch, seq, layer["w_hh"].shape[0]),
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
        hidden = layers[li]["w_hh"].shape[0]
        if (li + 1 < n and not dropout_active
                and layers[li + 1]["w_hh"].shape[0] == hidden
                and layers[li + 1]["w_ih"].shape[0] == hidden):
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
