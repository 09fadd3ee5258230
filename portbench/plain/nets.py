"""Plain PyTorch versions of PAULE's models, written from their published
description (quantling/paule ``paule/models.py``), with weights in the
release's layout: ``w_ih (in, 4H)``, ``w_hh (H, 4H)``, ``b (4H,)`` with
gates i, f, g, o; a linear map ``x @ w + b``; a time convolution ``w (k,
in / groups, out)`` with SAME padding ``((k-1)//2, k//2)``.

The recurrence is a loop over time steps with one matrix product each:
no kernel, no fused pair, no cache.  Each model is a function of a dict of
tensors (:func:`weights`) and its input ``(B, T, C)``.
"""

import numpy as np
import torch
import torch.nn.functional as F


def weights(arrays, dtype, device, keys=None):
    """Flat release arrays ``{"predictive.lstm[0].w_ih": array, ...}`` ->
    tensors of ``dtype`` on ``device`` (``keys``: a subset)."""
    keys = arrays.keys() if keys is None else keys
    return {k: torch.as_tensor(np.asarray(arrays[k]), dtype=dtype,
                               device=device) for k in keys}


def lstm_step(x_t, h, c, w_ih, w_hh, b):
    """One LSTM step: ``(B, in), (B, H), (B, H) -> (h, c)``."""
    hidden = w_hh.shape[0]
    gates = x_t @ w_ih + h @ w_hh + b
    i, f, g, o = gates.split(hidden, dim=1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm(x, w_ih, w_hh, b):
    """One layer over ``x (B, T, in)`` from a zero state -> ``(B, T, H)``.
    The input projection is one product for all steps; the loop carries
    the recurrence."""
    batch, steps, _ = x.shape
    hidden = w_hh.shape[0]
    gx = x @ w_ih + b
    h = x.new_zeros(batch, hidden)
    c = x.new_zeros(batch, hidden)
    hs = []
    for t in range(steps):
        gates = gx[:, t] + h @ w_hh
        s = torch.sigmoid(gates)
        g = torch.tanh(gates[:, 2 * hidden:3 * hidden])
        c = s[:, hidden:2 * hidden] * c + s[:, :hidden] * g
        h = s[:, 3 * hidden:] * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _layers(p, prefix):
    n = 0
    while f"{prefix}.lstm[{n}].w_hh" in p:
        n += 1
    return [tuple(p[f"{prefix}.lstm[{i}].{k}"] for k in ("w_ih", "w_hh", "b"))
            for i in range(n)]


def stacked(p, prefix, x, keep_masks=None, dropout=0.0):
    """The stacked LSTM of model ``prefix``; between layers, with
    ``keep_masks`` (one boolean ``(B, T, H)`` per boundary), inverted
    dropout ``where(keep, out / (1 - dropout), 0)``."""
    layers = _layers(p, prefix)
    out = x
    for i, layer in enumerate(layers):
        out = lstm(out, *layer)
        if keep_masks is not None and i < len(layers) - 1:
            out = torch.where(keep_masks[i], out / (1.0 - dropout), 0.0)
    return out


def linear(p, prefix, x):
    return x @ p[f"{prefix}.w"] + p[f"{prefix}.b"]


def half_sequence(x):
    """``(B, 2T, C) -> (B, T, C)``: the mean of each pair of steps."""
    b, t, c = x.shape
    return x[:, :t // 2 * 2].reshape(b, t // 2, 2, c).mean(dim=2)


def forward_model(p, prefix, x, half=True):
    """cp -> mel (or cp -> tube, tube -> mel): LSTM, linear, and the
    pairwise mean over time when ``half``."""
    out = linear(p, f"{prefix}.post_linear", stacked(p, prefix, x))
    return half_sequence(out) if half else out


def embedder(p, prefix, x, keep_masks=None, dropout=0.0):
    """mel (or tube) -> semantic vector ``(B, 300)``: stacked LSTM, the
    last step, a linear map."""
    out = stacked(p, prefix, x, keep_masks, dropout)
    return linear(p, f"{prefix}.linear_mapping", out[:, -1])


def conv1d(p, prefix, x, groups=1):
    w = p[f"{prefix}.w"]
    k = w.shape[0]
    xc = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
    return (F.conv1d(xc, w.permute(2, 1, 0), groups=groups).transpose(1, 2)
            + p[f"{prefix}.b"])


def mel_channel_conv(p, prefix, x, fsc=3):
    """Each output channel ``g * fsc + i`` is conv ``i`` of group ``g``;
    conv 0 sees the channels shifted up by one, conv ``fsc - 1`` shifted
    down by one, the others unshifted."""
    c = x.shape[2]
    shifted = [F.pad(x, (i + 1, 0))[:, :, :c] for i in range(fsc - 2)]
    shifted += [x, F.pad(x, (0, 1))[:, :, 1:]]
    outs = [conv1d(p, f"{prefix}.convs[{i}]", xi, groups=c // fsc)
            for i, xi in enumerate(shifted)]
    b, t, _ = x.shape
    return torch.stack(outs, dim=-1).reshape(b, t, c)


def add_vel_and_acc(x):
    """``(B, T, C) -> (B, T, 3C)``: x, its forward difference (last row
    zero) and the difference of that (first and last rows zero)."""
    zero = torch.zeros_like(x[:, :1])
    vel = x[:, 1:] - x[:, :-1]
    acc = vel[:, 1:] - vel[:, :-1]
    return torch.cat([x, torch.cat([vel, zero], 1),
                      torch.cat([zero, acc, zero], 1)], dim=2)


def double_sequence(x):
    """``(B, T, C) -> (B, 2T, C)``: each step, then the midpoint to the
    next (the last repeated)."""
    mid = torch.cat([(x[:, :-1] + x[:, 1:]) / 2.0, x[:, -1:]], dim=1)
    b, t, c = x.shape
    return torch.stack([x, mid], dim=2).reshape(b, 2 * t, c)


def inverse_model(p, x, prefix="inverse"):
    """mel ``(B, T, 60)`` -> cp ``(B, 2T, 30)``: residual mel-channel
    smoothing, velocity and acceleration channels, LSTM, linear, doubling
    in time, residual channelwise time convolutions, and a grouped
    convolution over interleaved (smoothed, LSTM) channels."""
    i = 0
    while f"{prefix}.mel_blocks[{i}].convs[0].w" in p:
        x = mel_channel_conv(p, f"{prefix}.mel_blocks[{i}]", x) + x
        i += 1
    out = double_sequence(linear(p, f"{prefix}.post_linear", stacked(
        p, prefix, add_vel_and_acc(x))))
    lstm_out = out
    c = out.shape[2]
    i = 0
    while f"{prefix}.resid_blocks[{i}].conv1.w" in p:
        blk = f"{prefix}.resid_blocks[{i}]"
        out = conv1d(p, f"{blk}.conv2",
                     conv1d(p, f"{blk}.conv1", out, groups=c),
                     groups=c) + out
        i += 1
    b, t, _ = out.shape
    mixed = torch.stack([out, lstm_out], dim=-1).reshape(b, t, 2 * c)
    return conv1d(p, f"{prefix}.resid_weighting", mixed, groups=c)
