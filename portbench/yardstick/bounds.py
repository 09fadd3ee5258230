"""Peaks of one H100 and the least time of each LSTM kernel's function.

Frozen copies:
- ``PEAK_BYTES``, ``PEAK_F32``, ``bound_s``, ``lstm_fwd_bound``,
  ``lstm_bwd_bound``: ``paule_tpu_torch/tools/timing.py:20-23`` and
  ``:45-69`` (there in ms; here in s).
- ``stack2_fwd_bound``, ``stack2_bwd_bound``: ``chip_smoke.py:358-369``.
- ``lstm_flops`` and the planning step's 3 x forward:
  ``paule_tpu_torch/tools/profile_device.py:61-77``.

The port computes in float32 with TF32 off, outside the tensor cores, so
its peak is the float32 FMA rate.
"""

#: NVIDIA H100 SXM data sheet (700 W): HBM bytes/s, float32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
F32 = 4


def bound_s(n_bytes, n_flops):
    """The least time: the larger of bytes over the memory rate and FLOPs
    over the float32 rate."""
    return max(n_bytes / PEAK_BYTES, n_flops / PEAK_F32)


def lstm_fwd_bound(seq, batch, hidden):
    """B1's function: read gates_x, W_hh, h0, c0; write hs, cs."""
    return bound_s(F32 * (seq * batch * 6 * hidden + 4 * hidden * hidden
                          + 2 * batch * hidden),
                   seq * batch * (8 * hidden * hidden + 13 * hidden))


def lstm_bwd_bound(seq, batch, hidden):
    """B2's function: read acts, cs_prev, ghs, W_hh; write dgates, dh0,
    dc0."""
    return bound_s(F32 * (seq * batch * 10 * hidden + 4 * hidden * hidden
                          + 2 * batch * hidden),
                   seq * batch * (8 * hidden * hidden + 20 * hidden))


def stack2_fwd_bound(seq, batch, hidden):
    """B3's function: two layers of equal width, the second's input the
    first's hidden state."""
    return bound_s(F32 * (seq * batch * 8 * hidden + 12 * hidden * hidden
                          + 4 * hidden + 4 * batch * hidden),
                   seq * batch * (24 * hidden * hidden + 26 * hidden))


def stack2_bwd_bound(seq, batch, hidden):
    """B4's function."""
    return bound_s(F32 * (seq * batch * 19 * hidden + 12 * hidden * hidden),
                   seq * batch * (24 * hidden * hidden + 40 * hidden))


def lstm_flops(steps, in_size, hidden, layers=1):
    """2 x MACs of an LSTM forward over ``steps`` (gates only)."""
    total = 0
    for li in range(layers):
        i = in_size if li == 0 else hidden
        total += steps * 2 * (i + hidden) * 4 * hidden
    return total
