"""Batching of variable-length sequences (counterpart of
``paule_tpu/ops/padding.py:31-56``): a sequence is padded by repeating its
last frame, not with zeros, so that the unmasked training losses are only
mildly perturbed by the padding."""

import torch


def pad_batch(lens, sequences):
    """Stack ``(T_i, C)`` tensors into one ``(B, max(lens), C)`` tensor,
    each padded with copies of its last row."""
    max_len = max(int(n) for n in lens)
    out = []
    for x in sequences:
        if x.shape[0] > max_len:
            raise ValueError(f"max_len {max_len} < sequence length "
                             f"{x.shape[0]}")
        pad = x[-1:].expand(max_len - x.shape[0], *x.shape[1:])
        out.append(torch.cat([x, pad], dim=0))
    return torch.stack(out)
