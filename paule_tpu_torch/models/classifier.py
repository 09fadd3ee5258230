"""Speech/non-speech classifier over mel sequences (counterpart of
``paule_tpu/models/classifier.py:19-38``): ``LinearClassifier``, a
per-frame linear logit and its length-masked mean over time."""

import torch
from torch import nn

from . import blocks as B


class LinearClassifier(nn.Module):
    """mel ``(B, T, input_dim)`` -> logit ``(B,)``."""

    def __init__(self, input_dim=60, output_dim=1):
        super().__init__()
        self.linear = B.Linear(input_dim, output_dim)

    def forward(self, x, src_lens=None):
        """``src_lens`` (B,) averages each row over its first
        ``src_lens[b]`` frames; ``None`` over all of them."""
        out = self.linear(x)[..., 0]
        if src_lens is None:
            return out.mean(dim=1)
        lens = torch.as_tensor(src_lens, device=out.device)
        frames = torch.arange(out.shape[1], device=out.device)
        mask = frames[None] < lens[:, None]
        return torch.where(mask, out, 0.0).sum(dim=1) / lens.to(out.dtype)
