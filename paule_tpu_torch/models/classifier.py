"""Speech/non-speech classifiers over mel sequences (counterpart of
``paule_tpu/models/classifier.py``): ``LinearClassifier``, a per-frame
linear logit and its length-masked mean over time, and
``SpeechNonSpeechTransformer``, a positional encoding, post-norm
transformer encoder layers, a mean over time and a small head.

Attention is plain ``matmul`` and ``softmax``, as the JAX package computes
it, not ``scaled_dot_product_attention``, whose masking and summation
order differ.  GELU is the tanh approximation, ``jax.nn.gelu``'s default
(the reference torch model's exact erf GELU is not what the port is held
against).
"""

import math

import torch
import torch.nn.functional as F
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


def positional_encoding(d_model, max_len=5000, dtype=torch.float32):
    """The sinusoidal table ``(max_len, d_model)``: sines in the even
    columns, cosines in the odd ones."""
    position = torch.arange(max_len, dtype=dtype)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=dtype)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model), dtype=dtype)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class MultiHeadAttention(nn.Module):
    """Self-attention with projections ``q``, ``k``, ``v``, ``o``."""

    def __init__(self, d_model, nhead):
        super().__init__()
        self.nhead = nhead
        self.q, self.k, self.v, self.o = (B.Linear(d_model, d_model)
                                          for _ in range(4))

    def forward(self, x, key_padding_mask=None):
        b, t, d = x.shape
        hd = d // self.nhead

        def heads(proj):
            return proj(x).reshape(b, t, self.nhead, hd).transpose(1, 2)

        scores = heads(self.q) @ heads(self.k).transpose(-1, -2) / math.sqrt(
            hd)
        if key_padding_mask is not None:
            scores = scores + key_padding_mask[:, None, None, :]
        attn = torch.softmax(scores, dim=-1)
        out = (attn @ heads(self.v)).transpose(1, 2).reshape(b, t, d)
        return self.o(out)


class TransformerEncoderLayer(nn.Module):
    """Attention and a GELU feed-forward block, each followed by a residual
    connection and layer norm (``paule_tpu/models/classifier.py:75-95``)."""

    def __init__(self, d_model, nhead, dim_feedforward):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = B.Linear(d_model, dim_feedforward)
        self.linear2 = B.Linear(dim_feedforward, d_model)
        self.norm1 = B.LayerNorm(d_model)
        self.norm2 = B.LayerNorm(d_model)

    def forward(self, x, key_padding_mask=None):
        out = self.norm1(x + self.attn(x, key_padding_mask))
        return self.norm2(out + self.linear2(_gelu(self.linear1(out))))


class Head(nn.Module):

    def __init__(self, input_dim, output_dim):
        super().__init__()
        self.linear1 = B.Linear(input_dim, 20)
        self.linear2 = B.Linear(20, output_dim)

    def forward(self, x):
        return self.linear2(_gelu(self.linear1(x)))


class SpeechNonSpeechTransformer(nn.Module):
    """mel ``(B, T, input_dim)`` -> logit ``(B,)``
    (``paule_tpu/models/classifier.py:98-142``).  The positional table is
    the persistent buffer ``pe``, as the JAX tree carries it."""

    def __init__(self, input_dim=60, num_layers=3, nhead=6, output_dim=1,
                 dim_feedforward=1024, max_len=5000):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(input_dim, nhead, dim_feedforward)
            for _ in range(num_layers))
        self.head = Head(input_dim, output_dim)
        self.register_buffer("pe", positional_encoding(input_dim, max_len))

    def forward(self, x, src_lens=None):
        """``src_lens`` (B,) masks each row's keys beyond its length; the
        mean over time takes every frame, as in the JAX package."""
        t = x.shape[1]
        mask = None
        if src_lens is not None:
            lens = torch.as_tensor(src_lens, device=x.device)
            frames = torch.arange(t, device=x.device)
            mask = torch.where(frames[None] < lens[:, None], 0.0,
                               -math.inf).to(x.dtype)
        out = x + self.pe[None, :t, :]
        for layer in self.layers:
            out = layer(out, mask)
        return self.head(out.mean(dim=1))[..., 0]
