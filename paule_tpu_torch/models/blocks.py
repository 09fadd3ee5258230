"""Building blocks on ``(batch, time, channels)`` tensors, with parameters
in the JAX package's layout (counterpart of ``paule_tpu/models/blocks.py``).

The functions take tensors; the ``nn.Module``s hold parameters whose
state-dict names follow the JAX parameter trees, so
:func:`paule_tpu_torch.release.params_from_jax` fills them directly.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.lstm import ShardedParams


def linear(w, b, x):
    return x @ w + b


def conv1d(w, b, x, *, groups=1):
    """Convolution over time on ``x (B, T, C)`` with SAME padding
    ``((k-1)//2, k//2)``; kernel ``w (k, in/groups, out)``."""
    k = w.shape[0]
    xc = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
    out = F.conv1d(xc, w.permute(2, 1, 0), groups=groups)
    return out.transpose(1, 2) + b


def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def interleave_channels(a, b):
    """``(B, T, C), (B, T, C) -> (B, T, 2C)`` in channel order
    ``[a0, b0, a1, b1, ...]``."""
    bsz, t, c = a.shape
    return torch.stack([a, b], dim=-1).reshape(bsz, t, 2 * c)


def batchnorm(x, scale, bias, mean, var, eps=1e-5):
    """Inference-mode batch norm over ``x (B, T, C)`` with the running
    statistics ``mean`` and ``var`` per channel."""
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def upsample_linear(x, size):
    """``torch.nn.Upsample(mode="linear", align_corners=False)`` over time
    on ``x (B, T, C)``, as the JAX package computes it."""
    t = x.shape[1]
    if t == size:
        return x
    pos = (torch.arange(size, dtype=torch.float64) + 0.5) * (t / size) - 0.5
    pos = pos.clamp(0.0, t - 1.0)
    lo = pos.floor().long()
    hi = torch.clamp(lo + 1, max=t - 1)
    frac = (pos - lo).to(x.dtype).to(x.device)[None, :, None]
    lo, hi = lo.to(x.device), hi.to(x.device)
    return x[:, lo, :] * (1.0 - frac) + x[:, hi, :] * frac


def gather_last_step(output, lens):
    """Per-sample hidden state at index ``lens - 1`` (clamped into range):
    ``(B, T, H), (B,) -> (B, H)``; ``lens=None`` means the last step."""
    if lens is None:
        return output[:, -1, :]
    lens = torch.as_tensor(lens, device=output.device)
    idx = torch.clamp(lens - 1, 0, output.shape[1] - 1).long()
    return output[torch.arange(output.shape[0], device=output.device), idx]


def _fill_uniform(param, bound, generator):
    """Fill ``param`` in place from U(-bound, bound), drawn in float64 on
    the CPU from ``generator`` so that a seed gives the same values on any
    device."""
    u = torch.rand(param.shape, generator=generator, dtype=torch.float64)
    with torch.no_grad():
        param.copy_((2.0 * u - 1.0) * bound)


def init_random(module, generator):
    """Seeded random initialisation of the linear, convolution and LSTM
    blocks of ``module``, with the bounds of the JAX package's initialisers
    (``paule_tpu/models/blocks.py:25-50``, ``paule_tpu/ops/lstm.py:56-67``);
    the norms get the identity the JAX package gives them.  The values are
    the port's own: they cannot equal JAX's."""
    for m in module.modules():
        if hasattr(m, "init_random"):
            m.init_random(generator)
    return module


class Linear(nn.Module):
    """``w (in, out)``, ``b (out,)``."""

    def __init__(self, in_features, out_features):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_features, out_features))
        self.b = nn.Parameter(torch.empty(out_features))

    def forward(self, x):
        return linear(self.w, self.b, x)

    def init_random(self, generator):
        fan_in = self.w.shape[0]
        _fill_uniform(self.w, math.sqrt(3.0 / fan_in), generator)
        _fill_uniform(self.b, 1.0 / math.sqrt(fan_in), generator)


class Conv1d(nn.Module):
    """``w (k, in/groups, out)``, ``b (out,)``."""

    def __init__(self, in_channels, out_channels, kernel_size, groups=1):
        super().__init__()
        self.groups = groups
        self.w = nn.Parameter(
            torch.empty(kernel_size, in_channels // groups, out_channels))
        self.b = nn.Parameter(torch.empty(out_channels))

    def forward(self, x):
        return conv1d(self.w, self.b, x, groups=self.groups)

    def init_random(self, generator):
        fan_in = self.w.shape[0] * self.w.shape[1]
        _fill_uniform(self.w, math.sqrt(3.0 / fan_in), generator)
        _fill_uniform(self.b, 1.0 / math.sqrt(fan_in), generator)


class BatchNorm(nn.Module):
    """Batch norm over ``(B, T, C)``: parameters ``scale`` and ``bias``,
    buffers ``mean`` and ``var`` (the running statistics), each
    ``(channels,)``, named as the JAX tree names them.

    In ``eval()`` mode it normalises with the running statistics.  In
    ``train()`` mode it normalises with the batch's, the biased variance
    over batch and time, and updates the buffers in place with momentum
    0.1 and the unbiased variance: torch ``BatchNorm1d``'s rule, which the
    JAX package reproduces functionally (``paule_tpu/models/blocks.py``
    ``batchnorm_new_stats``) and adopts after every train-mode forward
    (``paule_tpu/pretrain.py`` ``_adopt_bn_stats``)."""

    MOMENTUM = 0.1

    def __init__(self, channels):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        if not self.training:
            return batchnorm(x, self.scale, self.bias, self.mean, self.var)
        mean = x.mean(dim=(0, 1))
        var = x.var(dim=(0, 1), correction=0)
        n = x.shape[0] * x.shape[1]
        m = self.MOMENTUM
        with torch.no_grad():
            self.mean.copy_((1.0 - m) * self.mean + m * mean)
            self.var.copy_((1.0 - m) * self.var
                           + m * (var * (n / max(n - 1, 1))))
        return batchnorm(x, self.scale, self.bias, mean, var)

    def init_random(self, generator):
        """The identity the JAX package initialises it with."""
        del generator
        with torch.no_grad():
            for t, v in ((self.scale, 1.0), (self.bias, 0.0),
                         (self.mean, 0.0), (self.var, 1.0)):
                t.fill_(v)


class _Norm(nn.Module):
    """``scale`` and ``bias`` per feature, normalising over ``dim``."""

    dim = None

    def __init__(self, features):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(dim=self.dim, keepdim=True)
        var = x.var(dim=self.dim, keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.scale + self.bias

    def init_random(self, generator):
        """The identity the JAX package initialises it with."""
        del generator
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.fill_(0.0)


class InstanceNorm(_Norm):
    """Instance norm over ``(B, T, C)``: per sample and channel over time,
    biased variance (``paule_tpu/models/blocks.py`` ``instancenorm``)."""

    dim = 1


class LayerNorm(_Norm):
    """Layer norm over the last axis (``paule_tpu/models/blocks.py``
    ``layernorm``)."""

    dim = -1


class LSTMLayer(nn.Module):
    """``w_ih (in, 4H)``, ``w_hh (H, 4H)``, ``b (4H,)``, gates i, f, g, o."""

    def __init__(self, input_size, hidden_size):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(input_size, 4 * hidden_size))
        self.w_hh = nn.Parameter(torch.empty(hidden_size, 4 * hidden_size))
        self.b = nn.Parameter(torch.empty(4 * hidden_size))

    def params(self):
        return {"w_ih": self.w_ih, "w_hh": self.w_hh, "b": self.b}

    def init_random(self, generator):
        bound = 1.0 / math.sqrt(self.w_hh.shape[0])
        _fill_uniform(self.w_ih, bound, generator)
        _fill_uniform(self.w_hh, bound, generator)
        _fill_uniform(self.b, 2.0 * bound, generator)


class TPLSTMLayer(nn.Module):
    """An :class:`LSTMLayer` with its 4H gate axis split over devices (a
    mesh's ``tp`` axis): one ``w_ih``, ``w_hh``, ``b`` block per device,
    the blocks contiguous columns in order, as
    :func:`paule_tpu_torch.parallel.mesh.shard_lstm_params` lays them out.
    ``blocks``: one ``{"w_ih", "w_hh", "b"}`` dict of tensors per device,
    taken as the parameters.  :meth:`params` hands
    :func:`paule_tpu_torch.ops.lstm.lstm` the blocks, which it runs with
    the recurrence on the first block's device."""

    def __init__(self, blocks, requires_grad=True):
        super().__init__()
        for key in ("w_ih", "w_hh", "b"):
            setattr(self, key, nn.ParameterList(
                nn.Parameter(block[key], requires_grad=requires_grad)
                for block in blocks))

    def params(self):
        return ShardedParams(tuple(self.w_ih), tuple(self.w_hh),
                             tuple(self.b))

    def columns(self):
        """Each block's columns of the whole layer's gate axis, a
        ``slice`` of the last axis of ``w_ih``, ``w_hh`` and ``b``."""
        bounds = [0]
        for b in self.b:
            bounds.append(bounds[-1] + b.shape[0])
        return [slice(a, z) for a, z in zip(bounds, bounds[1:])]


def lstm_stack(input_size, hidden_size, num_layers):
    return nn.ModuleList(
        LSTMLayer(input_size if i == 0 else hidden_size, hidden_size)
        for i in range(num_layers))


class TimeConvResBlock(nn.Module):
    """Two channelwise time convolutions with a residual connection."""

    def __init__(self, channels, filter_size):
        super().__init__()
        self.conv1 = Conv1d(channels, channels, filter_size, groups=channels)
        self.conv2 = Conv1d(channels, channels, filter_size, groups=channels)

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


class MelChannelConv(nn.Module):
    """Convolution across neighbouring mel channels: ``fsc`` grouped time
    convolutions on channel-shifted copies of the input, interleaved so that
    output channel ``j*fsc + i`` comes from conv ``i``, group ``j``."""

    def __init__(self, input_units, filter_size_channel):
        super().__init__()
        if input_units % filter_size_channel != 0:
            raise ValueError(
                "input_units must be divisible by filter_size_channel")
        out_units = input_units // filter_size_channel
        self.fsc = filter_size_channel
        self.convs = nn.ModuleList(
            Conv1d(input_units, out_units, 5, groups=out_units)
            for _ in range(filter_size_channel))

    def forward(self, x):
        b, t, c = x.shape
        xs = [F.pad(x, (i + 1, 0))[:, :, :c] for i in range(self.fsc - 2)]
        xs.append(x)
        xs.append(F.pad(x, (0, 1))[:, :, 1:])
        outs = [conv(xi) for conv, xi in zip(self.convs, xs)]
        return torch.stack(outs, dim=-1).reshape(b, t, c)


class TimeConvInceptionBlock(nn.Module):
    """Parallel time convolutions of widths 1, 3 and 5 (the last two
    channelwise), interleaved per source channel ``[o1_i, o3_i, o5_i]`` and
    combined by a grouped width-1 convolution, with a residual connection
    (``paule_tpu/models/blocks.py`` ``time_conv_inception_block``)."""

    def __init__(self, channels):
        super().__init__()
        self.channels = channels
        self.conv1 = Conv1d(channels, channels, 1)
        self.conv3 = Conv1d(channels, channels, 3, groups=channels)
        self.conv5 = Conv1d(channels, channels, 5, groups=channels)
        self.combine = Conv1d(3 * channels, channels, 1, groups=channels)

    def forward(self, x, activation=None, add_resid=True):
        out = x if activation is None else activation(x)
        o1, o3, o5 = self.conv1(out), self.conv3(out), self.conv5(out)
        b, t, c = o1.shape
        out = self.combine(torch.stack([o1, o3, o5], dim=-1).reshape(
            b, t, 3 * c))
        return out + x if add_resid else out
