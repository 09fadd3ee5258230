"""Generative models (counterpart of ``paule_tpu/models/generative.py``):
the conditional WGAN-GP pair ``Generator`` and ``Critic``, the direct
semvec -> trajectory LSTMs ``SemVecToCpModel`` and ``SemVecToMelModel``,
and the recurrent GAN pair ``LSTMCritic`` and ``LSTMGenerator``.

``Generator(noise (B, 1, 100), length, semvec (B, 300)) -> (B, length,
30 | 60)``: a linear layer to ``fc_size`` values, read as ``fc_size / 4``
channels over 4 steps, then ``num_res_blocks`` blocks, each a linear
upsampling in time to ``int(length / (n - i))`` steps, a convolution, batch
norm (running statistics), leaky ReLU (0.2) and a residual connection
(block 0 only when its input has ``hidden_size`` channels), then a linear
map to the output size and a grouped smoothing convolution with a residual
connection, through ``tanh``.  In ``train()`` mode the batch norms
normalise with the batch statistics and update their running statistics
(:class:`~paule_tpu_torch.models.blocks.BatchNorm`).

``Critic(x (B, T, C), length, semvec (B, 300)) -> (B,)``: the semvec
concatenated to every step, a linear map to ``hidden_size``, then
``num_res_blocks`` residual blocks of a convolution, instance norm and leaky
ReLU (0.2), averaged over time and channels.
"""

import torch
from torch import nn

from ..ops import lstm as LS
from . import blocks as B


def _with_semvec(x, vector):
    """``x (B, T, C)`` and ``vector (B, E)`` -> ``(B, T, C + E)``."""
    cond = vector[:, None, :].expand(x.shape[0], x.shape[1],
                                     vector.shape[-1])
    return torch.cat([x, cond], dim=2)


class GeneratorBlock(nn.Module):

    def __init__(self, in_channels, hidden_size):
        super().__init__()
        self.conv = B.Conv1d(in_channels, hidden_size, 5)
        self.bn = B.BatchNorm(hidden_size)

    def forward(self, x):
        return B.leaky_relu(self.bn(self.conv(x)), 0.2)


class Generator(nn.Module):

    def __init__(self, channel_noise=100, embed_size=300, fc_size=1024,
                 inital_seq_length=4, hidden_size=256, num_res_blocks=5,
                 output_size=30):
        super().__init__()
        self.hidden_size = hidden_size
        self.output_size = output_size
        self.fc_reshaped_size = fc_size // inital_seq_length
        self.fully_connected = B.Linear(channel_noise + embed_size, fc_size)
        self.blocks = nn.ModuleList(
            GeneratorBlock(self.fc_reshaped_size if i == 0 else hidden_size,
                           hidden_size)
            for i in range(num_res_blocks))
        self.post_linear = B.Linear(hidden_size, output_size)
        self.final_smoothing = B.Conv1d(output_size, output_size, 5,
                                        groups=output_size)

    def forward(self, noise, length, vector):
        """``noise (B, 1, channel_noise)``, ``length`` an int, ``vector
        (B, embed_size)`` -> ``(B, length, output_size)``."""
        length = int(length)
        x = torch.cat([noise, vector[:, None, :]], dim=2)
        out = self.fully_connected(x)                      # (B, 1, fc_size)
        out = out.reshape(out.shape[0], self.fc_reshaped_size, -1)
        out = out.transpose(1, 2)                          # (B, L0, C)
        n = len(self.blocks)
        for i, block in enumerate(self.blocks):
            out = B.upsample_linear(out, int(length / (n - i)))
            h = block(out)
            if i > 0 or self.fc_reshaped_size == self.hidden_size:
                h = h + out
            out = h
        out = self.post_linear(out)
        out = self.final_smoothing(out) + out
        return torch.tanh(out)


class CriticBlock(nn.Module):

    def __init__(self, hidden_size):
        super().__init__()
        self.conv = B.Conv1d(hidden_size, hidden_size, 5)
        self.in_norm = B.InstanceNorm(hidden_size)

    def forward(self, x):
        return B.leaky_relu(self.in_norm(self.conv(x)), 0.2) + x


class Critic(nn.Module):
    """The Wasserstein critic (``paule_tpu/models/generative.py:108-147``);
    its parameters are named as the JAX tree names them (``inital_linear``,
    ``blocks.i.conv``, ``blocks.i.in_norm``)."""

    def __init__(self, input_size=30, embed_size=300, hidden_size=180,
                 num_res_blocks=5):
        super().__init__()
        self.inital_linear = B.Linear(input_size + embed_size, hidden_size)
        self.blocks = nn.ModuleList(CriticBlock(hidden_size)
                                    for _ in range(num_res_blocks))

    def forward(self, x, length, vector):
        """``length`` is accepted and unused, as in the JAX package."""
        del length
        out = self.inital_linear(_with_semvec(x, vector))
        for block in self.blocks:
            out = block(out)
        return out.mean(dim=(1, 2))


class SemVecToCpModel(nn.Module):
    """semvec sequence ``(B, T, 300)`` -> cp trajectory ``(B, T, 30)``
    (``paule_tpu/models/generative.py:150-199``): stacked LSTM (4 layers at
    H=180 run as two fused pairs), linear, channelwise time-conv residual
    blocks, and a grouped convolution weighting ``(smoothed, lstm)``."""

    def __init__(self, input_size=300, output_size=30, hidden_size=180,
                 num_lstm_layers=4, resid_blocks=5, time_filter_size=5,
                 lstm_resid=True):
        super().__init__()
        self.lstm = B.lstm_stack(input_size, hidden_size, num_lstm_layers)
        self.post_linear = B.Linear(hidden_size, output_size)
        self.resid_blocks = nn.ModuleList(
            B.TimeConvResBlock(output_size, time_filter_size)
            for _ in range(resid_blocks))
        self.resid_weighting = None
        if lstm_resid and resid_blocks > 0:
            self.resid_weighting = B.Conv1d(2 * output_size, output_size,
                                            time_filter_size,
                                            groups=output_size)

    def forward(self, x, *_):
        out, _state = LS.lstm([layer.params() for layer in self.lstm], x)
        out = self.post_linear(out)
        lstm_out = out
        for block in self.resid_blocks:
            out = block(out)
        if self.resid_weighting is not None:
            out = self.resid_weighting(B.interleave_channels(out, lstm_out))
        return out


class SemVecToMelModel(nn.Module):
    """semvec sequence ``(B, T, 300)`` -> mel ``(B, T, 60)``
    (``paule_tpu/models/generative.py:202-254``): stacked LSTM, linear,
    residual mel-channel convolutions, and a grouped convolution weighting
    ``(lstm, smoothed)``."""

    def __init__(self, input_size=300, output_size=60, hidden_size=180,
                 num_lstm_layers=4, mel_smooth_layers=3,
                 mel_smooth_filter_size=3, time_filter_size=5,
                 lstm_resid=True):
        super().__init__()
        self.lstm = B.lstm_stack(input_size, hidden_size, num_lstm_layers)
        self.post_linear = B.Linear(hidden_size, output_size)
        self.mel_blocks = nn.ModuleList(
            B.MelChannelConv(output_size, mel_smooth_filter_size)
            for _ in range(mel_smooth_layers))
        self.resid_weighting = None
        if lstm_resid and mel_smooth_layers > 0:
            self.resid_weighting = B.Conv1d(2 * output_size, output_size,
                                            time_filter_size,
                                            groups=output_size)

    def forward(self, x, *_):
        out, _state = LS.lstm([layer.params() for layer in self.lstm], x)
        out = self.post_linear(out)
        lstm_out = out
        for block in self.mel_blocks:
            out = block(out) + out
        if self.resid_weighting is not None:
            out = self.resid_weighting(B.interleave_channels(lstm_out, out))
        return out


class _RecurrentGAN(nn.Module):
    """The LSTM of :class:`LSTMCritic` and :class:`LSTMGenerator`: in
    ``train()`` mode with dropout between layers, each layer alone through
    B1/B2 and the masks drawn on the input's device from ``generator`` (or
    ``keep_masks`` replayed); in ``eval()`` mode the layers run as fused
    pairs through B3/B4 (:func:`paule_tpu_torch.ops.lstm.lstm`)."""

    def _lstm(self, x, generator, keep_masks):
        return LS.lstm([layer.params() for layer in self.lstm], x,
                       dropout=self.dropout, training=self.training,
                       generator=generator, keep_masks=keep_masks)[0]


class LSTMCritic(_RecurrentGAN):
    """Recurrent critic (``paule_tpu/models/generative.py:257-292``):
    ``(x (B, T, C), lens, semvec) -> (B, output_size)``, the last valid
    step's hidden state through a linear map."""

    def __init__(self, input_size=30, embed_size=300, output_size=1,
                 hidden_size=200, num_lstm_layers=2, dropout=0.5):
        super().__init__()
        self.dropout = dropout
        self.lstm = B.lstm_stack(input_size + embed_size, hidden_size,
                                 num_lstm_layers)
        self.fully_connected = B.Linear(hidden_size, output_size)

    def forward(self, x, lens, vector, *, generator=None, keep_masks=None):
        out = self._lstm(_with_semvec(x, vector), generator, keep_masks)
        return self.fully_connected(B.gather_last_step(out, lens))


class LSTMGenerator(_RecurrentGAN):
    """Recurrent generator (``paule_tpu/models/generative.py:295-334``):
    ``(noise (B, T, channel_noise), lens, semvec) -> (B, T, output_size)``
    through a linear map and leaky ReLU (0.2), the LSTM, a linear map and
    ``tanh``."""

    def __init__(self, channel_noise=60, embed_size=300, output_size=30,
                 hidden_size=200, num_lstm_layers=2, dropout=0.5):
        super().__init__()
        self.dropout = dropout
        self.fully_connected = B.Linear(channel_noise + embed_size,
                                        hidden_size)
        self.lstm = B.lstm_stack(hidden_size, hidden_size, num_lstm_layers)
        self.post_linear = B.Linear(hidden_size, output_size)

    def forward(self, x, lens, vector, *, generator=None, keep_masks=None):
        """``lens`` is accepted and unused, as in the JAX package."""
        del lens
        out = B.leaky_relu(self.fully_connected(_with_semvec(x, vector)), 0.2)
        out = self._lstm(out, generator, keep_masks)
        return torch.tanh(self.post_linear(out))
