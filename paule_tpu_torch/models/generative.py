"""The conditional GAN generator: a semantic vector and noise -> a cp or mel
trajectory of a requested length (counterpart of
``paule_tpu/models/generative.py:22-105``, inference mode).

``Generator(noise (B, 1, 100), length, semvec (B, 300)) -> (B, length,
30 | 60)``: a linear layer to ``fc_size`` values, read as ``fc_size / 4``
channels over 4 steps, then ``num_res_blocks`` blocks, each a linear
upsampling in time to ``int(length / (n - i))`` steps, a convolution, batch
norm (running statistics), leaky ReLU (0.2) and a residual connection
(block 0 only when its input has ``hidden_size`` channels), then a linear
map to the output size and a grouped smoothing convolution with a residual
connection, through ``tanh``.
"""

import torch
from torch import nn

from . import blocks as B


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
