"""Embedders mel ``(B, T, 60)`` -> semantic vector ``(B, 300)``
(counterparts of ``paule_tpu/models/embedder.py``): :class:`EmbeddingModel`
(stacked LSTM, the last valid hidden state, a linear map) and
:class:`MelEmbeddingModelMelSmoothResidualUpsampling` (mel-channel
smoothing first, and a wide hidden projection)."""

from torch import nn

from ..ops import lstm as LS
from . import blocks as B


class EmbeddingModel(nn.Module):

    def __init__(self, input_size=60, output_size=300, hidden_size=720,
                 num_lstm_layers=1, post_upsampling_size=0, dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.lstm = B.lstm_stack(input_size, hidden_size, num_lstm_layers)
        self.post_linear = None
        if post_upsampling_size > 0:
            self.post_linear = B.Linear(hidden_size, post_upsampling_size)
            self.linear_mapping = B.Linear(post_upsampling_size, output_size)
        else:
            self.linear_mapping = B.Linear(hidden_size, output_size)

    def forward(self, x, lens=None, *, generator=None, keep_masks=None):
        """``lens=None`` takes the last step of every row; inter-layer
        dropout is active in ``train()`` mode and draws from ``generator``
        (on ``x``'s device), or takes ``keep_masks``
        (:func:`paule_tpu_torch.ops.lstm.lstm`)."""
        out, _state = LS.lstm([layer.params() for layer in self.lstm], x,
                              dropout=self.dropout, training=self.training,
                              generator=generator, keep_masks=keep_masks)
        out = B.gather_last_step(out, lens)
        if self.post_linear is not None:
            out = B.leaky_relu(self.post_linear(out))
        return self.linear_mapping(out)


class MelEmbeddingModelMelSmoothResidualUpsampling(nn.Module):
    """Mel-channel smoothing blocks, stacked LSTM, the last valid hidden
    state, a linear projection to ``post_upsampling_size`` with leaky ReLU,
    and a linear map to the semantic vector
    (``paule_tpu/models/embedder.py:67-115``)."""

    def __init__(self, input_size=60, output_size=300, hidden_size=180,
                 num_lstm_layers=4, mel_smooth_layers=3,
                 mel_smooth_filter_size=3, post_upsampling_size=8192):
        super().__init__()
        self.mel_blocks = nn.ModuleList(
            B.MelChannelConv(input_size, mel_smooth_filter_size)
            for _ in range(mel_smooth_layers))
        self.lstm = B.lstm_stack(input_size, hidden_size, num_lstm_layers)
        self.post_linear = B.Linear(hidden_size, post_upsampling_size)
        self.upsampling = B.Linear(post_upsampling_size, output_size)

    def forward(self, x, lens=None):
        """``lens=None`` takes the last step of every row."""
        for block in self.mel_blocks:
            x = block(x) + x
        out, _state = LS.lstm([layer.params() for layer in self.lstm], x)
        out = B.gather_last_step(out, lens)
        out = B.leaky_relu(self.post_linear(out))
        return self.upsampling(out)
