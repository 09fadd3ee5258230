"""Embedder mel ``(B, T, 60)`` -> semantic vector ``(B, 300)`` (counterpart
of ``paule_tpu/models/embedder.py:23-64``): stacked LSTM, the last valid
hidden state, a linear map."""

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
