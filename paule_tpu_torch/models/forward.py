"""Forward (predictive) model cp -> mel (counterpart of
``paule_tpu/models/forward.py:20-54``)."""

from torch import nn

from ..ops import lstm as LS
from ..ops.derivatives import half_sequence
from . import blocks as B


class ForwardModel(nn.Module):
    """Stacked LSTM + linear + half-sequence pooling:
    cp ``(B, T, in)`` -> mel ``(B, T/2, out)``."""

    def __init__(self, input_size=30, output_size=60, hidden_size=180,
                 num_lstm_layers=4, apply_half_sequence=True):
        super().__init__()
        self.apply_half_sequence = apply_half_sequence
        self.lstm = B.lstm_stack(input_size, hidden_size, num_lstm_layers)
        self.post_linear = B.Linear(hidden_size, output_size)

    def forward(self, x):
        out, _state = LS.lstm([layer.params() for layer in self.lstm], x)
        out = self.post_linear(out)
        if self.apply_half_sequence:
            t = out.shape[-2]
            out = half_sequence(out[..., : (t // 2) * 2, :])
        return out
