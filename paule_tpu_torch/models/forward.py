"""Forward (predictive) models cp -> mel (counterparts of
``paule_tpu/models/forward.py``): the stacked-LSTM :class:`ForwardModel`
the planner uses, and :class:`ForwardModelMelTimeSmoothResidual`, which
adds residual time smoothing and velocity/acceleration features before the
LSTM and mel-channel smoothing after it."""

from torch import nn

from ..ops import lstm as LS
from ..ops.derivatives import add_vel_and_acc_info, half_sequence
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


class ForwardModelMelTimeSmoothResidual(nn.Module):
    """cp ``(B, T, in)`` -> mel ``(B, T/2, out)``: channelwise time-conv
    residual blocks, +vel/acc features, stacked LSTM, linear, half-sequence
    pooling, mel-channel smoothing blocks and a grouped-conv weighting of
    (lstm, smoothed) (``paule_tpu/models/forward.py:57-123``)."""

    def __init__(self, input_size=30, output_size=60, hidden_size=180,
                 num_lstm_layers=4, mel_smooth_layers=3,
                 mel_smooth_filter_size=3, resid_blocks=5, time_filter_size=5,
                 lstm_resid=True):
        super().__init__()
        self.resid_blocks = nn.ModuleList(
            B.TimeConvResBlock(input_size, time_filter_size)
            for _ in range(resid_blocks))
        self.lstm = B.lstm_stack(3 * input_size, hidden_size, num_lstm_layers)
        self.post_linear = B.Linear(hidden_size, output_size)
        self.mel_blocks = nn.ModuleList(
            B.MelChannelConv(output_size, mel_smooth_filter_size)
            for _ in range(mel_smooth_layers))
        self.resid_weighting = None
        if lstm_resid and mel_smooth_layers > 0:
            self.resid_weighting = B.Conv1d(2 * output_size, output_size,
                                            time_filter_size,
                                            groups=output_size)

    def forward(self, x):
        for block in self.resid_blocks:
            x = block(x)
        x = add_vel_and_acc_info(x)
        out, _state = LS.lstm([layer.params() for layer in self.lstm], x)
        out = self.post_linear(out)
        t = out.shape[-2]
        out = half_sequence(out[..., : (t // 2) * 2, :])
        lstm_out = out
        for block in self.mel_blocks:
            out = block(out) + out
        if self.resid_weighting is not None:
            out = self.resid_weighting(B.interleave_channels(lstm_out, out))
        return out
