"""Inverse model mel ``(B, T, 60)`` -> cp ``(B, 2T, 30)`` (counterpart of
``paule_tpu/models/inverse.py:19-85``): mel-channel smoothing blocks, +vel/acc
features, stacked LSTM, linear, midpoint upsampling x2, time-conv residual
stack, grouped-conv weighting of (smoothed, lstm)."""

from torch import nn

from ..ops import lstm as LS
from ..ops.derivatives import add_vel_and_acc_info, double_sequence
from . import blocks as B


class InverseModelMelTimeSmoothResidual(nn.Module):

    #: the model's name in a traced call's LSTM op records (as
    #: ``ForwardModel.trace_name``)
    trace_name = None

    def __init__(self, input_size=60, output_size=30, hidden_size=180,
                 num_lstm_layers=4, mel_smooth_layers=3,
                 mel_smooth_filter_size=3, resid_blocks=5,
                 time_filter_size=5, lstm_resid=True):
        super().__init__()
        self.mel_blocks = nn.ModuleList(
            B.MelChannelConv(input_size, mel_smooth_filter_size)
            for _ in range(mel_smooth_layers))
        self.lstm = B.lstm_stack(3 * input_size, hidden_size, num_lstm_layers)
        self.post_linear = B.Linear(hidden_size, output_size)
        self.resid_blocks = nn.ModuleList(
            B.TimeConvResBlock(output_size, time_filter_size)
            for _ in range(resid_blocks))
        self.resid_weighting = None
        if lstm_resid and resid_blocks > 0:
            self.resid_weighting = B.Conv1d(2 * output_size, output_size,
                                            time_filter_size,
                                            groups=output_size)

    def forward(self, x):
        for block in self.mel_blocks:
            x = block(x) + x
        x = add_vel_and_acc_info(x)
        out, _state = LS.lstm([layer.params() for layer in self.lstm], x,
                              model=self.trace_name)
        out = double_sequence(self.post_linear(out))
        lstm_out = out
        for block in self.resid_blocks:
            out = block(out)
        if self.resid_weighting is not None:
            out = self.resid_weighting(B.interleave_channels(out, lstm_out))
        return out
