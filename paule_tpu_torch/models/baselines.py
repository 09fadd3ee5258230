"""Baseline models (counterpart of ``paule_tpu/models/baselines.py``): one
linear layer, or a two-layer perceptron, used as a predictive (cp -> mel,
half-sequence pooling), inverse (mel -> cp, double-sequence upsampling) or
embedder model.

On the full sequence a model maps every step, with velocity and
acceleration channels appended when ``add_vel_and_acc``; otherwise it maps
each sample's flattened ``(2, C)`` input at once.
"""

from torch import nn

from ..ops.derivatives import (add_vel_and_acc_info, double_sequence,
                               half_sequence)
from . import blocks as B

MODES = ("pred", "inv", "embed")


class _Baseline(nn.Module):

    def __init__(self, input_channel, mode, on_full_sequence,
                 add_vel_and_acc):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        self.mode = mode
        self.on_full_sequence = on_full_sequence
        self.add_vel_and_acc = add_vel_and_acc
        if on_full_sequence:
            self.input_channel = (3 * input_channel if add_vel_and_acc
                                  else input_channel)
        else:
            self.input_channel = 2 * input_channel

    def _inputs(self, x):
        if not self.on_full_sequence:
            return x.reshape(x.shape[0], 1, -1)
        return add_vel_and_acc_info(x) if self.add_vel_and_acc else x

    def _outputs(self, out):
        if self.on_full_sequence and self.mode == "pred":
            t = out.shape[-2]
            return half_sequence(out[..., : (t // 2) * 2, :])
        if self.on_full_sequence and self.mode == "inv":
            return double_sequence(out)
        return out


class LinearModel(_Baseline):

    def __init__(self, input_channel=30, output_channel=60, mode="inv",
                 on_full_sequence=False, add_vel_and_acc=True):
        super().__init__(input_channel, mode, on_full_sequence,
                         add_vel_and_acc)
        self.linear = B.Linear(self.input_channel, output_channel)

    def forward(self, x, *_):
        return self._outputs(self.linear(self._inputs(x)))


class NonLinearModel(_Baseline):
    """As :class:`LinearModel` through a hidden layer of ``hidden_units``
    and leaky ReLU; as an embedder on the full sequence it sums over time
    first."""

    def __init__(self, input_channel=30, output_channel=60,
                 hidden_units=8192, mode="pred", on_full_sequence=False,
                 add_vel_and_acc=True):
        super().__init__(input_channel, mode, on_full_sequence,
                         add_vel_and_acc)
        self.non_linear = B.Linear(self.input_channel, hidden_units)
        self.linear = B.Linear(hidden_units, output_channel)

    def forward(self, x, *_):
        x = self._inputs(x)
        if self.on_full_sequence and self.mode == "embed":
            x = x.sum(dim=1)
        return self._outputs(
            self.linear(B.leaky_relu(self.non_linear(x))))
