"""Losses of planning (counterparts of ``paule_tpu/ops/losses.py``)."""

import torch

from .derivatives import local_linear, vel_acc_jerk


def mse(yhat, y):
    return torch.mean((yhat - y) ** 2)


def rmse(yhat, y, *, eps=0.0):
    return torch.sqrt(mse(yhat, y) + eps)


def velocity_jerk_loss(pred, *, loss=rmse, guiding_factor=None):
    """(velocity_loss, jerk_loss) of a trajectory against stillness, or
    against a ``guiding_factor``-scaled detached copy of itself."""
    vel, _acc, jerk = vel_acc_jerk(pred, delta_t=1.0)
    if guiding_factor is None:
        return (loss(vel, torch.zeros_like(vel)),
                loss(jerk, torch.zeros_like(jerk)))
    if not 0.0 < guiding_factor < 1.0:
        raise ValueError("guiding_factor must be in (0, 1)")
    return (loss(vel, guiding_factor * vel.detach()),
            loss(jerk, guiding_factor * jerk.detach()))


def local_linear_loss(cps):
    """MSE of the second central difference against zero."""
    ll = local_linear(cps)
    return mse(ll, torch.zeros_like(ll))
