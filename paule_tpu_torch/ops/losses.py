"""Losses of planning and continue-learning (counterparts of
``paule_tpu/ops/losses.py``)."""

import torch

from .derivatives import local_linear, vel_acc_jerk


def mse(yhat, y):
    return torch.mean((yhat - y) ** 2)


def rmse(yhat, y, *, eps=0.0):
    return torch.sqrt(mse(yhat, y) + eps)


def bce_with_logits(logits, targets, *, dim=None):
    """Binary cross entropy on logits in the stable form ``max(x, 0) - x z
    + log(1 + exp(-|x|))``, mean-reduced over everything, or over ``dim``."""
    bce = (torch.clamp(logits, min=0.0) - logits * targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return bce.mean() if dim is None else bce.mean(dim=dim)


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


def cp_trajectory_loss(y_hat, tgts):
    """RMSE of position plus 3x the RMSE of velocity, acceleration and
    jerk (the reference sums three identical evaluations of each).
    -> ``(loss, pos_loss, vel_loss, acc_loss, jerk_loss)``, the derivative
    terms already scaled by 3."""
    vel_t, acc_t, jerk_t = vel_acc_jerk(tgts)
    vel_p, acc_p, jerk_p = vel_acc_jerk(y_hat)
    pos_loss = rmse(y_hat, tgts)
    vel_loss = 3.0 * rmse(vel_p, vel_t)
    acc_loss = 3.0 * rmse(acc_p, acc_t)
    jerk_loss = 3.0 * rmse(jerk_p, jerk_t)
    return (pos_loss + vel_loss + acc_loss + jerk_loss, pos_loss, vel_loss,
            acc_loss, jerk_loss)
