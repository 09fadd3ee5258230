"""Trajectory derivatives on the time axis of ``(..., T, C)`` tensors
(counterparts of ``paule_tpu/ops/derivatives.py``)."""

import torch


def five_point_stencil(x, *, delta_t=1.0):
    """First derivative by an unpadded five-point stencil: ``T -> T - 4``."""
    return (-x[..., 4:, :] + 8.0 * x[..., 3:-1, :] - 8.0 * x[..., 1:-3, :]
            + x[..., :-4, :]) / (12.0 * delta_t)


def local_linear(x, *, delta_t=1.0):
    """Second central difference, zero where ``x`` is locally linear:
    ``T -> T - 2``."""
    return (2.0 * x[..., 1:-1, :] - x[..., :-2, :] - x[..., 2:, :]) / (
        2.0 * delta_t)


def vel_acc_jerk(x, *, delta_t=1.0):
    velocity = five_point_stencil(x, delta_t=delta_t)
    acc = five_point_stencil(velocity, delta_t=delta_t)
    jerk = five_point_stencil(acc, delta_t=delta_t)
    return velocity, acc, jerk


def add_vel_and_acc_info(x):
    """Append first and second forward differences as channels:
    ``(..., T, C) -> (..., T, 3C)``; the last velocity row and the first and
    last acceleration rows are zero."""
    zeros = torch.zeros_like(x[..., :1, :])
    velocity = x[..., 1:, :] - x[..., :-1, :]
    acceleration = velocity[..., 1:, :] - velocity[..., :-1, :]
    velocity = torch.cat([velocity, zeros], dim=-2)
    acceleration = torch.cat([zeros, acceleration, zeros], dim=-2)
    return torch.cat([x, velocity, acceleration], dim=-1)


def double_sequence(x):
    """``(..., T, C) -> (..., 2T, C)``: ``out[2t] = x[t]``,
    ``out[2t+1] = (x[t] + x[t+1]) / 2``, the last odd slot repeats
    ``x[T-1]``."""
    mid = (x[..., :-1, :] + x[..., 1:, :]) / 2.0
    x2 = torch.cat([mid, x[..., -1:, :]], dim=-2)
    stacked = torch.stack([x, x2], dim=-2)
    return stacked.reshape(*x.shape[:-2], 2 * x.shape[-2], x.shape[-1])


def half_sequence(x):
    """``(..., 2T, C) -> (..., T, C)`` by averaging pairs of steps."""
    t = x.shape[-2]
    if t % 2 != 0:
        raise ValueError(f"sequence length must be even, got {t}")
    return x.reshape(*x.shape[:-2], t // 2, 2, x.shape[-1]).mean(dim=-2)
