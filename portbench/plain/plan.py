"""PAULE's planning criterion, Adam on the trajectory with the clamp
projection, and continue-learning's Adam steps on the predictive model,
in plain PyTorch over :mod:`.nets`.

The criterion (quantling/paule ``paule/paule.py``, objective
``acoustic_semvec``): 5 x the RMSE of the predicted mel against the
target mel, 10 x the RMSE of the embedder's semantic vector of the
predicted mel against the target's, 80 x the mean squared velocity and
400 x the mean squared jerk of the trajectory (five-point stencils), and
1e5 x the mean squared second central difference.  With somatosensory
feedback the tube -> mel loss of the predicted tube and the tube
embedder's semantic loss (dropout 0.7 between its layers) are added.
"""

import torch

from . import nets
from .tables import (JERK_WEIGHT, LOCAL_LINEAR_WEIGHT, MEL_WEIGHT,
                     SEMANTIC_WEIGHT, TUBE_MEL_WEIGHT, TUBE_SEMANTIC_WEIGHT,
                     VELOCITY_WEIGHT)

BETAS = (0.9, 0.999)
EPS = 1e-8
CLAMP = 1.05
TUBE_DROPOUT = 0.7


def rmse_rows(a, b):
    return torch.sqrt(((a - b) ** 2).flatten(1).mean(dim=1))


def stencil(x):
    """First derivative by the unpadded five-point stencil over time."""
    return (-x[:, 4:] + 8.0 * x[:, 3:-1] - 8.0 * x[:, 1:-3]
            + x[:, :-4]) / 12.0


def criterion(p, xx, target_mel, target_semvec, somato=False,
              keep_masks=None):
    """-> the loss of each row of ``xx (B, T, 30)``, ``(B,)``."""
    pred_mel = nets.forward_model(p, "predictive", xx)
    vel = stencil(xx)
    jerk = stencil(stencil(vel))
    ll = (2.0 * xx[:, 1:-1] - xx[:, :-2] - xx[:, 2:]) / 2.0
    total = (VELOCITY_WEIGHT * (vel ** 2).flatten(1).mean(1)
             + JERK_WEIGHT * (jerk ** 2).flatten(1).mean(1)
             + LOCAL_LINEAR_WEIGHT * (ll ** 2).flatten(1).mean(1)
             + MEL_WEIGHT * rmse_rows(pred_mel, target_mel)
             + SEMANTIC_WEIGHT * rmse_rows(
                 nets.embedder(p, "embedder", pred_mel), target_semvec))
    if somato:
        tube = nets.forward_model(p, "cp_tube", xx, half=False)
        total = total + TUBE_MEL_WEIGHT * rmse_rows(
            nets.forward_model(p, "tube_mel", tube), target_mel)
        total = total + TUBE_SEMANTIC_WEIGHT * rmse_rows(
            nets.embedder(p, "tube_embedder", tube, keep_masks,
                          TUBE_DROPOUT), target_semvec)
    return total


def adam(x, g, m, v, t, lr):
    """One Adam update of ``x`` with gradient ``g`` at step ``t`` (from 1);
    -> (x, m, v)."""
    m = BETAS[0] * m + (1.0 - BETAS[0]) * g
    v = BETAS[1] * v + (1.0 - BETAS[1]) * g * g
    m_hat = m / (1.0 - BETAS[0] ** t)
    v_hat = v / (1.0 - BETAS[1] ** t)
    return x - lr * m_hat / (torch.sqrt(v_hat) + EPS), m, v


def train_steps(p, state, batches, *, lr=0.001, prefix="predictive"):
    """Continue-learning of the predictive model: one Adam step per
    ``(cp (B, T, 30), mel (B, T/2, 60))`` batch on the loss
    ``sqrt(mean((model(cp) - mel)^2))``, from the weights ``p`` and the
    Adam ``state`` ``{key: (m, v, steps taken)}`` of the model's leaves
    (``None``: a fresh Adam).  -> ``(the loss of each step, {leaf: its
    gradient at the first step}, {leaf: its change over the steps})``."""
    leaves = {k: t.detach().clone() for k, t in p.items()
              if k.startswith(prefix + ".")}
    start = dict(leaves)
    if state is None:
        state = {k: (torch.zeros_like(t), torch.zeros_like(t), 0)
                 for k, t in leaves.items()}
    state = {k: (m.clone(), v.clone(), int(t)) for k, (m, v, t)
             in state.items()}
    others = {k: t for k, t in p.items() if k not in leaves}
    losses, first = [], None
    for x, y in batches:
        live = {k: t.requires_grad_(True) for k, t in leaves.items()}
        pred = nets.forward_model({**others, **live}, prefix, x)
        loss = torch.sqrt(((pred - y) ** 2).mean())
        grads = torch.autograd.grad(loss, list(live.values()))
        losses.append(loss.item())
        if first is None:
            first = dict(zip(live, grads))
        for (k, t), g in zip(live.items(), grads):
            m, v, steps = state[k]
            new, m, v = adam(t.detach(), g, m, v, steps + 1, lr)
            leaves[k] = new
            state[k] = (m, v, steps + 1)
    return losses, first, {k: (leaves[k] - start[k]).detach()
                          for k in leaves}
