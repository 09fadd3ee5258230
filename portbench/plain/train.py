"""Continue-learning's Adam steps on any of PAULE's forward models, in
plain PyTorch over :mod:`.nets`: the predictive model (cp -> mel), the
cp->tube model, whose output keeps every frame (``half=False``), and the
tube->mel model.  :func:`.plan.train_steps` covers the predictive model
alone."""

import torch

from . import nets
from .plan import adam


def train_steps(p, batches, *, prefix, half=True, lr=0.001):
    """One Adam step per ``(input (B, T, C), target)`` batch on the loss
    ``sqrt(mean((model(input) - target)^2))`` of the forward model
    ``prefix``, from the weights ``p`` and a fresh Adam.  -> ``(the loss of
    each step, {leaf: its gradient at the first step}, [{leaf: its weights
    after each step}])``."""
    leaves = {k: t.detach().clone() for k, t in p.items()
              if k.startswith(prefix + ".")}
    others = {k: t for k, t in p.items() if k not in leaves}
    state = {k: (torch.zeros_like(t), torch.zeros_like(t))
             for k, t in leaves.items()}
    losses, first, weights = [], None, []
    for step, (x, y) in enumerate(batches, 1):
        live = {k: t.requires_grad_(True) for k, t in leaves.items()}
        pred = nets.forward_model({**others, **live}, prefix, x, half)
        loss = torch.sqrt(((pred - y) ** 2).mean())
        grads = torch.autograd.grad(loss, list(live.values()))
        losses.append(loss.item())
        if first is None:
            first = dict(zip(live, grads))
        for (k, t), g in zip(live.items(), grads):
            new, m, v = adam(t.detach(), g, *state[k], step, lr)
            leaves[k], state[k] = new, (m, v)
        weights.append(dict(leaves))
    return losses, first, weights
