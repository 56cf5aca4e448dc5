"""The trained classic models' epoch loop: the port of their JAX scans
(``jax.lax.scan`` of ``value_and_grad`` and an optax update) as a
Python loop of autograd steps and ``common.make_optimizer``'s updates."""

from __future__ import annotations

import torch


def train_steps(loss_fn, params, opt, opt_state, xs) -> torch.Tensor:
    """One optimizer step of ``loss_fn(params, *x)`` for each x of ``xs``,
    ``params`` and ``opt_state`` updated in place; the mean loss."""
    losses = []
    for x in xs:
        loss = loss_fn(params, *x)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), opt_state)
        losses.append(loss.detach())
    return torch.stack(losses).mean()


def to_numpy(params) -> dict:
    """The fitted tensors as numpy arrays, for the numpy predictors."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
