"""Shared numerics: the device rule, losses, initializers, optimizers and
``cdiv`` (as ``cleverrec_tpu/common.py``).

- Losses are SUMS over the batch (the reference's ``reduce_sum``), with
  ``l2_loss(x) = 0.5 * sum(x**2)`` like ``tf.nn.l2_loss``, and an
  optional per-row ``weight`` so padded rows contribute exactly zero.
- Initializers take the reference's names (utils/tools.py:51-63, plus
  'he') and draw on the CPU from an explicit ``torch.Generator``, so one
  seed gives the same tables whatever device they are moved to.  Fan-in
  and fan-out follow the JAX package: a ``[n_in, n_out]`` shape.
- Optimizers are plain functions over ``{name: tensor}`` dicts with
  optax's arithmetic (``optax.sgd``, ``optax.adam``, ``optax.adagrad``),
  dense on every step.  ``torch.optim`` rounds differently and its
  sparse variants skip untouched rows, so it is not used.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple

import torch

Tensors = Dict[str, torch.Tensor]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` needs a card: without
    one this raises instead of falling back to the CPU; pass
    ``device="cpu"`` to run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# -- losses ---------------------------------------------------------------

def l2_loss(x: torch.Tensor) -> torch.Tensor:
    """0.5 * sum(x^2), as tf.nn.l2_loss."""
    return 0.5 * torch.sum(torch.square(x))


def _weighted_sum(per_row, weight):
    return torch.sum(per_row if weight is None else per_row * weight)


def bpr_loss(diff, weight=None):
    """sum(-log sigmoid(diff)); reference 'bpr' (utils/tools.py:71-72)."""
    return _weighted_sum(-torch.nn.functional.logsigmoid(diff), weight)


def hinge_loss(diff, margin: float, weight=None):
    """sum(max(diff + margin, 0)); reference 'hinge' (utils/tools.py:73-74)."""
    return _weighted_sum(torch.clamp(diff + margin, min=0.0), weight)


def pairwise_loss(loss_func: str, diff, *, margin: float = 0.0,
                  weight=None):
    """Dispatch for pairwise losses applied to a score difference."""
    if loss_func == "bpr":
        return bpr_loss(diff, weight)
    if loss_func == "hinge":
        return hinge_loss(diff, margin, weight)
    raise ValueError(f"unsupported pairwise loss {loss_func!r}")


# -- initializers ---------------------------------------------------------

def _fans(shape) -> tuple[int, int]:
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def _uniform(gen, shape, limit):
    return torch.empty(shape).uniform_(-limit, limit, generator=gen)


def _tnormal(gen, shape, std):
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * std


def make_initializer(init_method: str, stddev: float) -> Callable:
    """Returns f(generator, shape) -> float32 CPU tensor."""
    if init_method == "normal":
        return lambda g, shape: stddev * torch.randn(shape, generator=g)
    if init_method == "tnormal":
        return lambda g, shape: _tnormal(g, shape, stddev)
    if init_method == "uniform":
        return lambda g, shape: _uniform(g, shape, stddev)
    if init_method == "xavier":
        return lambda g, shape: _uniform(
            g, shape, math.sqrt(6.0 / sum(_fans(shape))))
    if init_method == "xavier_normal":
        # Unit-variance truncated normal in [-2, 2] has std 0.8796.
        return lambda g, shape: _tnormal(
            g, shape, math.sqrt(2.0 / sum(_fans(shape))) / .87962566103423978)
    if init_method == "he":
        return lambda g, shape: _uniform(
            g, shape, math.sqrt(6.0 / _fans(shape)[0]))
    raise ValueError(f"unknown init_method {init_method!r}")


def init_param(gen: torch.Generator, init: Callable, shape) -> torch.Tensor:
    """Apply an initializer; fan-based inits need >= 2D shapes, so 1D
    params are drawn as (1, n)."""
    if len(shape) == 1:
        return init(gen, (1, shape[0])).reshape(shape)
    return init(gen, tuple(shape))


# -- optimizers -----------------------------------------------------------

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7   # tf's Adagrad default; optax's eps


@dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and both moments."""

    count: int
    mu: Tensors
    nu: Tensors


@dataclass
class AdagradState:
    """optax's ``ScaleByRssState``."""

    sum_of_squares: Tensors


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(params, grads, state) ->
    state`` writes the new parameters into ``params`` (and the new
    moments into ``state``) in place."""

    init: Callable
    update: Callable


def _sgd(lr: float) -> Optimizer:
    @torch.no_grad()
    def update(params, grads, state):
        for k, p in params.items():
            p.add_(-lr * grads[k])
        return state

    return Optimizer(lambda params: None, update)


def _adam(lr: float) -> Optimizer:
    b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS

    def init(params):
        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}
        return AdamState(0, zeros(), zeros())

    @torch.no_grad()
    def update(params, grads, state):
        # optax.scale_by_adam: the bias corrections are taken at the
        # incremented count.
        state.count += 1
        bc1, bc2 = 1.0 - b1 ** state.count, 1.0 - b2 ** state.count
        for k, p in params.items():
            g = grads[k]
            m = state.mu[k].mul_(b1).add_((1.0 - b1) * g)
            v = state.nu[k].mul_(b2).add_((1.0 - b2) * (g * g))
            p.add_(-lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)))
        return state

    return Optimizer(init, update)


def _adagrad(lr: float) -> Optimizer:
    def init(params):
        return AdagradState({k: torch.full_like(p, ADAGRAD_INIT)
                             for k, p in params.items()})

    @torch.no_grad()
    def update(params, grads, state):
        for k, p in params.items():
            g = grads[k]
            s = state.sum_of_squares[k].add_(g * g)
            inv = torch.where(s > 0, torch.rsqrt(s + ADAGRAD_EPS),
                              torch.zeros_like(s))
            p.add_(-lr * (inv * g))
        return state

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float) -> Optimizer:
    """SGD / Adam / Adagrad with TF1-default hyperparameters (reference
    factory: utils/tools.py:79-87), as ``cleverrec_tpu.common``."""
    makers = {"SGD": _sgd, "Adam": _adam, "Adagrad": _adagrad}
    if name not in makers:
        raise ValueError(f"unknown optimizer {name!r}")
    return makers[name](lr)
