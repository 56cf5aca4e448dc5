"""Shared helpers: the device rule, initializers and ``cdiv``.

Initializers take the reference's names (utils/tools.py:51-63, plus
'he') and draw on the CPU from an explicit ``torch.Generator``, so one
seed gives the same tables whatever device they are moved to.  Fan-in
and fan-out follow the JAX package: a ``[n_in, n_out]`` shape.
The losses and optimizers come with the training slice.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


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
