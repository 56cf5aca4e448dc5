"""Parameters and Adam state carried across from the JAX package.

The JAX models keep a flat ``{name: array}`` pytree whose names match the
port's ``nn.Parameter`` names (BPR: ``P``, ``Q``), and optax's Adam keeps
``opt_state[0]`` = (count, mu, nu) over the same names.  Convert the
arrays to numpy on the JAX side (``np.asarray``); nothing here imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from cleverrec_tpu_torch.common import AdamState


def params_from_jax(params: dict[str, np.ndarray],
                    device) -> dict[str, torch.Tensor]:
    """{name: numpy array} -> {name: float32/int tensor on ``device``}."""
    return {name: torch.as_tensor(np.array(value)).to(device)
            for name, value in params.items()}


@torch.no_grad()
def load_params(model: torch.nn.Module, params: dict[str, np.ndarray]) -> None:
    """Copy JAX parameters into ``model``'s parameters of the same names;
    every name must match, and every shape."""
    own = dict(model.named_parameters())
    if set(own) != set(params):
        raise KeyError(f"parameter names differ: model {sorted(own)}, "
                       f"given {sorted(params)}")
    for name, value in params_from_jax(params, "cpu").items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                             f"{tuple(own[name].shape)}")
        own[name].copy_(value)


def adam_state_from_jax(count, mu: dict[str, np.ndarray],
                        nu: dict[str, np.ndarray], device) -> AdamState:
    """optax's ``ScaleByAdamState`` (``opt_state[0].count``, ``.mu``,
    ``.nu``, as numpy) -> the port's ``AdamState`` on ``device``."""
    if set(mu) != set(nu):
        raise KeyError(f"mu {sorted(mu)} and nu {sorted(nu)} differ")
    return AdamState(int(np.asarray(count)), params_from_jax(mu, device),
                     params_from_jax(nu, device))
