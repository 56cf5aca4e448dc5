"""Parameters carried across from the JAX package.

The JAX models keep a flat ``{name: array}`` pytree whose names match the
port's ``nn.Parameter`` names (BPR: ``P``, ``Q``).  Convert the arrays
to numpy on the JAX side (``np.asarray``); nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch


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
