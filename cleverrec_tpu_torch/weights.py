"""Parameters and optimizer state carried across from the JAX package.

The JAX models keep a flat ``{name: array}`` pytree whose names match the
port's ``nn.Parameter`` names (BPR: ``P``, ``Q``; GMF: ``P``, ``Q``,
``h_gmf``; MLP and NeuMF: their tables, ``W_l``, ``b_l`` and ``h_*``;
SBPR and TBPR: ``P``, ``Q``, ``bias``; CUNE_BPR also its 0-d ``s``;
CML and TransCF: ``P``, ``Q``; LRML: ``P``, ``Q``, ``K`` [d, mem],
``M`` [mem, d]; SAMN and SAMN_single: ``P`` [U + 1, d], ``Q``, ``i_b``,
``Key``, ``Mem``, ``W3``, ``b``, ``h``; FISM: ``P``, ``Q`` [I + 1, d],
``b`` [I + 1]; NAIS and NAIS_single: ``P``, ``Q`` [I + 1, d], ``bias``
[I + 1], ``W`` [d or 2d, atten], ``b``, ``h``; LightGCN and LR_GCCF:
``P``, ``Q``; NGCF: ``P``, ``Q``, ``W1_l``, ``b1_l``, ``W2_l``, ``b2_l``
a layer; DiffNet: ``P``, ``Q``, ``W_l`` [2d, d], ``b_l`` [d] a layer;
DiffNetPlusPlus: DiffNet's and ``gate_l`` [2] a layer; WMF: ``P``,
``Q``; DMF: ``P``, ``Q`` [., layers[0]], ``Wu_l``, ``bu_l``, ``Wi_l``,
``bi_l`` for l >= 1; SML: ``P``, ``Q``, ``m_u`` [U], ``m_i`` [I];
EATNN: ``P_shared``, ``P_item``, ``P_social`` [U, d], ``Q``, ``att_w``
[d, d], ``att_h`` [d]; RML_DGATs: ``P`` [U + 1, d], ``Q`` [I + 1, d],
``W`` [2d, atten], ``h``, ``b`` [atten], ``W_gat`` [d, d] and, for
``mlp_type`` m >= 1, ``W_mlp_l``, ``b_mlp_l`` a layer; SoHRML: ``P``
[U, d], ``Q`` [I, d], ``W``, ``h``, ``b``, ``W_gat_l`` [d, d] and
``b_gat_l`` [d] a GAT layer, and RML_DGATs' ``W_mlp_l``, ``b_mlp_l``;
the rating models, FM: ``w0`` (0-d), ``wi`` [rows], ``vif`` [rows, d],
and FFM: the same with ``vif`` [rows, n_fields, d], rows =
feature_nums + 1 rounded up to a multiple of 8),
optax's Adam keeps ``opt_state[0]`` = (count, mu, nu) over the same
names and optax's Adagrad ``opt_state[0].sum_of_squares``.  Shapes are
the JAX shapes too, 0-d ones included, so nothing is transposed or
reshaped.
Convert the arrays to numpy on the JAX side (``np.asarray``); nothing
here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from cleverrec_tpu_torch.common import AdagradState, AdamState


def params_from_jax(params: dict[str, np.ndarray],
                    device) -> dict[str, torch.Tensor]:
    """{name: numpy array} -> {name: float32/int tensor on ``device``}."""
    return {name: torch.as_tensor(np.array(value)).to(device)
            for name, value in params.items()}


def _check_like(own: dict, arrays: dict, what: str) -> None:
    """Every name of ``own`` in ``arrays`` and no other, each with its
    shape; raises otherwise."""
    if set(own) != set(arrays):
        raise KeyError(f"{what} names differ: model {sorted(own)}, "
                       f"given {sorted(arrays)}")
    for name, value in arrays.items():
        if tuple(np.shape(value)) != tuple(own[name].shape):
            raise ValueError(f"{what} {name}: shape {tuple(np.shape(value))}"
                             f" != {tuple(own[name].shape)}")


@torch.no_grad()
def load_params(model: torch.nn.Module, params: dict[str, np.ndarray]) -> None:
    """Copy JAX parameters into ``model``'s parameters of the same names;
    every name must match, and every shape."""
    own = dict(model.named_parameters())
    _check_like(own, params, "parameter")
    for name, value in params_from_jax(params, "cpu").items():
        own[name].copy_(value)


def adam_state_from_jax(count, mu: dict[str, np.ndarray],
                        nu: dict[str, np.ndarray], device,
                        model: torch.nn.Module | None = None) -> AdamState:
    """optax's ``ScaleByAdamState`` (``opt_state[0].count``, ``.mu``,
    ``.nu``, as numpy) -> the port's ``AdamState`` on ``device``.  Given
    ``model``, both moments must hold exactly its parameters' names and
    shapes; without it, mu and nu must agree with each other."""
    own = (dict(model.named_parameters()) if model is not None
           else {k: torch.empty(np.shape(v)) for k, v in mu.items()})
    _check_like(own, mu, "mu")
    _check_like(own, nu, "nu")
    return AdamState(int(np.asarray(count)), params_from_jax(mu, device),
                     params_from_jax(nu, device))


def adagrad_state_from_jax(sum_of_squares: dict[str, np.ndarray], device,
                           model: torch.nn.Module | None = None
                           ) -> AdagradState:
    """optax's ``ScaleByRssState`` (``opt_state[0].sum_of_squares``, as
    numpy) -> the port's ``AdagradState`` on ``device``; given ``model``,
    the accumulators must hold exactly its parameters' names and
    shapes."""
    if model is not None:
        _check_like(dict(model.named_parameters()), sum_of_squares,
                    "sum_of_squares")
    return AdagradState(params_from_jax(sum_of_squares, device))
