"""Checkpoints and warm-start grafts (as
``cleverrec_tpu/train/checkpoint.py``), with ``torch.save`` and
``torch.load(weights_only=True)``.

- A train-state checkpoint is a directory holding ``state.pt``: the
  parameters, the optimizer's state (Adam's count and moments,
  Adagrad's accumulators), the epoch, and the generators' states (the
  trainer's sampler and dropout generators, torch's CPU generator and,
  on a card, its CUDA generator).  Every tensor is saved on the CPU; a
  load puts nothing on a device.
- Grafts map a pretrained model's parameters into a target's, with the
  reference's names: NeuMF from GMF and MLP, with h_neumf =
  0.5 * concat(h_gmf, h_mlp) (NeuMF.py:53-56, :127-139), and NAIS from
  FISM (P, Q, bias; NAIS_single.py:35-38).  A model that takes a warm
  start names its keys (``pretrain_keys``) and grafts itself
  (``warm_start``): NeuMF, NAIS and NAIS_single.
"""

from __future__ import annotations

import os
import shutil

import torch

from cleverrec_tpu_torch.common import AdagradState, AdamState

STATE_FILE = "state.pt"
# The warm-start keys the port reads.
PRETRAIN_KEYS = ("gmf_pretrain", "mlp_pretrain", "fism_pretrain")


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().to("cpu").clone() for k, v in tensors.items()}


def optimizer_state_dict(state) -> dict | None:
    """The optimizer's state as plain dicts of CPU tensors."""
    if state is None:
        return None
    if isinstance(state, AdamState):
        return {"kind": "adam", "count": int(state.count),
                "mu": _cpu(state.mu), "nu": _cpu(state.nu)}
    if isinstance(state, AdagradState):
        return {"kind": "adagrad",
                "sum_of_squares": _cpu(state.sum_of_squares)}
    raise TypeError(f"unknown optimizer state {type(state).__name__}")


def copy_into(own: dict, saved: dict, what: str) -> None:
    """Copy each of ``saved``'s tensors into ``own``'s of the same name;
    the names and every shape must match."""
    if set(own) != set(saved):
        raise KeyError(f"{what} names differ: expected {sorted(own)}, "
                       f"saved {sorted(saved)}")
    for k, t in own.items():
        if tuple(saved[k].shape) != tuple(t.shape):
            raise ValueError(f"{what} {k}: saved shape "
                             f"{tuple(saved[k].shape)} != {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(saved[k])


def load_optimizer_state(saved: dict | None, like):
    """Copy a saved optimizer state into ``like`` (a fresh state of the
    same optimizer over the same parameters) and return it."""
    if like is None or saved is None:
        if (like is None) != (saved is None):
            raise ValueError("the checkpoint's optimizer differs from the "
                             "trainer's")
        return like
    kind = {AdamState: "adam", AdagradState: "adagrad"}[type(like)]
    if saved["kind"] != kind:
        raise ValueError(f"checkpoint holds {saved['kind']} state, the "
                         f"trainer runs {kind}")
    if kind == "adam":
        copy_into(like.mu, saved["mu"], "mu")
        copy_into(like.nu, saved["nu"], "nu")
        like.count = int(saved["count"])
    else:
        copy_into(like.sum_of_squares, saved["sum_of_squares"],
                  "sum_of_squares")
    return like


def save_checkpoint(path: str, params: dict, opt_state=None, epoch: int = 0,
                    rng: dict | None = None) -> str:
    """Write a train-state checkpoint into the directory ``path``; returns
    its absolute path.  ``params`` maps names to tensors; ``rng`` maps
    names to generator states (``torch.Generator.get_state()``).

    Crash-safe: the state goes into a fresh sibling ``path.inprogress``
    first, and the old copy is moved to ``path.old`` and removed only
    once the new one is in place."""
    path = os.path.abspath(path)
    state = {"params": _cpu(params), "epoch": int(epoch),
             "opt_state": optimizer_state_dict(opt_state),
             "rng": {k: v.to("cpu") for k, v in (rng or {}).items()}}
    tmp, old = path + ".inprogress", path + ".old"
    for stale in (tmp, old):
        if os.path.exists(stale):
            shutil.rmtree(stale)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    if os.path.exists(path):
        os.rename(path, old)            # keep the previous copy until
    os.rename(tmp, path)                # the new one is in place
    if os.path.exists(old):
        shutil.rmtree(old)
    return path


def load_checkpoint(path: str) -> dict:
    """Read a checkpoint that ``save_checkpoint`` wrote, on the CPU."""
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location="cpu", weights_only=True)


def load_params(path: str) -> dict:
    return load_checkpoint(path)["params"]


# -- warm-start grafts ----------------------------------------------------

def graft_neumf(neumf_params: dict, gmf_params: dict,
                mlp_params: dict) -> dict:
    """NeuMF's parameters warm-started from pretrained GMF and MLP towers
    (NeuMF.py:53-56, :127-139).  Each dict maps names to tensors."""
    out = dict(neumf_params)
    out["P_gmf"] = gmf_params["P"]
    out["Q_gmf"] = gmf_params["Q"]
    out["h_gmf"] = gmf_params["h_gmf"]
    out["P_mlp"] = mlp_params["P"]
    out["Q_mlp"] = mlp_params["Q"]
    out["h_mlp"] = mlp_params["h_mlp"]
    # Only the layers the target has: a deeper pretrained tower would
    # graft W_k and b_k that no layer reads.
    for k, v in mlp_params.items():
        if k.startswith(("W_", "b_")):
            if k not in neumf_params:
                raise ValueError(
                    f"mlp_pretrain layer {k!r} has no slot in the target "
                    "NeuMF (layers config mismatch)")
            if tuple(v.shape) != tuple(neumf_params[k].shape):
                raise ValueError(
                    f"mlp_pretrain layer {k!r} shape {tuple(v.shape)} != "
                    f"target {tuple(neumf_params[k].shape)} (layers config "
                    "mismatch)")
            out[k] = v
    out["h_neumf"] = 0.5 * torch.cat([torch.as_tensor(gmf_params["h_gmf"]),
                                      torch.as_tensor(mlp_params["h_mlp"])])
    return out


def graft_nais(nais_params: dict, fism_params: dict) -> dict:
    """NAIS's parameters warm-started from pretrained FISM
    (NAIS_single.py:35-38)."""
    out = dict(nais_params)
    out["P"] = fism_params["P"]
    out["Q"] = fism_params["Q"]
    out["bias"] = fism_params["b"]
    return out
