"""The device mesh (as ``cleverrec_tpu/parallel/mesh.py``).

A mesh has the JAX package's two axes, ``data`` (each rank a full
replica, its share of the epoch's steps) and ``model`` (the rows of each
row-shardable table, ``parallel/sharding.py``, and the item axis of
sharded ranking), over a world of ``D * M`` ranks.  Each rank is one process on one
explicit device; rank ``r`` sits at data index ``r // M`` and model
index ``r % M``, the layout of ``mesh_utils.create_device_mesh((D, M))``
over the device list.

``torch.distributed`` carries the collectives: one process group per
row and per column of the mesh, built with ``dist.new_group`` on every
rank in the same order.  ``torch.distributed.device_mesh`` is not used:
``init_device_mesh("cuda", ...)`` sets each rank's device from its rank,
which would send rank 1 of two ranks on one card to a ``cuda:1`` that
does not exist; this mesh takes the device from the caller.  The gloo
backend takes ``all_reduce`` and ``all_gather`` on CUDA tensors (seen on
an H100 with torch 2.11), so nothing is staged through host memory.
Over an axis of size 1 every collective is the identity and needs no
process group: a ``1 x 1`` mesh runs without one.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from cleverrec_tpu_torch.common import resolve_device

AXES = ("data", "model")


class Mesh:
    """A ``data x model`` mesh of ranks: ``shape`` {axis: size}, ``rank``
    (this process's), ``device`` (this rank's) and ``groups`` {axis: the
    process group of this rank's row or column}, needed only for an axis
    longer than 1."""

    def __init__(self, n_data: int, n_model: int, device="cuda", rank: int = 0,
                 groups=None):
        if n_data < 1 or n_model < 1:
            raise ValueError(f"mesh {n_data}x{n_model}: sizes must be >= 1")
        if not 0 <= rank < n_data * n_model:
            raise ValueError(f"rank {rank} outside a {n_data}x{n_model} mesh")
        self.shape = {"data": n_data, "model": n_model}
        self.device = resolve_device(device)
        if (self.device.type == "cuda"
                and (self.device.index or 0) >= torch.cuda.device_count()):
            raise RuntimeError(f"rank {rank}: its device {self.device} is "
                               f"missing ({torch.cuda.device_count()} CUDA "
                               "devices)")
        self.rank = rank
        self.groups = dict(groups or {})

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        m = self.shape["model"]
        return self.rank // m if axis == "data" else self.rank % m

    def _group(self, axis: str):
        if axis not in self.groups:
            raise RuntimeError(f"mesh {self}: no process group for the "
                               f"{axis!r} axis (build it with make_mesh)")
        return self.groups[axis]

    def all_reduce_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over the ranks of this rank's ``axis`` group,
        a new tensor (``t`` itself over an axis of size 1)."""
        if self.shape[axis] == 1:
            return t
        out = t.detach().clone()
        dist.all_reduce(out, group=self._group(axis))
        return out

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` of this rank's ``axis`` group joined along
        ``dim`` in index order (``t`` itself over an axis of size 1)."""
        n = self.shape[axis]
        if n == 1:
            return t
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self._group(axis))
        return torch.cat(parts, dim=dim)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}"
                f", rank={self.rank}, device={self.device})")


def world() -> tuple[int, int]:
    """(world size, rank) of the default process group, (1, 0) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_data: int | None = None, n_model: int | None = None,
              device="cuda") -> Mesh:
    """A ``data x model`` mesh over the default process group's ranks (one
    rank without a group), on this rank's ``device``.  Defaults as the
    JAX package's: every rank on the data axis, model axis 1; given one
    size, the other is the world over it.  A world of another size than
    ``n_data * n_model`` raises."""
    n, rank = world()
    if n_data is None and n_model is None:
        n_data, n_model = n, 1
    elif n_data is None:
        n_data = n // n_model
    elif n_model is None:
        n_model = n // n_data
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} ranks")
    groups = {}
    # Every rank builds every group, in the same order (new_group's rule).
    if n_data > 1:
        for m in range(n_model):
            ranks = [d * n_model + m for d in range(n_data)]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups["data"] = g
    if n_model > 1:
        for d in range(n_data):
            ranks = [d * n_model + m for m in range(n_model)]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups["model"] = g
    return Mesh(n_data, n_model, device, rank, groups)


def mesh_device(device, mesh) -> torch.device:
    """The device an entry point runs on: ``device`` (default ``cuda``),
    or under a ``mesh`` the mesh's, which a given ``device`` must name."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    if device is not None:
        want = resolve_device(device)
        if (want.type, want.index or 0) != (mesh.device.type,
                                            mesh.device.index or 0):
            raise ValueError(f"device {want} differs from the mesh's "
                             f"{mesh.device}")
    return mesh.device


def single_device_mesh(device="cuda") -> Mesh:
    """The ``1 x 1`` mesh on ``device``: no process group."""
    return Mesh(1, 1, device)


LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def init_distributed(device="cuda") -> torch.device:
    """Initialise the default process group from a launcher's environment
    (``torchrun`` / ``python -m torch.distributed.run``) and return this
    rank's device: NCCL and ``cuda:LOCAL_RANK`` for ``cuda``; gloo and
    that one card for every rank for ``cuda:N`` (NCCL takes one rank a
    device, so ranks that share a card talk over gloo); gloo and the CPU
    for ``cpu``.  A missing variable, or a rank without its card,
    raises."""
    missing = [k for k in LAUNCHER_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs a launcher's environment; {', '.join(missing)}"
            " not set (launch with torchrun --nproc-per-node N or python -m "
            "torch.distributed.run)")
    want = torch.device(device)
    kind = want.type
    if kind == "cuda":
        pinned = want.index is not None
        local = want.index if pinned else int(os.environ["LOCAL_RANK"])
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= n:
            raise RuntimeError(f"rank {os.environ['RANK']}: its device "
                               f"cuda:{local} is missing ({n} CUDA devices)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "gloo" if pinned else "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"--distributed: no backend for device {device!r}")
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return dev
