"""Sharding rules and the row-sharded embedding exchange (as
``cleverrec_tpu/parallel/sharding.py``), on ``torch.distributed``.

A row-shardable table (2-D, its height an entity cardinality, the
height a multiple of the mesh's ``model`` size M) is held as rows
``[m N / M, (m + 1) N / M)`` on model rank m, the JAX package's
``P('model', None)``; every other leaf is replicated.  A model whose
tables are split this way (``shard_model``) keeps the shards as its
parameters and names them in ``model.row_shards`` ({name: full
height}); its code still reads full tables, through one of the views of
``table_views``:

- ``gspmd``: each row-sharded table all-gathered over ``model``
  (``gather_table``: its backward keeps this rank's rows of the
  gradient, no collective), the resharding XLA falls back to;
- ``explicit``: every embedding table seen through an ``ExchangeTable``,
  whose integer indexing and ``embedding`` go through
  ``row_sharded_gather`` (a masked local gather and one sum over
  ``model``; its backward a local scatter-add and the identity) and whose
  any other use sees the all-gathered table;
- ``serve``: ``ExchangeTable`` views of the row-sharded tables alone, for
  ranking (``ranking.rank_sharded``).

Each rank of a model group computes the same loss on the same batch, so
a gradient's cotangent is already replicated over ``model``: the
backwards need no collective (JAX's identity psum).  Over ``data`` the
scan tier splits each batch (``data_chunk``: a rank's contiguous chunk,
``part_of_loss``: its rows term plus, on data rank 0, the table terms)
and sums the parts' gradients with one all-reduce a step
(``over_data``); the whole-step tiers take data rank 0's gradients
(``over_data(..., take_rank0=True)``), as the model axis takes model
rank 0's (``agree_grads``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_map

AXIS = "model"
EXCHANGES = ("gspmd", "explicit")


def _is_embedding_table(x, meta) -> bool:
    """Row-shardable: 2-D with a leading dim that is one of the entity
    cardinalities (user or item counts, possibly +1 for a sentinel row,
    or their sum)."""
    if getattr(x, "ndim", 0) != 2:
        return False
    cards = {meta.user_nums, meta.user_nums + 1, meta.item_nums,
             meta.item_nums + 1, meta.user_nums + meta.item_nums}
    return x.shape[0] in cards


def _rowshardable(x, meta, mesh) -> bool:
    """Row-shard only where the leading dim divides over the model axis;
    odd-sized tables (the +1 sentinel tables) stay replicated, as
    GSPMD's divisibility rule keeps them."""
    return (_is_embedding_table(x, meta)
            and x.shape[0] % mesh.shape[AXIS] == 0)


def param_sharding_tree(params: dict, meta, mesh) -> dict:
    """{name: the leaf's placement}: ``("model", None)`` for a
    row-sharded table, ``()`` for a replicated leaf (the JAX package's
    PartitionSpecs)."""
    return {k: (AXIS, None) if _rowshardable(x, meta, mesh) else ()
            for k, x in params.items()}


def shard_rows(x: torch.Tensor, mesh, axis: str = AXIS) -> torch.Tensor:
    """This rank's block of ``x``'s leading dim over ``axis`` (a view);
    the dim must divide."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not divide over {n} "
                         f"{axis} ranks")
    size = x.shape[0] // n
    lo = mesh.index(axis) * size
    return x[lo:lo + size]


def shard_params(params: dict, meta, mesh) -> dict:
    """The leaves this rank holds: its rows of each row-shardable table
    (a copy), every other leaf as it is."""
    return {k: shard_rows(x, mesh).clone() if _rowshardable(x, meta, mesh)
            else x for k, x in params.items()}


def replicate(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` whole on this rank's device."""
    return x.to(mesh.device)


def chunk_bounds(n: int, parts: int, index: int) -> tuple[int, int]:
    """Rows [lo, hi) of chunk ``index`` when n rows split into ``parts``
    contiguous chunks as ``torch.tensor_split`` splits them (the first
    n % parts chunks one row longer)."""
    size, extra = divmod(n, parts)
    lo = index * size + min(index, extra)
    return lo, lo + size + (index < extra)


def shard_batch_spec(mesh, axis: str = "data"):
    """A function that keeps this data rank's chunk of a batch's leading
    axis, each leaf's: ``torch.tensor_split`` into as many contiguous
    chunks as ``axis`` has ranks (any batch size, as GSPMD shards any)."""
    def constrain(batch: dict) -> dict:
        return {k: torch.tensor_split(v, mesh.shape[axis])[mesh.index(axis)]
                for k, v in batch.items()}
    return constrain


def gather_chunks(x: torch.Tensor, n: int, mesh,
                  axis: str = "data") -> torch.Tensor:
    """The ``axis`` ranks' chunks of an n-row leading axis (this rank's
    ``x``, its ``shard_batch_spec`` chunk) joined in row order: one
    all-gather of the chunks padded to the longest (without a mesh or
    an ``axis``, ``x``)."""
    parts = 1 if mesh is None else mesh.shape[axis]
    if parts == 1:
        return x
    longest = -(-n // parts)
    pad = x.new_zeros((longest - x.shape[0],) + tuple(x.shape[1:]))
    joined = mesh.all_gather(torch.cat([x.detach(), pad]), axis)
    rows = [chunk_bounds(n, parts, d) for d in range(parts)]
    return torch.cat([joined[d * longest:d * longest + hi - lo]
                      for d, (lo, hi) in enumerate(rows)])


# -- the collectives as autograd functions --------------------------------

class _AllGather(torch.autograd.Function):
    """Forward: the group's blocks joined on dim 0; backward: this rank's
    rows of the gradient (the cotangent is replicated)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, x.shape[0]
        return mesh.all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.index(ctx.axis) * ctx.rows
        return g[lo:lo + ctx.rows], None, None


class _OwnBlock(torch.autograd.Function):
    """Forward: this rank's block of a replicated tensor; backward: the
    group's gradient blocks joined (``_AllGather``'s transpose)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return shard_rows(x, mesh, axis).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), ctx.axis), None, None


class _Psum(torch.autograd.Function):
    """Forward: the sum over the group; backward: the identity."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    """Forward: the identity; backward: the sum over the group
    (``_Psum``'s transpose)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_sum(g.contiguous(), ctx.axis), None, None


def gather_table(x: torch.Tensor, mesh, axis: str = AXIS) -> torch.Tensor:
    """The whole table from this rank's row block over ``axis``,
    differentiable: its gradient keeps this rank's rows, with no
    collective."""
    if mesh.shape[axis] == 1:
        return x
    return _AllGather.apply(x, mesh, axis)


def row_sharded_gather(table: torch.Tensor, ids: torch.Tensor, mesh,
                       axis: str = AXIS,
                       data_axis: str | None = None) -> torch.Tensor:
    """Rows of a row-sharded table by global ids
    (cleverrec_tpu/parallel/sharding.py:80-113).

    ``table``: this rank's block [N / M, ...] of a table whose rows are
    split over ``axis`` in rank order; ``ids``: global ids of any shape,
    the same on every rank of the group.  Each rank gathers the rows it
    owns through ``embedding`` on its local ids (the others read row 0 and
    are zeroed, so their gradient adds nothing), and one sum over
    ``axis`` assembles the rows: [*ids.shape, ...].  Its backward is
    ``embedding``'s scatter-add into this rank's rows, with no collective.
    With ``data_axis``, each data rank gathers its chunk of the flattened
    ids, the chunks are joined over ``data_axis``, and the table's
    gradient is summed over ``data_axis``."""
    size = table.shape[0]
    flat = ids.reshape(-1).long()
    total = flat.shape[0]
    split = data_axis is not None and mesh.shape[data_axis] > 1
    if split:
        nd = mesh.shape[data_axis]
        per = -(-total // nd)
        flat = shard_rows(F.pad(flat, (0, per * nd - total)), mesh,
                          data_axis)
        table = _SumGrad.apply(table, mesh, data_axis)
    local = flat - mesh.index(axis) * size
    owned = (local >= 0) & (local < size)
    part = F.embedding(torch.where(owned, local, 0), table.reshape(size, -1))
    part = torch.where(owned[:, None], part, 0.0)
    if mesh.shape[axis] > 1:
        part = _Psum.apply(part, mesh, axis)
    if split:
        part = _AllGather.apply(part, mesh, data_axis)[:total]
    return part.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


def pad_table_for_sharding(table: torch.Tensor, n_shards: int, dim: int = 0,
                           value: float = 0.0) -> torch.Tensor:
    """Pad ``dim`` of ``table`` up to a multiple of ``n_shards`` with
    ``value`` (the JAX function pads the leading dim with zeros; sharded
    ranking pads the item axis of its scores with -inf).  The padded
    slots are never real ids."""
    pad = (-table.shape[dim]) % n_shards
    if pad == 0:
        return table
    shape = list(table.shape)
    shape[dim] = pad
    return torch.cat([table, table.new_full(shape, value)], dim=dim)


# -- the explicit exchange ------------------------------------------------

def _int_ids(x) -> bool:
    return (isinstance(x, torch.Tensor) and not x.is_floating_point()
            and not x.is_complex() and x.dtype != torch.bool)


_METADATA = {torch.Tensor.shape.__get__, torch.Tensor.dtype.__get__,
             torch.Tensor.device.__get__, torch.Tensor.ndim.__get__,
             torch.Tensor.requires_grad.__get__, torch.Tensor.dim,
             torch.Tensor.size, torch.Tensor.numel, torch.Tensor.__len__,
             torch.Tensor.is_floating_point}


class ExchangeTable(torch.Tensor):
    """A full-height view of an embedding table
    (cleverrec_tpu/parallel/sharding.py:116-176) that routes integer
    indexing (``t[ids]``) and ``F.embedding(ids, t)`` (``gather_rows``)
    through ``row_sharded_gather`` and gives every other use the whole
    table (``whole``: all-gathered once a view, e.g. CML's covariance over
    the full tables or a full-catalog product).

    ``table``: this rank's row block (``sharded``) of a ``rows``-high
    table, or the whole replicated table, which the view pads to a
    multiple of M with zero rows and cuts to this rank's block
    (``_OwnBlock``, whose backward joins the blocks' gradients), as the
    JAX view pads a table that does not divide.  The view holds no data
    (a stride-0 tensor of the full shape carries its shape, dtype and
    device); built inside the loss, it leaves autograd to act on
    ``table``."""

    @staticmethod
    def __new__(cls, table, mesh, rows: int, sharded: bool = True,
                axis: str = AXIS, data_axis: str | None = None):
        shape = (rows,) + tuple(table.shape[1:])
        view = torch.Tensor._make_subclass(
            cls, table.detach().new_zeros(()).expand(shape), False)
        view._table, view._mesh, view._axis = table, mesh, axis
        view._data_axis, view._sharded = data_axis, sharded
        view._local = table if sharded else None
        view._whole = None if sharded else table
        return view

    def local(self) -> torch.Tensor:
        """This rank's row block of the (padded) table."""
        if self._local is None:
            n = self._mesh.shape[self._axis]
            padded = pad_table_for_sharding(self._table, n)
            self._local = (padded if n == 1
                           else _OwnBlock.apply(padded, self._mesh,
                                                self._axis))
        return self._local

    def whole(self) -> torch.Tensor:
        """The whole table (a row-sharded one all-gathered, once)."""
        if self._whole is None:
            self._whole = gather_table(self._table, self._mesh, self._axis)
        return self._whole

    def gather(self, ids: torch.Tensor) -> torch.Tensor:
        return row_sharded_gather(self.local(), ids, self._mesh, self._axis,
                                  self._data_axis)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is torch.Tensor.__getitem__
                and isinstance(args[0], ExchangeTable) and _int_ids(args[1])):
            return args[0].gather(args[1])
        if (func is F.embedding and len(args) > 1
                and isinstance(args[1], ExchangeTable) and _int_ids(args[0])
                and kwargs.get("padding_idx") is None
                and kwargs.get("max_norm") is None
                and not kwargs.get("scale_grad_by_freq")
                and not kwargs.get("sparse")):
            return args[1].gather(args[0])
        if func in _METADATA:
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)

        def whole(x):
            return x.whole() if isinstance(x, ExchangeTable) else x
        return func(*tree_map(whole, args), **tree_map(whole, kwargs))


def wrap_explicit_exchange(params: dict, meta, mesh, shards=None,
                           data_axis: str | None = None) -> dict:
    """Every embedding-table leaf of ``params`` as an ``ExchangeTable``
    (the ``parallel.exchange=explicit`` tier); ``shards`` {name: full
    height} names the leaves that hold row blocks.  Other leaves pass
    through."""
    shards = shards or {}
    out = {}
    for k, x in params.items():
        if k in shards:
            out[k] = ExchangeTable(x, mesh, shards[k], data_axis=data_axis)
        elif _is_embedding_table(x, meta):
            out[k] = ExchangeTable(x, mesh, x.shape[0], sharded=False,
                                   data_axis=data_axis)
        else:
            out[k] = x
    return out


# -- a model's row-sharded parameters -------------------------------------

def shards_of(model) -> dict:
    """{name: full height} of ``model``'s row-sharded parameters (empty
    for a model that holds its tables whole)."""
    return getattr(model, "row_shards", None) or {}


def shard_model(model: torch.nn.Module, mesh, names) -> dict:
    """Replace each named parameter of ``model`` by this rank's row block
    of it (a new ``Parameter``) and record {name: full height} in
    ``model.row_shards``; returns that record."""
    shards = {}
    for name in names:
        p = model._parameters[name]
        model._parameters[name] = torch.nn.Parameter(
            shard_rows(p.detach(), mesh).clone())
        shards[name] = p.shape[0]
    model.row_shards = shards
    return shards


def unshard_model(model: torch.nn.Module, mesh=None) -> None:
    """Give ``model`` its full-height parameters back: the blocks
    all-gathered over ``model`` (a collective: every rank of the group
    calls it), or zeros without a ``mesh`` (for a fresh draw)."""
    for name, rows in shards_of(model).items():
        p = model._parameters[name].detach()
        if mesh is None:
            full = p.new_zeros((rows,) + tuple(p.shape[1:]))
        else:
            full = mesh.all_gather(p, AXIS)
        model._parameters[name] = torch.nn.Parameter(full)
    model.row_shards = {}


def _flat_sum(tensors: list, mesh, axis: str, rank0: bool = False) -> list:
    """``tensors`` summed over the ranks of this rank's ``axis`` group by
    one all-reduce of them joined flat (with ``rank0``, every rank but
    index 0 contributing zeros: rank 0's tensors on every rank); the
    results in the tensors' shapes."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    if rank0 and mesh.index(axis):
        flat = torch.zeros_like(flat)
    flat = mesh.all_reduce_sum(flat, axis)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def agree_grads(grads: dict, shards: dict, mesh) -> dict:
    """The gradients the ranks of a model group agree on, each rank having
    computed the whole step itself: a leaf not in ``shards`` (replicated
    over ``model``) takes model rank 0's gradient.  Without it the ranks'
    replicas part by rounding wherever a kernel sums in a run-dependent
    order (``index_add``'s atomics on a card); with deterministic kernels
    it changes no bit.  One all-reduce of those gradients joined flat,
    the other ranks' zeroed."""
    keys = [k for k in grads if k not in shards]
    if mesh.shape[AXIS] == 1 or not keys:
        return grads
    agreed = _flat_sum([grads[k] for k in keys], mesh, AXIS, rank0=True)
    return {**grads, **dict(zip(keys, agreed))}


def over_data(grads: dict, loss: torch.Tensor, mesh, take_rank0=False):
    """(gradients, loss) over the ranks of this rank's data group, by one
    all-reduce a step (a row block joins the blocks of its model index:
    the data group shares the model index).  By default their sum: the
    scan tier's batch split, each rank's gradients of its part of the
    loss and the part itself, summed to the whole batch's, the JAX
    trainer's GSPMD step.  With ``take_rank0``, data rank 0's: the
    grouped pairwise, bucketed and dual tiers, which the JAX trainer
    keeps replicated, each rank having run the whole step, so that
    ``index_add``'s run-dependent rounding on a card leaves no two
    replicas apart.  Without a mesh or a data axis, as given."""
    if mesh is None or mesh.shape["data"] == 1:
        return grads, loss
    *joined, loss = _flat_sum(list(grads.values()) + [loss.reshape(1)],
                              mesh, "data", rank0=take_rank0)
    return dict(zip(grads, joined)), loss.reshape(())


def full_tensors(tensors: dict, shards: dict, mesh) -> dict:
    """``tensors`` with each row-sharded leaf all-gathered over ``model``
    (every rank of the group calls it)."""
    return {k: mesh.all_gather(v.detach(), AXIS) if k in shards else v
            for k, v in tensors.items()}


def local_tensors(tensors: dict, shards: dict, mesh) -> dict:
    """``tensors`` (whole) with each row-sharded leaf cut to this rank's
    rows."""
    return {k: shard_rows(v, mesh) if k in shards else v
            for k, v in tensors.items()}


@contextlib.contextmanager
def swap_params(model: torch.nn.Module, tensors: dict):
    """Within the block, ``model``'s named parameter slots hold
    ``tensors`` (any tensors: ``nn.Module.__setattr__`` would refuse one
    that is not a ``Parameter``); the parameters come back after."""
    old = {k: model._parameters[k] for k in tensors}
    model._parameters.update(tensors)
    try:
        yield
    finally:
        model._parameters.update(old)


@contextlib.contextmanager
def table_views(model: torch.nn.Module, mesh, exchange: str = "gspmd"):
    """Within the block, ``model``'s tables read as full tables (see the
    module's docstring): ``gspmd``, ``explicit`` or ``serve``.  Nested
    views leave the outer ones in place; without a mesh, or without
    row-sharded tables and the explicit exchange, nothing changes."""
    shards = shards_of(model)
    if (mesh is None or getattr(model, "_views_on", False)
            or not (shards or exchange == "explicit")):
        yield
        return
    params = {k: model._parameters[k] for k in model._parameters}
    if exchange == "gspmd":
        views = {k: gather_table(params[k], mesh) for k in shards}
    elif exchange == "explicit":
        views = wrap_explicit_exchange(params, model.meta, mesh, shards)
    elif exchange == "serve":
        views = {k: ExchangeTable(params[k], mesh, rows)
                 for k, rows in shards.items()}
    else:
        raise ValueError(f"parallel.exchange={exchange!r}: want one of "
                         f"{', '.join(EXCHANGES)}")
    model._views_on = True
    try:
        with swap_params(model, views):
            yield
    finally:
        model._views_on = False


def data_chunk(batch: dict, mesh) -> dict:
    """This data rank's chunk of every leaf of ``batch`` (each leaf's
    leading axis n long, cut as ``shard_batch_spec`` cuts it) and
    ``chunk``: (lo, hi, n), the rows of the whole batch it holds.  A loss
    that draws a batch-shaped tensor draws it for all n rows and keeps
    rows lo:hi, so the draw is the unsplit step's.  Without a mesh or a
    data axis, ``batch`` as it is."""
    if mesh is None or mesh.shape["data"] == 1:
        return batch
    n = next(iter(batch.values())).shape[0]
    lo, hi = chunk_bounds(n, mesh.shape["data"], mesh.index("data"))
    return {**shard_batch_spec(mesh)(batch), "chunk": (lo, hi, n)}


def part_of_loss(parts, mesh) -> torch.Tensor:
    """This data rank's part of the loss from ``loss_parts``' (rows,
    tables): the rows term over its chunk, plus the table terms on data
    rank 0 alone, so that the parts sum to the whole batch's loss
    (without a mesh, rows + tables: the loss)."""
    rows, tables = parts
    return rows if mesh is not None and mesh.index("data") else rows + tables


def sharded_train_step(model, optimizer, mesh, item_nums: int,
                       neg_ratio: int, exchange: str = "gspmd"):
    """A standalone train step over the mesh
    (cleverrec_tpu/parallel/sharding.py:190-217): pairwise sampling
    (``sampling.pairwise_batch``), this data rank's chunk of the batch,
    its part of the loss (``model.loss_parts``, ``part_of_loss``) through
    ``table_views`` (``exchange``), the gradients summed over ``data``
    with the loss (``over_data``), and the optimizer's update.

    Returned fn signature:
        step(params, opt_state, gen, arrays, rows, valid)
            -> (params, opt_state, loss)
    ``params``: the model's own parameters (row blocks after
    ``shard_model``), updated in place; ``gen``: the sampler's generator,
    the same seed on every rank; ``arrays``: ``pos_u``, ``pos_i`` and
    ``seen`` (a ``sampling.MemberTable``) as in the trainer; ``rows`` and
    ``valid``: the step's shuffled epoch row ids and weights."""
    from cleverrec_tpu_torch import sampling

    def step(params, opt_state, gen, arrays, rows, valid):
        batch = sampling.pairwise_batch(
            gen, rows, valid, arrays["pos_u"], arrays["pos_i"],
            arrays["seen"], item_nums, neg_ratio)
        names = list(params)
        leaves = [params[k] for k in names]
        with table_views(model, mesh, exchange):
            loss = part_of_loss(model.loss_parts(data_chunk(batch, mesh),
                                                 arrays), mesh)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for k, p, g in zip(names, leaves, torch.autograd.grad(
                     loss, leaves, allow_unused=True))}
        grads, loss = over_data(grads, loss.detach(), mesh)
        grads = agree_grads(grads, shards_of(model), mesh)
        opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, loss

    return step
