"""Collective building blocks of the sharded index and the recsys lookup,
the port of ``src/repro/distributed/collectives.py`` onto
``torch.distributed``.

The JAX package writes them for ``shard_map``: a function sees its shard
and names the mesh axes a collective runs over.  Here every rank runs the
function, a collective takes the :class:`~repro_torch.launch.mesh.AxisGroup`
of those axes (``axis_group(mesh, axes)``), and a factory's function
takes the same global arguments on every rank and returns the same global
result on every rank:

* ``all_gather(..., axis=1, tiled=True)`` is :func:`all_gather_cat` over
  the group, concatenated in the axes' row-major order;
* ``pmin`` / ``pmax`` / ``psum`` are :func:`all_reduce` with MIN, MAX, SUM;
* an input sharded over axes is sliced in contiguous blocks, block ``i``
  on the rank whose row-major index over those axes is ``i``; an output
  sharded over the batch axes is gathered back the same way.

Inside a loss that autograd differentiates, the transposes JAX derives
are written out: :func:`all_gather_rows` (backward a reduce-scatter),
:func:`psum_forward` (backward the identity) and :func:`replicated` (a
parameter's gradient summed over the group).

Under gloo a CUDA tensor goes through a host copy (gloo's CUDA support
does not cover every op); NCCL takes it in place.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.distances import _no_tf32
from repro_torch.launch.mesh import AxisGroup, axis_group
from repro_torch.train.tree import tree_map


def _staged(t: torch.Tensor, ag: AxisGroup) -> bool:
    return ag.backend == "gloo" and t.is_cuda


def all_gather_cat(t: torch.Tensor, ag: AxisGroup, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of the group, concatenated on ``dim`` in the
    order of the ranks' index over the group's axes."""
    if ag.group is None:
        return t
    src = (t.cpu() if _staged(t, ag) else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(ag.size)]
    torch.distributed.all_gather(parts, src, group=ag.group)
    return torch.cat([parts[g] for g in ag.order], dim=dim).to(t.device)


def all_reduce(t: torch.Tensor, ag: AxisGroup, op) -> torch.Tensor:
    """A reduced copy of ``t`` over the group (``op`` a ``ReduceOp``)."""
    if ag.group is None:
        return t
    buf = t.cpu() if _staged(t, ag) else t.clone()
    buf = buf.contiguous()
    torch.distributed.all_reduce(buf, op=op, group=ag.group)
    return buf.to(t.device)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ag):
        ctx.ag = ag
        return all_gather_cat(t, ag, 0)

    @staticmethod
    def backward(ctx, g):
        summed = all_reduce(g, ctx.ag, torch.distributed.ReduceOp.SUM)
        return block(summed, ctx.ag, 0), None


def all_gather_rows(t: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """``all_gather(t, axes, axis=0, tiled=True)`` with JAX's transpose as
    its backward: a reduce-scatter, each rank's block of the cotangents
    summed over the group.  Gloo has no ``reduce_scatter``, so the
    backward is an ``all_reduce`` and this rank's slice of it."""
    return _GatherRows.apply(t, ag)


class _PsumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ag):
        return all_reduce(t, ag, torch.distributed.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_forward(t: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """``t`` summed over the group, its cotangent passed through unchanged:
    the sum of a replicated result's per-rank terms.  Unlike
    ``torch.distributed.nn.functional.all_reduce``, whose backward sums
    again, this does not scale the gradients by the group's size."""
    return _PsumForward.apply(t, ag)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ag):
        ctx.ag = ag
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ag, torch.distributed.ReduceOp.SUM), None


def replicated(t: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """``t`` as a value every rank of the group holds alike (a replicated
    parameter): the identity forward, and its gradient summed over the
    group once in the backward, as ``shard_map`` sums the cotangents of
    an input it replicates."""
    return _Replicated.apply(t, ag)


def block(x: torch.Tensor, ag: AxisGroup, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim``: the slice a
    ``PartitionSpec`` over the group's axes gives it.  ``x.shape[dim]``
    must divide evenly."""
    n = x.shape[dim]
    if n % ag.size:
        raise ValueError(f"dim {dim} of size {n} does not split evenly "
                         f"over {ag.axes} ({ag.size} ranks)")
    b = n // ag.size
    return x.narrow(dim, ag.index * b, b)


# ---------------------------------------------------------------------------
# distributed exact top-k merge
# ---------------------------------------------------------------------------
def topk_merge_allgather(local_vals: torch.Tensor, local_ids: torch.Tensor,
                         k: int, group: AxisGroup):
    """Each rank holds (B, c) candidates with *global* ids; gather them
    over ``group`` and keep the k smallest values: (vals (B, k), ids
    (B, k)).  The sort is stable over the gathered order, so equal values
    keep the lower position, as ``lax.top_k`` of the negated values does.

    Collective volume per query: ranks * c * 8 bytes."""
    vals = all_gather_cat(local_vals, group, 1)
    ids = all_gather_cat(local_ids, group, 1)
    top, pos = torch.sort(vals, dim=1, stable=True)
    pos = pos[:, :k]
    return top[:, :k], torch.gather(ids, 1, pos)


def sharded_brute_topk(mesh, *, k: int, shard_axes: Sequence[str],
                       batch_axes=None, metric: str = "ip") -> Callable:
    """Returns f(queries (B, m), db (N, m)) -> (vals (B, k), ids (B, k)):
    DB rows in contiguous blocks over ``shard_axes``, local scoring and an
    exact global merge.

    ``metric='ip'`` scores by inner product (descending); ``'l2'`` by
    squared euclidean distance (ascending), in the expanded form
    ``|q|^2 + |x|^2 - 2 q.x`` with TF32 off."""
    shards = axis_group(mesh, tuple(shard_axes))
    batch = axis_group(mesh, batch_axes)

    def f(queries: torch.Tensor, db: torch.Tensor):
        q = block(queries, batch)
        local = block(db, shards)
        _no_tf32()
        if metric == "ip":
            scores = -(q @ local.T)             # negate: unify to "smaller"
        else:
            q2 = torch.sum(q * q, 1, keepdim=True)
            d2 = torch.sum(local * local, 1)
            scores = q2 + d2[None, :] - 2.0 * (q @ local.T)
        n_local = local.shape[0]
        kk = min(k, n_local)
        vals, pos = torch.sort(scores, dim=1, stable=True)
        # global row ids: offset by this rank's block along shard_axes
        ids = (pos[:, :kk] + shards.index * n_local).to(torch.int32)
        vals, ids = topk_merge_allgather(vals[:, :kk], ids, k, shards)
        if metric == "ip":
            vals = -vals
        return all_gather_cat(vals, batch, 0), all_gather_cat(ids, batch, 0)

    return f


# ---------------------------------------------------------------------------
# gradient compression (int8 all-reduce path)
# ---------------------------------------------------------------------------
def int8_compress(x: torch.Tensor):
    """Per-tensor symmetric int8 quantization: returns (q, scale)."""
    amax = torch.amax(torch.abs(x)).to(torch.float32)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compressed_psum(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """All-reduce with an int8 payload: agree on a *global* scale (a MAX of
    one scalar: per-rank scales cannot be mixed after the sum), quantize,
    SUM the payload as int32 (no overflow past 127 ranks), dequantize.
    Every rank gets the same bits."""
    amax = all_reduce(torch.amax(torch.abs(x)).to(torch.float32), group,
                      torch.distributed.ReduceOp.MAX)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    total = all_reduce(q.to(torch.int32), group,
                       torch.distributed.ReduceOp.SUM)
    return total.to(torch.float32) * scale


def make_compressed_grad_allreduce(mesh, dp_axis) -> Callable:
    """tree -> tree: int8-compressed mean all-reduce over the DP axes of a
    dict (or a nest of dicts) of tensors, each leaf in its own dtype."""
    group = axis_group(mesh, dp_axis)

    def one(g):
        return (compressed_psum(g, group) / float(group.size)).to(g.dtype)

    return lambda grads: tree_map(one, grads)


# ---------------------------------------------------------------------------
# sharded embedding lookup factory (recsys hot path)
# ---------------------------------------------------------------------------
def make_sharded_lookup(mesh, *, table_axis: str = "model",
                        batch_axes=None) -> Callable:
    """Returns lookup(table (V, E), ids (B, ...)) -> (B, ..., E) for a
    table in contiguous row blocks over ``table_axis``: each rank resolves
    the hits in its rows and the partial results are summed over the axis
    (``models/embedding_bag.sharded_embedding_lookup``)."""
    from repro_torch.models.embedding_bag import sharded_embedding_lookup

    tables = axis_group(mesh, table_axis)
    batch = axis_group(mesh, batch_axes)

    def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        local = block(table, tables)
        out = sharded_embedding_lookup(local, block(ids, batch),
                                       tables.index * local.shape[0], tables)
        return all_gather_cat(out, batch, 0)

    return lookup
