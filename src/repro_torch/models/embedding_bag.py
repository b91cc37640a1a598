"""EmbeddingBag over one stacked table, the port of
``src/repro/models/embedding_bag.py``.

* :func:`embedding_bag_fixed` — fixed fields (B, F): a weighted gather-sum,
  the DLRM/DCN layout and DIN's pooled means.  The sum is the
  ``bag_lookup`` kernel (``kernels/bag_lookup``) behind the autograd
  Function :class:`BagLookup`, whose backward is the ``bag_bwd_order`` and
  ``bag_lookup_bwd`` kernels; the mean divides outside it, under torch's
  autograd.
* :func:`history_lookup` — DIN's history: its rows (padded slots 0) and
  the weighted bag over the same ids, two autograd nodes
  (:class:`HistoryRows`, :class:`HistoryBag`) that share one index
  preparation a step and take the table's whole gradient from both in one
  ``bag_lookup_bwd`` launch, as JAX's autodiff transposes its one lookup
  (``src/repro/models/recsys.py:212-220``).
* :func:`embedding_bag_ragged` / :func:`embedding_bag_max` — ragged bags
  flattened to (N,) with ``segment_ids``: a gather, then ``index_add_`` /
  ``scatter_reduce`` (the JAX package's ``take`` + ``segment_sum`` /
  ``segment_max``).  A segment id outside [0, num_bags) raises here where
  ``jax.ops.segment_sum`` drops it.

``sharded_embedding_lookup`` is the row-sharded lookup on one rank:
each rank holds a contiguous row range of the stacked table, resolves the
ids that fall in it, and the partial results are summed over the ranks
that share the table (``distributed/collectives.py::make_sharded_lookup``
builds it over a mesh).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.bag_lookup import ops as bag_ops


class BagLookup(torch.autograd.Function):
    """``bag_ops.bag_lookup(table, ids, weights)`` with its gradient to the
    table and the weights from ``bag_ops.bag_lookup_bwd``: on a card each
    is one call of a hand-written kernel, on the CPU its plain version.
    The module's attributes are looked up at each call, so a caller that
    routes them to the plain versions (``chip_smoke.py``) routes both."""

    @staticmethod
    def forward(ctx, table, ids, weights):
        ctx.save_for_backward(table, ids, weights)
        return bag_ops.bag_lookup(table, ids, weights)

    @staticmethod
    def backward(ctx, g):
        table, ids, weights = ctx.saved_tensors
        need_table = ctx.needs_input_grad[0]
        need_w = weights is not None and ctx.needs_input_grad[2]
        if not (need_table or need_w):
            return None, None, None
        grad_w, grad_table = bag_ops.bag_lookup_bwd(
            table, ids, weights, g, need_w=need_w, need_table=need_table)
        return grad_table, None, grad_w


class HistoryLink:
    """What the two nodes of one history lookup share: the bag's backward,
    which autograd runs first, leaves the ids' order (``bag_ops.bwd_order``,
    with the bag's weights) here for the gather's, which takes them out.
    It holds the weights detached: the weights' autograd history reaches
    the gather's node, which holds the link, and a cycle through autograd
    nodes is never collected (it kept a DIN step's graph alive)."""

    def __init__(self):
        self.order = None
        self.weights = None


class HistoryRows(torch.autograd.Function):
    """``(rows, token)``: the rows ``table[clip(ids, 0, V-1)]`` (B, F, E)
    with 0 at an invalid (< 0) id, and a (B, E) float32 zero ``token``
    that the history's :class:`HistoryBag` takes, so that the bag's
    backward runs before this node's and hands it the bag's cotangent
    ``g`` as the token's.  The backward is the table's whole gradient,
    one ``bag_ops.table_grad``: ``G[b, f] + w[b, f] * g[b]`` summed into
    each valid entry's row from the order the bag left in ``link``.  The
    forward gathers from the table with one zero row appended, so no
    padded slot is clamped to row 0."""

    @staticmethod
    def forward(ctx, table, ids, link):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(table, ids)
        ctx.link = link
        V, E = table.shape
        idx = torch.where(ids >= 0, ids.clamp(max=V - 1), V).to(torch.int64)
        rows = torch.nn.functional.embedding(
            idx, torch.cat([table, table.new_zeros((1, E))]))
        token = torch.zeros((ids.shape[0], E), dtype=torch.float32,
                            device=table.device)
        return rows, token

    @staticmethod
    def backward(ctx, G, g):
        table, ids = ctx.saved_tensors
        link = ctx.link
        order, weights = link.order, link.weights
        link.order = link.weights = None
        if not ctx.needs_input_grad[0]:
            return None, None, None
        if g is None:
            weights = None
        if order is None:                      # no bag, or its g is unused
            order, _ = bag_ops.bwd_order(table, ids, weights)
        grad = bag_ops.table_grad(order, table, ids, weights, g, G)
        return grad.to(table.dtype), None, None


class HistoryBag(torch.autograd.Function):
    """``bag_ops.bag_lookup(table, ids, weights)`` over the ids of a
    :class:`HistoryRows` node whose ``token`` and ``link`` it takes.  Its
    backward returns ``grad_w`` (``bag_ops.bwd_order``, which also sorts
    the ids with the weights, into ``link``) and passes ``g`` to the
    token; the table's share of its gradient is the gather node's to
    add."""

    @staticmethod
    def forward(ctx, table, ids, weights, token, link):
        ctx.save_for_backward(table, ids, weights)
        ctx.link = link
        return bag_ops.bag_lookup(table, ids, weights)

    @staticmethod
    def backward(ctx, g):
        table, ids, weights = ctx.saved_tensors
        need_w = weights is not None and ctx.needs_input_grad[2]
        link = ctx.link
        link.order, grad_w = bag_ops.bwd_order(table, ids, weights, g,
                                               need_w=need_w)
        link.weights = None if weights is None else weights.detach()
        return None, None, grad_w, g, None


def history_lookup(table: torch.Tensor, ids: torch.Tensor):
    """DIN's history over ``table`` (V, E) at ``ids`` (B, S) int32, -1
    padded: ``(rows, bag)``, the rows (B, S, E) in the table's type with 0
    at a padded slot, and ``bag(weights (B, S)) -> (B, E)`` float32, the
    weighted sum of the same rows, taken once.  On a card the table's
    gradient from both is one ``bag_lookup_bwd`` launch after one
    ``bag_bwd_order`` launch."""
    link = HistoryLink()
    rows, token = HistoryRows.apply(table, ids, link)
    return rows, lambda weights: HistoryBag.apply(table, ids, weights,
                                                  token, link)


def embedding_bag_fixed(table: torch.Tensor, ids: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        combiner: str = "sum",
                        bag_fn: Optional[Callable] = None) -> torch.Tensor:
    """table (V, E), ids (B, F) int32 -> (B, E) in the table's type.
    INVALID (< 0) ids contribute 0; ids >= V are clipped to V - 1; the sum
    is taken in float32.  ``bag_fn(table, ids, weights)`` takes the sum's
    place (a row-sharded lookup's ``bag``); the mean divides it alike."""
    if combiner not in ("sum", "mean"):
        raise ValueError(combiner)
    out = (bag_fn or BagLookup.apply)(table, ids, weights)
    if combiner == "mean":
        w = (ids >= 0).to(torch.float32)
        if weights is not None:
            w = w * weights.to(torch.float32)
        out = out / torch.clamp_min(w.sum(dim=1, keepdim=True), 1.0)
    return out.to(table.dtype)


def embedding_bag_ragged(table: torch.Tensor, flat_ids: torch.Tensor,
                         segment_ids: torch.Tensor, num_bags: int,
                         weights: Optional[torch.Tensor] = None,
                         combiner: str = "sum") -> torch.Tensor:
    """Ragged bags: flat_ids (N,), segment_ids (N,) -> (num_bags, E)."""
    rows = table[flat_ids.to(torch.int64)]                      # (N, E)
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    seg = segment_ids.to(torch.int64)
    out = torch.zeros((num_bags, table.shape[1]), dtype=rows.dtype,
                      device=table.device).index_add_(0, seg, rows)
    if combiner == "mean":
        cnt = torch.zeros(num_bags, dtype=rows.dtype,
                          device=table.device).index_add_(
            0, seg, torch.ones_like(seg, dtype=rows.dtype))
        out = out / torch.clamp_min(cnt[:, None], 1.0)
    return out


def embedding_bag_max(table: torch.Tensor, flat_ids: torch.Tensor,
                      segment_ids: torch.Tensor,
                      num_bags: int) -> torch.Tensor:
    """Elementwise max over each ragged bag; an empty bag is -inf, the
    identity of ``jax.ops.segment_max``."""
    rows = table[flat_ids.to(torch.int64)]
    seg = segment_ids.to(torch.int64)[:, None].expand_as(rows)
    out = torch.full((num_bags, table.shape[1]), -torch.inf,
                     dtype=rows.dtype, device=table.device)
    return out.scatter_reduce_(0, seg, rows, reduce="amax",
                               include_self=True)


def _local_rows(ids: torch.Tensor, row_offset: int, v_local: int):
    """Global ids -> (local rows clipped into the block, whether each
    global id lies in this rank's rows)."""
    local = ids.to(torch.int64) - row_offset
    own = (local >= 0) & (local < v_local)
    return local.clamp(0, v_local - 1), own


def sharded_embedding_lookup(local_table: torch.Tensor, ids: torch.Tensor,
                             row_offset: int, group) -> torch.Tensor:
    """Row-sharded lookup on one rank.

    local_table (V_local, E): this rank's row range [row_offset,
    row_offset + V_local); ids (B, F) are *global* row indices.  Returns
    the full (B, F, E) gather, summed over ``group`` (an
    ``launch.mesh.AxisGroup``) with the cotangent passed through to each
    rank's rows."""
    from repro_torch.distributed.collectives import psum_forward

    local, own = _local_rows(ids, row_offset, local_table.shape[0])
    # F.embedding, as models/recsys.py::default_lookup gathers: its
    # backward sums a row's duplicates as the unsharded lookup's does
    rows = torch.nn.functional.embedding(local, local_table)
    return psum_forward(torch.where(own[..., None], rows, 0.0), group)


def sharded_bag(local_table: torch.Tensor, ids: torch.Tensor,
                weights: Optional[torch.Tensor], row_offset: int,
                group) -> torch.Tensor:
    """Row-sharded ``embedding_bag_fixed`` sum on one rank: the bag over
    the ids in this rank's rows (every other id INVALID), through the
    ``bag_lookup`` kernel, summed over ``group`` as
    :func:`sharded_embedding_lookup` sums."""
    from repro_torch.distributed.collectives import psum_forward

    local, own = _local_rows(ids, row_offset, local_table.shape[0])
    local = torch.where(own, local, -1).to(torch.int32)
    return psum_forward(BagLookup.apply(local_table, local, weights), group)


def sharded_history(local_table: torch.Tensor, ids: torch.Tensor,
                    row_offset: int, group):
    """Row-sharded :func:`history_lookup` on one rank: the history's rows
    and bag over the ids in this rank's rows (every other id INVALID), each
    summed over ``group`` as :func:`sharded_embedding_lookup` sums; the
    rank's table gradient is its rows' share, one ``bag_lookup_bwd``
    launch."""
    from repro_torch.distributed.collectives import psum_forward

    local, own = _local_rows(ids, row_offset, local_table.shape[0])
    local = torch.where(own, local, -1).to(torch.int32)
    rows, bag = history_lookup(local_table, local)
    return (psum_forward(rows, group),
            lambda weights: psum_forward(bag(weights), group))


def stack_vocab_offsets(vocab_sizes: Sequence[int]
                        ) -> tuple[int, torch.Tensor]:
    """Stack per-field tables into one big table: returns (V_total,
    offsets (F,) int32)."""
    off = np.zeros(len(vocab_sizes), dtype=np.int32)
    total = 0
    for i, v in enumerate(vocab_sizes):
        off[i] = total
        total += int(v)
    return total, torch.from_numpy(off)
