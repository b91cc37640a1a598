"""Plain PyTorch versions of the embedding-bag kernel and its gradient."""
from __future__ import annotations

import torch


def bag_lookup_ref(table: torch.Tensor, ids: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """table (V, E), ids (B, F) in [0, V), weights (B, F) -> (B, E) float32
    ``sum_f weights[b, f] * table[ids[b, f]]``: a gather, then a weighted
    float32 sum over F."""
    rows = table[ids.to(torch.int64)].to(torch.float32)        # (B, F, E)
    return torch.sum(rows * weights.to(torch.float32)[..., None], dim=1)


def grad_w_ref(table: torch.Tensor, ids: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """(B, F): the dot product of each entry's row ``table[clip(ids, 0,
    V-1)]`` with ``g[b]``, 0 at an invalid (< 0) id."""
    V = table.shape[0]
    safe = ids.clamp(0, V - 1).to(torch.int64)
    dots = (table[safe] * g.to(table.dtype)[:, None, :]).sum(-1)
    return torch.where(ids >= 0, dots, 0.0)


def bwd_order_ref(ids: torch.Tensor, n_rows: int,
                  weights: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor,
                             torch.Tensor | None, torch.Tensor]:
    """The backward's index preparation: the valid entries (ids >= 0) of
    (B, F) ids sorted by their key ``clip(ids, max=n_rows - 1)``, stably
    (a ``torch.sort``): ``(keys, pos, w, count)`` with ``keys`` and ``pos``
    (the entry's place ``b * F + f``) int32, ``w`` the entries' weights in
    that order (None without weights) and ``count`` (1,) int32 their
    number.  An invalid entry is left out."""
    flat = ids.reshape(-1)
    pos = torch.nonzero(flat >= 0).reshape(-1)
    keys, idx = torch.sort(flat[pos].clamp(max=n_rows - 1), stable=True)
    pos = pos[idx]
    w = None if weights is None else \
        weights.reshape(-1)[pos].to(torch.float32)
    count = torch.tensor([pos.numel()], dtype=torch.int32, device=ids.device)
    return keys.to(torch.int32), pos.to(torch.int32), w, count


def table_grad_ref(table: torch.Tensor, ids: torch.Tensor,
                   weights: torch.Tensor | None, g: torch.Tensor | None,
                   G: torch.Tensor | None) -> torch.Tensor:
    """(V, E) float32: ``index_add_`` into each valid entry's row
    ``clip(ids, 0, V-1)`` of its sum ``G[b, f] + w[b, f] * g[b]`` (w = 1
    where ``weights`` is None; a term left out where ``G`` or ``g`` is
    None), in entry order.  An invalid entry adds nothing."""
    V, E = table.shape
    B, F = ids.shape
    terms = torch.zeros((B, F, E), dtype=torch.float32, device=ids.device) \
        if G is None else G.to(torch.float32)
    if g is not None:
        w = torch.ones((B, F), dtype=torch.float32, device=ids.device) \
            if weights is None else weights.to(torch.float32)
        terms = terms + w[..., None] * g.to(torch.float32)[:, None, :]
    valid = (ids >= 0).reshape(-1)
    safe = ids.clamp(0, V - 1).reshape(-1).to(torch.int64)
    return torch.zeros((V, E), dtype=torch.float32,
                       device=ids.device).index_add_(
        0, safe[valid], terms.reshape(-1, E)[valid])


def bag_lookup_bwd_ref(table: torch.Tensor, ids: torch.Tensor,
                       weights: torch.Tensor | None, g: torch.Tensor,
                       G: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``sum_f w[b, f] * table[clip(ids[b, f], 0, V-1)]``
    with ``w = 0`` where ``ids < 0`` (``w = 1`` where ``weights`` is None),
    given ``g`` = dL/dout (B, E), and, with ``G`` (B, F, E), of the gather
    ``table[clip(ids)]`` (0 at an invalid id) whose cotangent ``G`` is:
    ``(grad_w (B, F), grad_table (V, E))``.  ``grad_w`` is
    :func:`grad_w_ref`, ``grad_table`` :func:`table_grad_ref`."""
    return (grad_w_ref(table, ids, g),
            table_grad_ref(table, ids, weights, g, G).to(table.dtype))
