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


def bag_lookup_bwd_ref(table: torch.Tensor, ids: torch.Tensor,
                       weights: torch.Tensor | None, g: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``sum_f w[b, f] * table[clip(ids[b, f], 0, V-1)]``
    with ``w = 0`` where ``ids < 0`` (``w = 1`` where ``weights`` is None),
    given ``g`` = dL/dout (B, E); ids as the wrapper takes them, invalid
    and out-of-range ones included.  Returns ``(grad_w (B, F), grad_table
    (V, E))`` in the table's type: ``grad_w[b, f]`` is the dot product of
    the clipped row with ``g[b]`` (0 at an invalid id), and ``grad_table``
    is the dense scatter-add (``index_add_``) of ``w[b, f] * g[b]`` into
    each entry's clipped row, in entry order."""
    V, E = table.shape
    dt = table.dtype
    valid = ids >= 0
    safe = ids.clamp(0, V - 1).to(torch.int64)
    g = g.to(dt)
    w = valid.to(dt) if weights is None else \
        torch.where(valid, weights.to(dt), 0.0)
    grad_w = torch.where(valid, (table[safe] * g[:, None, :]).sum(-1), 0.0)
    grad_table = torch.zeros_like(table).index_add_(
        0, safe.reshape(-1), (w[..., None] * g[:, None, :]).reshape(-1, E))
    return grad_w, grad_table
