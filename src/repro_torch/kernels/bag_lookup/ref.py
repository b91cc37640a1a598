"""Plain PyTorch version of the embedding-bag kernel."""
from __future__ import annotations

import torch


def bag_lookup_ref(table: torch.Tensor, ids: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """table (V, E), ids (B, F) in [0, V), weights (B, F) -> (B, E) float32
    ``sum_f weights[b, f] * table[ids[b, f]]``: a gather, then a weighted
    float32 sum over F."""
    rows = table[ids.to(torch.int64)].to(torch.float32)        # (B, F, E)
    return torch.sum(rows * weights.to(torch.float32)[..., None], dim=1)
