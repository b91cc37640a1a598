"""Plain PyTorch version of the gather + distance kernel."""
from __future__ import annotations

import torch


def gather_dist_ref(vectors: torch.Tensor, ids: torch.Tensor,
                    queries: torch.Tensor, squared: bool = False
                    ) -> torch.Tensor:
    """vectors (N, m), ids (B, d) clipped to [0, N), queries (B, m) ->
    (B, d) float32 l2 (or squared l2) distances."""
    safe = ids.clamp(0, vectors.shape[0] - 1).to(torch.int64)
    g = vectors[safe].to(torch.float32)                 # (B, d, m)
    diff = g - queries.to(torch.float32)[:, None, :]
    d2 = torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0)
    return d2 if squared else torch.sqrt(d2)
