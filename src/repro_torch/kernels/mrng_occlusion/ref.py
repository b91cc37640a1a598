"""Plain PyTorch version of the gather + distance + MRNG-occlusion kernel."""
from __future__ import annotations

import torch


def mrng_occlusion_ref(vectors: torch.Tensor, nbr_ids: torch.Tensor,
                       queries: torch.Tensor, cand_dists: torch.Tensor,
                       nbr_weights: torch.Tensor, *, metric: str = "l2"):
    """vectors (N, m), nbr_ids (B, K, d) clipped to [0, N), queries (B, m),
    cand_dists (B, K), nbr_weights (B, K, d) -> (nbr_dist (B, K, d) float32,
    occl (B, K, d) bool) with ``occl = cand_d > max(nbr_dist, w)``."""
    from repro_torch.core.distances import get_metric

    safe = nbr_ids.clamp(0, vectors.shape[0] - 1).to(torch.int64)
    g = vectors[safe].to(torch.float32)                    # (B, K, d, m)
    nd = get_metric(metric).pair(
        queries.to(torch.float32)[:, None, None, :], g)
    occ = cand_dists[:, :, None] > torch.maximum(nd, nbr_weights)
    return nd, occ
