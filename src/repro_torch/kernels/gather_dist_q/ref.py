"""Plain PyTorch version of the gather + dequantize + distance kernel."""
from __future__ import annotations

import torch


def gather_dist_q_ref(codes: torch.Tensor, scale: torch.Tensor,
                      ids: torch.Tensor, queries: torch.Tensor,
                      squared: bool = False) -> torch.Tensor:
    """codes (N, m) int8, scale (m,) float32, ids (B, d) clipped to
    [0, N), queries (B, m) float32 -> (B, d) float32 l2 (or squared l2)
    distances to the dequantized rows ``code * scale``."""
    safe = ids.clamp(0, codes.shape[0] - 1).to(torch.int64)
    g = codes[safe].to(torch.float32) * scale[None, None, :]   # (B, d, m)
    diff = g - queries.to(torch.float32)[:, None, :]
    d2 = torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0)
    return d2 if squared else torch.sqrt(d2)
