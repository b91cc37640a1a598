"""Plain PyTorch version of the fused L2 + top-k kernel: the expansion
form over the whole (B, N) matrix, then the k smallest with ties to the
lower id (a stable sort, as ``lax.top_k`` orders ties)."""
from __future__ import annotations

import torch


def l2_topk_ref(queries: torch.Tensor, base: torch.Tensor, k: int,
                squared: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (B, m), base (N, m) -> (dists (B, k) float32 ascending,
    ids (B, k) int32); distances ``max(|q|^2 - 2 q.x + |x|^2, 0)``, their
    sqrt unless ``squared``.  The product runs in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q = queries.to(torch.float32)
    x = base.to(torch.float32)
    qn = torch.sum(q * q, dim=1, keepdim=True)
    xn = torch.sum(x * x, dim=1)
    d2 = torch.clamp_min(qn - 2.0 * (q @ x.T) + xn[None, :], 0.0)
    d = d2 if squared else torch.sqrt(d2)
    d, ids = torch.sort(d, dim=1, stable=True)
    return d[:, :k], ids[:, :k].to(torch.int32)
