"""Distance functions for DEG (paper Sec. 2.1: a generic metric ``delta``).

Edge weights store the actual metric value (not e.g. squared L2): the
edge-optimization gains (Sec. 5.3) are sums of distances.

Every float32 matrix product here runs in full float32: TF32 is switched
off before each one, so ``cross`` keeps the digits the JAX package keeps.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

_METRICS: dict[str, "Metric"] = {}


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Metric:
    """A distance with pointwise, one-to-many and many-to-many forms."""

    def __init__(self, name: str, pair: Callable):
        self.name = name
        self._pair = pair
        _METRICS[name] = self

    def pair(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """delta(x, y) for x: (..., m), y: (..., m) broadcast together."""
        return self._pair(x, y)

    def one_to_many(self, q: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        """delta(q, xs[i]): q (m,), xs (n, m) -> (n,)."""
        return self._pair(q[None, :], xs)

    def cross(self, qs: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        """Full distance matrix: qs (b, m), xs (n, m) -> (b, n), in the
        expanded matrix-product form ``|q|^2 - 2 q.x + |x|^2``."""
        _no_tf32()
        if self.name in ("l2", "sqeuclidean"):
            qn = torch.sum(qs * qs, dim=-1, keepdim=True)   # (b, 1)
            xn = torch.sum(xs * xs, dim=-1)                 # (n,)
            sq = torch.clamp_min(qn - 2.0 * (qs @ xs.T) + xn[None, :], 0.0)
            return sq if self.name == "sqeuclidean" else torch.sqrt(sq)
        if self.name == "ip":
            return -(qs @ xs.T)
        if self.name == "cos":
            return 1.0 - _unit(qs) @ _unit(xs).T
        raise NotImplementedError(self.name)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                               1e-12)


def _l2(x, y):
    d = x - y
    return torch.sqrt(torch.clamp_min(torch.sum(d * d, dim=-1), 0.0))


def _sql2(x, y):
    d = x - y
    return torch.clamp_min(torch.sum(d * d, dim=-1), 0.0)


def _ip(x, y):
    return -torch.sum(x * y, dim=-1)


def _cos(x, y):
    return 1.0 - torch.sum(_unit(x) * _unit(y), dim=-1)


L2 = Metric("l2", _l2)
SQEUCLIDEAN = Metric("sqeuclidean", _sql2)
IP = Metric("ip", _ip)
COS = Metric("cos", _cos)


def get_metric(name: str) -> Metric:
    try:
        return _METRICS[name]
    except KeyError:
        raise ValueError(f"unknown metric {name!r}; have {sorted(_METRICS)}") from None


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if isinstance(x, np.ndarray)
                           else x, device=device)


def exact_knn(queries, base, k: int, metric: str = "l2", device="cuda"):
    """Exact k-NN (ground truth).  Returns (dists, ids) tensors; ties go to
    the lower id, as with ``lax.top_k``."""
    q, x = _on(queries, device), _on(base, device)
    dmat = get_metric(metric).cross(q, x)
    d, ids = torch.sort(dmat, dim=1, stable=True)
    return d[:, :k], ids[:, :k].to(torch.int32)


def exact_knn_batched(queries, base, k: int, metric: str = "l2",
                      tile: int = 8192, device="cuda"):
    """Tiled exact k-NN for large bases: bounds the (b, n) matrix to
    (b, tile).  Returns host numpy (dists, ids)."""
    q, x = _on(queries, device), _on(base, device)
    n = x.shape[0]
    best_d = best_i = None
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        d, i = exact_knn(q, x[lo:hi], min(k, hi - lo), metric, device)
        i = i + lo
        if best_d is None:
            best_d, best_i = d, i
        else:
            cat_d = torch.cat([best_d, d], dim=1)
            cat_i = torch.cat([best_i, i], dim=1)
            order = torch.argsort(cat_d, dim=1, stable=True)[:, :k]
            best_d = torch.gather(cat_d, 1, order)
            best_i = torch.gather(cat_i, 1, order)
    return best_d.cpu().numpy(), best_i.cpu().numpy()
