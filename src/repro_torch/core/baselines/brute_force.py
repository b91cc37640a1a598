"""Exact serial-scan baseline (the paper uses FAISS's serial scan, Sec. 6.3).

Ground truth for every recall computation.  ``backend="torch"`` is the
expansion form of ``core/distances.py`` (``exact_knn`` /
``exact_knn_batched``, any metric); ``backend="kernel"`` is the fused
``l2_topk`` kernel (l2 only; another metric takes the torch path).  The
JAX package names the two ``"jnp"`` and ``"pallas"``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..distances import exact_knn, exact_knn_batched


class BruteForceIndex:
    def __init__(self, vectors: np.ndarray, metric: str = "l2",
                 device="cuda"):
        self.vectors = np.asarray(vectors, dtype=np.float32)
        self.metric = metric
        self.device = torch.device(device)
        self._dev_vectors = torch.as_tensor(self.vectors, device=self.device)

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    def search(self, queries: np.ndarray, k: int, tile: int = 8192,
               backend: str = "torch") -> tuple[np.ndarray, np.ndarray]:
        """Exact k-NN of each query: host (dists (B, k), ids (B, k)),
        ascending, ties to the lower id."""
        if backend not in ("torch", "kernel"):
            raise ValueError(f"unknown backend {backend!r}")
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                            device=self.device)
        if backend == "kernel" and self.metric == "l2":
            from repro_torch.kernels.l2_topk import ops as l2_ops

            d, i = l2_ops.l2_topk(q, self._dev_vectors, k)
            return d.cpu().numpy(), i.cpu().numpy()
        if self.n <= tile:
            d, i = exact_knn(q, self._dev_vectors, k, self.metric,
                             self.device)
            return d.cpu().numpy(), i.cpu().numpy()
        return exact_knn_batched(q, self._dev_vectors, k, self.metric, tile,
                                 self.device)
