"""The vector store the beam engine traverses.

Only the exact ``float32`` store exists in the port so far.  The
compressed codecs (fp16, sq8, pq) and the two-stage exact rerank come with
ROADMAP queue A6; asking for one raises ``NotImplementedError``.

On the card, l2 and squared-l2 neighbor distances go through the
``gather_dist`` CUDA kernel; the inner-product and cosine metrics take the
plain gather + pair path, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch

_PENDING = "only the float32 store is ported; compressed codecs are ROADMAP queue A6"


@dataclasses.dataclass(frozen=True)
class VectorStore:
    """Vector rows behind one distance interface (exact float32)."""

    data: torch.Tensor    # (capacity, m) float32
    codec: str = "float32"

    def __post_init__(self):
        if self.codec != "float32":
            raise NotImplementedError(f"codec {self.codec!r}: {_PENDING}")

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather rows by id.  Ids are clipped to ``[0, capacity)``: callers
        mask INVALID (-1) lanes after the distance."""
        safe = ids.clamp(0, self.capacity - 1)
        return self.data[safe.to(torch.int64)]

    def neighbor_distances(self, queries: torch.Tensor, nbr_ids: torch.Tensor,
                           metric_name: str) -> torch.Tensor:
        """dist(q_b, row ids[b, j]) for (B, d) ids -> (B, d)."""
        from repro_torch.core.distances import get_metric
        from repro_torch.kernels.gather_dist import ops as gd_ops

        if metric_name in ("l2", "sqeuclidean"):
            return gd_ops.gather_dist(self.data, nbr_ids, queries,
                                      squared=metric_name == "sqeuclidean")
        return get_metric(metric_name).pair(queries[:, None, :],
                                            self.decode(nbr_ids))


def as_store(vectors) -> VectorStore:
    """Raw float tensors become exact float32 stores; stores pass through."""
    if isinstance(vectors, VectorStore):
        return vectors
    return VectorStore(data=vectors)
