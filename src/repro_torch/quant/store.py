"""The vector store the beam engine traverses.

:class:`VectorStore` sits between ``core/graph.py`` (topology) and
``core/beam.py`` (traversal): the engine asks the store for seed and
neighbor distances and never touches a raw ``(n, m)`` tensor.  Four views
behind one interface:

* ``float32`` — the exact store; ``decode`` is the identity;
* ``fp16`` — half-precision rows, gathered at half width and upcast in the
  ``gather_dist`` kernel;
* ``sq8`` — int8 codes and a per-dimension scale, scored by the
  ``gather_dist_q`` kernel on the host loop, which dequantizes in
  registers; inside ``beam_search`` by the same row function when that
  kernel takes the search (``core/beam.py::search_kernel_eligible``);
* ``pq`` — uint8 codes (one byte per subspace) and shared
  ``(m_sub, 256, dsub)`` codebooks, scored by the ``pq_adc`` kernel on
  the host loop, which never decodes; inside ``beam_search`` when that
  kernel takes the search (``core/beam.py::search_kernel_eligible``),
  from a table built once a search.

On the card, l2 and squared-l2 neighbor distances of the host loop go
through those kernels; the inner-product and cosine metrics take
``decode`` and the metric's ``pair``, as in the JAX package.  A CPU tensor takes each
kernel's plain version.  The kernels are called through their modules
(``gdq_ops.gather_dist_q``), so that a caller can swap a module's function.

The store does not hold the exact rows the two-stage search reranks
against: those stay with the index owner (``DEGIndex._dev_vectors``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import codec as C
from . import pq as PQ


@dataclasses.dataclass(frozen=True)
class VectorStore:
    """Encoded vector rows and their dequantization state."""

    data: torch.Tensor     # (capacity, m) f32/f16/int8, or (capacity, m_sub) uint8
    #: (m,) float32 sq8 dequantization scale; None for every other codec
    scale: Optional[torch.Tensor] = None
    codec: str = "float32"
    #: (m_sub, 256, dsub) float32 k-means codebooks, pq only
    codebooks: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.codec not in C.CODECS:
            raise ValueError(f"unknown codec {self.codec!r} "
                             f"(have {sorted(C.CODECS)})")
        if (self.codec == "pq") != (self.codebooks is not None):
            raise ValueError("codebooks are given with the pq codec and only "
                             "with it")
        if (self.codec == "sq8") != (self.scale is not None):
            raise ValueError("a scale is given with the sq8 codec and only "
                             "with it")

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        if self.codec == "pq":      # rows hold m_sub code bytes, not m
            m_sub, _, dsub = self.codebooks.shape
            return m_sub * dsub
        return self.data.shape[1]

    @property
    def exact(self) -> bool:
        return self.codec == "float32"

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather rows by id and decode them to float32.  Ids are clipped to
        ``[0, capacity)``: callers mask INVALID (-1) lanes after the
        distance."""
        safe = ids.clamp(0, self.capacity - 1).to(torch.int64)
        if self.codec == "pq":
            return PQ.decode(self.data[safe], self.codebooks)
        return C.decode(self.codec, self.data[safe], self.scale)

    def neighbor_distances(self, queries: torch.Tensor, nbr_ids: torch.Tensor,
                           metric_name: str) -> torch.Tensor:
        """dist(q_b, decode(row ids[b, j])) for (B, d) ids -> (B, d)."""
        from repro_torch.core.distances import get_metric
        from repro_torch.kernels.gather_dist import ops as gd_ops
        from repro_torch.kernels.gather_dist_q import ops as gdq_ops
        from repro_torch.kernels.pq_adc import ops as adc_ops

        if metric_name in ("l2", "sqeuclidean"):
            squared = metric_name == "sqeuclidean"
            if self.codec == "sq8":
                return gdq_ops.gather_dist_q(self.data, self.scale, nbr_ids,
                                             queries, squared=squared)
            if self.codec == "pq":
                return adc_ops.pq_adc(self.data, self.codebooks, nbr_ids,
                                      queries, squared=squared)
            return gd_ops.gather_dist(self.data, nbr_ids, queries,
                                      squared=squared)
        return get_metric(metric_name).pair(queries[:, None, :],
                                            self.decode(nbr_ids))

    def memory_bytes(self, n=None) -> int:
        """Store bytes of ``n`` rows (default: the capacity) plus the
        codec's calibration state."""
        rows = self.capacity if n is None else int(n)
        return C.store_bytes(self.codec, rows, self.dim)


def make_store(vectors: torch.Tensor, codec: str = "float32", *,
               n: Optional[int]) -> VectorStore:
    """Encode ``vectors`` under ``codec``.

    ``n``, the live-row count, is a required keyword: sq8 scales and pq
    codebooks must be calibrated on the live vertices only, never on
    capacity padding.  Pass ``n=None`` only when every row is live.  pq's
    codebooks are fit on the host (numpy) from ``vectors[:n]``."""
    if codec not in C.CODECS:
        raise ValueError(f"unknown codec {codec!r} (have {sorted(C.CODECS)})")
    if codec == "pq":
        rows = vectors if n is None else vectors[: int(n)]
        books = torch.as_tensor(PQ.fit(rows.cpu().numpy()),
                                device=vectors.device)
        return VectorStore(data=PQ.encode(vectors, books), codec=codec,
                           codebooks=books)
    scale = C.calibrate_sq8_scale(vectors, n) if codec == "sq8" else None
    return VectorStore(data=C.encode(codec, vectors, scale), scale=scale,
                       codec=codec)


def as_store(vectors) -> VectorStore:
    """Raw float tensors become exact float32 stores; stores pass through."""
    if isinstance(vectors, VectorStore):
        return vectors
    return VectorStore(data=vectors)
