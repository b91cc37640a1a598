"""Bucketed fixed-shape search programs — the one dispatch path under the
serving engine.

A flush of B requests is padded to the power-of-two bucket
``pow2_bucket(B, floor)``, so the engine runs at most ``len(buckets)``
batch shapes per search configuration: each bucket's first real flush
finds its kernels built and the allocator's blocks for its shapes cached
(:func:`precompile` runs one throwaway flush a bucket at boot).

* :func:`bucket_sizes` — the power-of-two batch buckets between
  ``floor`` and ``max_batch``;
* :class:`ProgramConfig` — the frozen per-engine search knobs (k/eps/L,
  codec + rerank, multi-expansion E/backend/visited) that, together with
  a bucket, name one program;
* :func:`pad_batch` — request list -> padded (queries, seeds, exclude)
  operands, exclude lanes bucketed to powers of two;
* :func:`dispatch` — the single ``DEGIndex.search_batch`` call site of
  ``QueryEngine.flush``.  **Bit-identity invariant**: per-lane results do
  not depend on batch composition (each lane of the search is
  independent), so buckets change padding, never semantics;
* :func:`precompile` — boot-time warmup of every bucket.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.graph import INVALID, pow2_bucket
from repro_torch.obs import clock

#: hop budget meaning "unlimited" for non-expired lanes in a budgeted
#: batch (any value above the engine's max_hops bound behaves as no cap)
NO_BUDGET = np.int32(2**31 - 1)


def bucket_sizes(max_batch: int, floor: int = 8) -> tuple[int, ...]:
    """Power-of-two batch buckets covering 1..max_batch flushes."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    floor = max(1, min(floor, max_batch))
    sizes = []
    b = pow2_bucket(floor)
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(pow2_bucket(max_batch))
    return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class ProgramConfig:
    """Everything (besides the batch bucket and the operand values) that
    names one search program.  Built once per engine from its constructor
    arguments / a ``configs.deg.SearchPreset``."""

    k: int = 10
    eps: float = 0.1
    beam_width: Optional[int] = None
    codec: str = "float32"
    rerank_k: Optional[int] = None
    expand_width: Optional[int] = None
    visited_size: Optional[int] = None
    hop_backend: Optional[str] = None

    @classmethod
    def from_preset(cls, preset_name: str, *, k: int = 10, eps: float = 0.1,
                    codec: str = "float32",
                    rerank_k: Optional[int] = None) -> "ProgramConfig":
        from repro_torch.configs.deg import SEARCH_PRESETS

        p = SEARCH_PRESETS[preset_name]
        return cls(k=k, eps=eps, beam_width=p.beam_width, codec=codec,
                   rerank_k=rerank_k, expand_width=p.expand_width,
                   visited_size=p.visited_size, hop_backend=p.hop_backend)


@dataclasses.dataclass
class BatchItem:
    """One request as the dispatch layer sees it: the query vector, the
    already-resolved exclude ids (session history, seed included when the
    protocol wants it hidden), and an optional seed vertex (None = the
    index medoid)."""

    query: np.ndarray
    exclude: Sequence[int] = ()
    seed_vertex: Optional[int] = None


def pad_batch(items: Sequence[BatchItem], bucket: int, medoid: int,
              exclude_floor: int = 8
              ) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Request list -> fixed-shape (queries, seeds, exclude) operands.

    Queries are padded to ``bucket`` lanes (pad lanes repeat the first
    query — any in-bounds value; their results are discarded).  A batch
    with no exclusions passes ``exclude=None`` (the exclusion-free
    search); otherwise the exclude width is the batch's need bucketed to
    a power of two above ``exclude_floor``, so one long session never
    permanently widens later flushes."""
    B = len(items)
    if not (0 < B <= bucket):
        raise ValueError(f"batch size {B} does not fit bucket {bucket}")
    qs = np.stack([np.asarray(it.query, np.float32) for it in items]
                  + [np.asarray(items[0].query, np.float32)] * (bucket - B))
    seeds = np.full((bucket, 1), medoid, np.int32)
    max_ex = max((len(it.exclude) for it in items), default=0)
    excl = None
    if max_ex:
        xw = pow2_bucket(max_ex, floor=max(1, exclude_floor))
        excl = np.full((bucket, xw), INVALID, np.int32)
    for i, it in enumerate(items):
        if it.seed_vertex is not None:
            seeds[i, 0] = it.seed_vertex
        if it.exclude:
            excl[i, : len(it.exclude)] = list(it.exclude)
    return qs, seeds, excl


def dispatch(index, cfg: ProgramConfig, qs: np.ndarray, seeds: np.ndarray,
             excl: Optional[np.ndarray],
             hop_budget: Optional[np.ndarray] = None):
    """The one ``search_batch`` call site the engine flushes through.
    ``index`` is whatever ``DEGIndex.acquire_view()`` returned."""
    return index.search_batch(
        qs, seeds, excl, k=cfg.k, eps=cfg.eps, beam_width=cfg.beam_width,
        quantized=None if cfg.codec == "float32" else cfg.codec,
        rerank_k=cfg.rerank_k, expand_width=cfg.expand_width,
        visited_size=cfg.visited_size, hop_backend=cfg.hop_backend,
        hop_budget=hop_budget)


def precompile(index, cfg: ProgramConfig, buckets: Sequence[int], *,
               with_budget: bool = False) -> dict[tuple, float]:
    """Warm every (bucket[, budgeted]) program before traffic arrives.

    Runs one throwaway flush per shape family and waits for it on the
    device (``torch.cuda.synchronize`` on a CUDA index), so the kernel
    builds and the allocator's first blocks for each shape are paid at
    boot, not by the first request of each bucket.  Returns
    ``{(bucket, variant): seconds}`` wall times.  ``with_budget`` also
    runs the variant with a per-lane ``hop_budget`` operand."""
    import torch

    dim = index.dim
    medoid = index.medoid()
    dev = index.device
    times: dict[tuple, float] = {}
    variants = [("plain", False)]
    if with_budget:
        variants.append(("budget", True))
    for b in buckets:
        items = [BatchItem(query=np.zeros(dim, np.float32))] * b
        qs, seeds, excl = pad_batch(items, b, medoid)
        for name, budgeted in variants:
            budget = np.full(b, NO_BUDGET, np.int32) if budgeted else None
            t0 = clock.now()
            dispatch(index, cfg, qs, seeds, excl, hop_budget=budget)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times[(b, name)] = clock.now() - t0
    return times
