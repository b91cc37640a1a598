"""Batched RangeSearch (paper Algorithm 1): the public query driver over the
beam engine of :mod:`repro_torch.core.beam`.

:func:`range_search` resolves the beam-width / hop-limit / visited-size
defaults and runs the engine; :func:`search_graph` adds the shared medoid
seed.  Exploration queries (Sec. 6.7) pass ``exclude``: those vertices are
removed from the result list (and the radius) but stay traversable.

Over a compressed store (``quant/store.py``) the search is two-stage: the
beam traverses compressed distances, then :func:`exact_rerank` re-scores
its best ``rerank_k`` candidates against the exact float rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import beam
from .distances import get_metric
from .graph import DEGraph, INVALID


@dataclasses.dataclass(frozen=True)
class SearchResult:
    ids: torch.Tensor      # (B, k) int32, INVALID-padded
    dists: torch.Tensor    # (B, k) float32, inf-padded
    hops: torch.Tensor     # (B,) int32 — number of expanded vertices
    evals: torch.Tensor    # (B,) int32 — number of distance evaluations
    # (B,) float32 visited-table occupancy in [0, 1], or None when the
    # search ran the beam-broadcast dedup
    visited_frac: Optional[torch.Tensor] = None


def exact_rerank(exact_vectors: torch.Tensor, queries: torch.Tensor,
                 cand_ids: torch.Tensor, *, k: int, metric: str = "l2"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage two of the compressed search: re-score INVALID-padded (B, C)
    candidate ids exactly against the float rows and return the exact
    top-k (ids (B, k), dists (B, k)).  The sort is stable."""
    invalid = cand_ids == INVALID
    safe = torch.where(invalid, 0, cand_ids).to(torch.int64)
    d = get_metric(metric).pair(queries[:, None, :],
                                exact_vectors[safe].to(torch.float32))
    d = torch.where(invalid, float("inf"), d)
    order = torch.argsort(d, dim=1, stable=True)[:, :k]
    out_ids = torch.gather(cand_ids, 1, order)
    out_d = torch.gather(d, 1, order)
    out_ids = torch.where(torch.isinf(out_d), INVALID, out_ids)
    return out_ids, out_d


def range_search(graph: DEGraph, vectors, queries: torch.Tensor,
                 seed_ids: torch.Tensor, *, k: int, eps: float = 0.1,
                 beam_width: Optional[int] = None, max_hops: int = 0,
                 metric: str = "l2", exclude: Optional[torch.Tensor] = None,
                 rerank_k: int = 0,
                 exact_vectors: Optional[torch.Tensor] = None,
                 expand_width: int = 1,
                 visited_size: Optional[int] = None,
                 hop_backend: str = "composed",
                 hop_budget: Optional[torch.Tensor] = None) -> SearchResult:
    """Approximate k-NN for a batch of queries.

    Args:
      graph: the DEG to search.
      vectors: (capacity, m) float32 tensor (rows >= graph.n unused) or a
        :class:`repro_torch.quant.store.VectorStore`.
      queries: (B, m) float32.
      seed_ids: (B, S) int32 seed vertices, INVALID-padded.
      k: result count.
      eps: range-search slack factor (Alg. 1).
      beam_width: beam length L (defaults to a heuristic >= k).
      max_hops: bound on hop iterations (0 -> ``4 L + 64``).
      exclude: optional (B, X) int32 vertices excluded from results.
      rerank_k: two-stage search: take this many beam candidates and
        re-score them exactly against ``exact_vectors`` (needs
        ``rerank_k >= k``).  0 returns the store's own distances.
      exact_vectors: (capacity, m) float32 exact rows for the rerank.
      expand_width: E, beam entries expanded per lane per hop.
      visited_size: per-lane visited-set slots (power of two).  None picks
        ``beam.default_visited_size`` for the fused hop (which needs the
        filter) and 0 (the beam-broadcast dedup) otherwise.
      hop_backend: "composed" (``gather_dist`` per hop) or "fused" (the
        ``fused_hop`` kernel) on the host loop; both give the same
        results.  On the card the ``beam_search`` kernel takes either
        over every store (float32, fp16, sq8, pq) under l2 and
        sqeuclidean (``beam.search_kernel_eligible``); ip and cos and a
        lane too large for a block's shared memory keep the host loop.
      hop_budget: optional (B,) int32 per-lane expansion caps.
    """
    n_ex = exclude.shape[1] if exclude is not None else 0
    L = (beam_width if beam_width is not None
         else beam.default_beam_width(k, graph.degree, seed_ids.shape[1],
                                      n_ex))
    L = max(L, k, seed_ids.shape[1])
    if exclude is not None:
        L = max(L, k + n_ex)
    if rerank_k:
        if rerank_k < k:
            raise ValueError(f"rerank_k={rerank_k} must be >= k={k}")
        if exact_vectors is None:
            raise ValueError("rerank_k > 0 requires exact_vectors")
        L = max(L, rerank_k + n_ex)   # room for rerank_k non-excluded hits
    if max_hops <= 0:
        max_hops = beam.default_max_hops(L)
    if visited_size is None:
        visited_size = (beam.default_visited_size(L, graph.degree)
                        if hop_backend == "fused" else 0)
    # dropped visited inserts can (rarely) duplicate a beam entry; the
    # dedup in extract is the result-level guarantee
    dedup = visited_size > 0

    state = beam.beam_search(
        graph, vectors, queries, seed_ids, k=k, eps=eps, beam_width=L,
        max_hops=max_hops, metric=metric, exclude=exclude,
        expand_width=expand_width, visited_size=visited_size,
        hop_backend=hop_backend, hop_budget=hop_budget)
    if rerank_k:
        cand_ids, _ = beam.extract(state, rerank_k, dedup=dedup)
        out_ids, out_d = exact_rerank(exact_vectors, queries, cand_ids, k=k,
                                      metric=metric)
        evals = state.evals + (cand_ids != INVALID).sum(dim=1,
                                                        dtype=torch.int32)
    else:
        out_ids, out_d = beam.extract(state, k, dedup=dedup)
        evals = state.evals
    visited_frac = None
    if state.visited is not None:
        visited_frac = (state.visited != INVALID).to(torch.float32).mean(dim=1)
    return SearchResult(ids=out_ids, dists=out_d, hops=state.hops,
                        evals=evals, visited_frac=visited_frac)


def medoid_seed(vectors: torch.Tensor, n: int) -> int:
    """Approximate median vertex (paper Sec. 5.4 uses it as the seed)."""
    mean = torch.mean(vectors[:n], dim=0, keepdim=True)
    d = torch.linalg.norm(vectors[:n] - mean, dim=1)
    return int(torch.argmin(d))


def search_graph(graph: DEGraph, vectors: torch.Tensor,
                 queries: torch.Tensor, *, k: int, eps: float = 0.1,
                 seed: Optional[int] = None, beam_width: Optional[int] = None,
                 max_hops: int = 0, metric: str = "l2",
                 exclude: Optional[torch.Tensor] = None,
                 rerank_k: int = 0,
                 exact_vectors: Optional[torch.Tensor] = None,
                 expand_width: int = 1, visited_size: Optional[int] = None,
                 hop_backend: str = "composed") -> SearchResult:
    """Single shared seed (the medoid by default), otherwise the
    :func:`range_search` signature.  ``vectors`` is also the medoid's
    source: when a compressed store is searched with ``rerank_k``, pass the
    float rows as ``exact_vectors`` and an explicit ``seed``."""
    if seed is None:
        seed = medoid_seed(vectors, graph.n)
    seeds = torch.full((queries.shape[0], 1), seed, dtype=torch.int32,
                       device=queries.device)
    return range_search(graph, vectors, queries, seeds, k=k, eps=eps,
                        beam_width=beam_width, max_hops=max_hops,
                        metric=metric, exclude=exclude, rerank_k=rerank_k,
                        exact_vectors=exact_vectors,
                        expand_width=expand_width, visited_size=visited_size,
                        hop_backend=hop_backend)
