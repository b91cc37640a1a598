"""Batched RangeSearch (paper Algorithm 1): the public query driver over the
beam engine of :mod:`repro_torch.core.beam`.

:func:`range_search` resolves the beam-width / hop-limit / visited-size
defaults and runs the engine; :func:`search_graph` adds the shared medoid
seed.  Exploration queries (Sec. 6.7) pass ``exclude``: those vertices are
removed from the result list (and the radius) but stay traversable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import beam
from .graph import DEGraph, INVALID

_PENDING = ("the exact rerank comes with the compressed stores "
            "(ROADMAP queue A6)")


@dataclasses.dataclass(frozen=True)
class SearchResult:
    ids: torch.Tensor      # (B, k) int32, INVALID-padded
    dists: torch.Tensor    # (B, k) float32, inf-padded
    hops: torch.Tensor     # (B,) int32 — number of expanded vertices
    evals: torch.Tensor    # (B,) int32 — number of distance evaluations
    # (B,) float32 visited-table occupancy in [0, 1], or None when the
    # search ran the beam-broadcast dedup
    visited_frac: Optional[torch.Tensor] = None


def exact_rerank(*args, **kwargs):
    raise NotImplementedError(_PENDING)


def range_search(graph: DEGraph, vectors, queries: torch.Tensor,
                 seed_ids: torch.Tensor, *, k: int, eps: float = 0.1,
                 beam_width: Optional[int] = None, max_hops: int = 0,
                 metric: str = "l2", exclude: Optional[torch.Tensor] = None,
                 rerank_k: int = 0, expand_width: int = 1,
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
      rerank_k: must be 0 until the compressed stores are ported.
      expand_width: E, beam entries expanded per lane per hop.
      visited_size: per-lane visited-set slots (power of two).  None picks
        ``beam.default_visited_size`` for the fused hop (which needs the
        filter) and 0 (the beam-broadcast dedup) otherwise.
      hop_backend: "composed" (``gather_dist`` per hop) or "fused" (the
        ``fused_hop`` kernel); both give the same results.
      hop_budget: optional (B,) int32 per-lane expansion caps.
    """
    if rerank_k:
        raise NotImplementedError(_PENDING)
    n_ex = exclude.shape[1] if exclude is not None else 0
    L = (beam_width if beam_width is not None
         else beam.default_beam_width(k, graph.degree, seed_ids.shape[1],
                                      n_ex))
    L = max(L, k, seed_ids.shape[1])
    if exclude is not None:
        L = max(L, k + n_ex)
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
    out_ids, out_d = beam.extract(state, k, dedup=dedup)
    visited_frac = None
    if state.visited is not None:
        visited_frac = (state.visited != INVALID).to(torch.float32).mean(dim=1)
    return SearchResult(ids=out_ids, dists=out_d, hops=state.hops,
                        evals=state.evals, visited_frac=visited_frac)


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
                 expand_width: int = 1, visited_size: Optional[int] = None,
                 hop_backend: str = "composed") -> SearchResult:
    """Single shared seed (the medoid by default), otherwise the
    :func:`range_search` signature."""
    if seed is None:
        seed = medoid_seed(vectors, graph.n)
    seeds = torch.full((queries.shape[0], 1), seed, dtype=torch.int32,
                       device=queries.device)
    return range_search(graph, vectors, queries, seeds, k=k, eps=eps,
                        beam_width=beam_width, max_hops=max_hops,
                        metric=metric, exclude=exclude,
                        expand_width=expand_width, visited_size=visited_size,
                        hop_backend=hop_backend)
