"""Batched ANN query engine (the production face of the paper's system).

``QueryEngine`` fronts a :class:`repro_torch.core.build.DEGIndex` with:

* **request batching**: incoming queries are buffered and flushed as one
  search over a power-of-two bucket of lanes (``serving/buckets.py``); on
  the card an l2 flush is one ``beam_search`` launch;
* **exploration sessions**: per-user exclude lists implement the paper's
  browsing protocol (§6.7) — results the user has seen never reappear, while
  navigation may still pass through them;
* **online inserts and deletes**: new vectors are added through the
  incremental build path (Alg. 3) and are searchable on the next flush;
  a delete compacts slots and remaps the sessions;
* **continuous refinement**: ``refine_budget`` edge-optimization iterations
  (Alg. 5) run between flushes;
* **compressed serving**: ``codec="fp16"|"sq8"|"pq"`` makes every flush
  traverse the compressed store, with the exact two-stage rerank of
  ``rerank_k`` candidates;
* **observability**: request, flush, hop and eval counters and latency
  histograms (per bucket) in an ``obs.MetricsRegistry``, and a sampled
  query log;
* **persistence**: :meth:`QueryEngine.from_snapshot` serves a restored
  index; :meth:`QueryEngine.save` snapshots the served one.

A flush reads ids, distances, hops, evals and the visited-table occupancy
back in one device-to-host copy (:func:`to_host`).

One difference from the JAX package's sync engine: a request's seed
vertex is hidden from its own results when the request belongs to an
exploration session (``explore``, or ``submit`` with a session), as both
packages do; a bare ``submit(q, seed_vertex=v)`` searches from ``v``
without hiding it, as the JAX package's async engine and its query-log
golden record (``tests/data/querylog_golden.jsonl``) do, where the JAX
sync engine hides it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.build import DEGIndex
from repro_torch.core.graph import INVALID
from repro_torch.obs import clock
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.querylog import LATENCY_METRIC, QueryLogWriter, make_record
from repro_torch.obs.trace import Sampler
from repro_torch.serving import buckets as _buckets


@dataclasses.dataclass
class EngineStats:
    flushes: int = 0
    queries: int = 0
    inserts: int = 0
    refine_iterations: int = 0   # improved EDGES (refine's return unit)
    total_search_s: float = 0.0

    @property
    def qps(self) -> float:
        return self.queries / self.total_search_s if self.total_search_s else 0.0


def to_host(res) -> tuple:
    """(ids, dists, hops, evals, visited_frac) of a ``SearchResult`` as
    numpy arrays, in one device-to-host copy: the float fields travel as
    their int32 bit patterns inside one int32 tensor.  ``visited_frac`` is
    None when the search kept no visited table."""
    B, k = res.ids.shape
    parts = [res.ids.to(torch.int32).reshape(-1),
             res.dists.to(torch.float32).contiguous().view(torch.int32
                                                           ).reshape(-1),
             res.hops.to(torch.int32).reshape(-1),
             res.evals.to(torch.int32).reshape(-1)]
    if res.visited_frac is not None:
        parts.append(res.visited_frac.to(torch.float32).contiguous()
                     .view(torch.int32).reshape(-1))
    flat = torch.cat(parts).cpu().numpy()
    ids = flat[: B * k].reshape(B, k)
    dists = flat[B * k : 2 * B * k].view(np.float32).reshape(B, k)
    hops = flat[2 * B * k : 2 * B * k + B]
    evals = flat[2 * B * k + B : 2 * B * k + 2 * B]
    vfrac = (None if res.visited_frac is None
             else flat[2 * B * k + 2 * B :].view(np.float32))
    return ids, dists, hops, evals, vfrac


class QueryEngine:
    def __init__(self, index: DEGIndex, *, k: int = 10, eps: float = 0.1,
                 max_batch: int = 64, bucket_floor: int = 8,
                 refine_budget: int = 0,
                 beam_width: Optional[int] = None, exclude_width: int = 8,
                 codec: str = "float32", rerank_k: Optional[int] = None,
                 expand_width: Optional[int] = None,
                 visited_size: Optional[int] = None,
                 hop_backend: Optional[str] = None,
                 preset: Optional[str] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 trace_sample: float = 0.0,
                 query_log: Optional[QueryLogWriter] = None):
        """``codec`` picks the vector store the beam traverses for this
        engine ("float32" exact | "fp16" | "sq8" | "pq"); compressed
        codecs run the two-stage search (exact rerank of ``rerank_k``
        candidates, default ``4 * k``).  Engines over the same index may
        choose different codecs — the index caches one store per codec.

        ``expand_width`` / ``visited_size`` / ``hop_backend`` configure the
        multi-expansion engine for this engine's flushes (None = inherit
        the index's ``DEGParams`` knobs).  ``preset`` names a
        ``configs.deg.SEARCH_PRESETS`` entry supplying those knobs (plus
        ``beam_width``) wholesale; explicit arguments win.

        Flushes of fewer than ``max_batch`` queries are padded to the
        power-of-two bucket >= ``bucket_floor`` that fits them
        (``serving/buckets.py``).  A registry is always present (the
        engine owns one by default); ``trace_sample`` is the share of
        queries written to ``query_log``."""
        from repro_torch.quant.codec import CODECS

        if codec not in CODECS:
            raise ValueError(f"unknown codec {codec!r} "
                             f"(have {sorted(CODECS)})")
        if preset is not None:
            from repro_torch.configs.deg import SEARCH_PRESETS

            p = SEARCH_PRESETS[preset]
            expand_width = p.expand_width if expand_width is None \
                else expand_width
            hop_backend = p.hop_backend if hop_backend is None \
                else hop_backend
            visited_size = p.visited_size if visited_size is None \
                else visited_size
            beam_width = p.beam_width if beam_width is None else beam_width
        self.index = index
        self.k, self.eps, self.beam_width = k, eps, beam_width
        self.codec, self.rerank_k = codec, rerank_k
        self.expand_width = expand_width
        self.visited_size = visited_size
        self.hop_backend = hop_backend
        self.max_batch = max_batch
        self.refine_budget = refine_budget
        self.stats = EngineStats()
        # metric objects are resolved once here: flush() never touches the
        # registry dict
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._sampler = Sampler(trace_sample)
        self._query_log = query_log
        self._qid = 0                     # submit order, the log's qid key
        self._m_queries = self.metrics.counter("serving_requests_total")
        self._m_flushes = self.metrics.counter("serving_flushes_total")
        self._m_hops = self.metrics.counter("serving_hops_total")
        self._m_evals = self.metrics.counter("serving_evals_total")
        # request latency of the closed-loop engine is the flush that
        # served it, observed per request
        self._m_latency = self.metrics.histogram(LATENCY_METRIC)
        self._m_flush_lat: dict = {}      # bucket -> flush-latency histogram
        self._pending: list = []
        self._sessions: dict[str, set] = {}
        # minimum exclude-lane width: per-flush widths are bucketed to
        # powers of two above this floor
        self._exclude_width = max(1, exclude_width)
        self.cfg = _buckets.ProgramConfig(
            k=k, eps=eps, beam_width=beam_width, codec=codec,
            rerank_k=rerank_k, expand_width=expand_width,
            visited_size=visited_size, hop_backend=hop_backend)
        self.buckets = _buckets.bucket_sizes(max_batch, bucket_floor)

    def warmup(self, *, with_budget: bool = False) -> dict:
        """One throwaway flush of every bucket this engine can dispatch
        (boot time).  Returns ``{(bucket, variant): seconds}``."""
        view = self.index.acquire_view()
        try:
            return _buckets.precompile(view, self.cfg, self.buckets,
                                       with_budget=with_budget)
        finally:
            self.index.release_view(view)

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def from_snapshot(cls, path, device="cuda",
                      **engine_kwargs) -> "QueryEngine":
        """Warm-start an engine from a persisted index (``persist/``) on
        ``device``: no rebuild on boot — the restored index serves on the
        first flush and stays fully mutable."""
        return cls(DEGIndex.load(path, device=device), **engine_kwargs)

    def save(self, path) -> None:
        """Flush pending queries, then snapshot the backing index (session
        exclude-sets are serving-process state, not index state, and are
        not persisted)."""
        self.flush()
        self.index.save(path)

    # -- request paths ----------------------------------------------------
    def submit(self, query: np.ndarray, session: Optional[str] = None,
               seed_vertex: Optional[int] = None) -> dict:
        """Queue one query; returns a 'future' dict filled at flush()."""
        fut = {"done": False, "ids": None, "dists": None}
        excl = sorted(self._sessions.get(session, ())) if session else []
        qid = self._qid
        self._qid += 1
        sampled = self._sampler.take() if self._sampler.active else False
        self._pending.append((np.asarray(query, np.float32), excl, fut,
                              session, seed_vertex, qid, sampled))
        if len(self._pending) >= self.max_batch:
            self.flush()
        return fut

    def search(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Synchronous batched search (no sessions)."""
        futs = [self.submit(q) for q in np.atleast_2d(queries)]
        self.flush()
        return (np.stack([f["ids"] for f in futs]),
                np.stack([f["dists"] for f in futs]))

    def explore(self, vertex: int, session: str) -> dict:
        """Exploration query: seed = an indexed vertex; session exclusions
        accumulate (paper §6.7 protocol)."""
        self._sessions.setdefault(session, set()).add(int(vertex))
        q = self.index.vectors[int(vertex)]
        return self.submit(q, session=session, seed_vertex=int(vertex))

    def memory_stats(self) -> dict:
        """The index-wide per-codec table plus the bytes/ratio for the
        codec this engine serves with."""
        stats = self.index.memory_stats()
        stats["codec"] = self.codec
        stats["serving_bytes"] = stats[f"{self.codec}_bytes"]
        stats["serving_ratio"] = stats[f"{self.codec}_ratio"]
        return stats

    def insert(self, vectors: np.ndarray, wave_size: int = 8) -> None:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        self.index.add(vectors, wave_size=wave_size)
        self.stats.inserts += vectors.shape[0]

    def delete(self, vertex: int) -> bool:
        """Online delete.  Deletion compacts slots (the last vertex moves
        into the freed slot), so pending queries are flushed first and
        session exclude-sets are remapped."""
        self.flush()
        last = self.index.n - 1
        ok = bool(self.index.remove([int(vertex)]))
        if ok:
            for seen in self._sessions.values():
                seen.discard(int(vertex))
                if last in seen and vertex != last:
                    seen.discard(last)
                    seen.add(int(vertex))    # the moved vertex's new id
        return ok

    # -- the device call ---------------------------------------------------
    def flush(self) -> int:
        """One search over the bucket of lanes that fits the pending batch.

        Plain queries get the cached medoid seed, exploration queries their
        seed vertex plus session history.  A flush with no exclusions at
        all passes ``exclude=None``; otherwise the exclude width is the
        batch's need bucketed to a power of two."""
        if not self._pending:
            return 0
        batch = self._pending[: self.max_batch]
        self._pending = self._pending[self.max_batch:]
        B = len(batch)
        view = self.index.acquire_view()
        try:
            items = [
                _buckets.BatchItem(
                    query=q,
                    # an exploration seed never reappears in its own results
                    exclude=list(dict.fromkeys(
                        ([sv] if sv is not None and session else [])
                        + list(ex))),
                    seed_vertex=sv)
                for (q, ex, _, session, sv, _, _) in batch]
            bucket = next(b for b in self.buckets if b >= B)
            qs, seeds, excl = _buckets.pad_batch(items, bucket,
                                                 view.medoid(),
                                                 self._exclude_width)
            t0 = clock.now()
            res = _buckets.dispatch(view, self.cfg, qs, seeds, excl)
            ids, dists, hops, evals, vfrac = to_host(res)
        finally:
            self.index.release_view(view)
        flush_s = clock.now() - t0
        self.stats.total_search_s += flush_s
        flush_index = self.stats.flushes
        self.stats.flushes += 1
        self.stats.queries += B
        self._m_flushes.inc()
        self._m_queries.inc(B)
        self._m_hops.inc(int(hops[:B].sum()))
        self._m_evals.inc(int(evals[:B].sum()))
        h = self._m_flush_lat.get(bucket)
        if h is None:
            h = self._m_flush_lat[bucket] = self.metrics.histogram(
                "serving_flush_latency_ms", bucket=str(bucket))
        h.observe(flush_s * 1e3)
        for _ in range(B):
            self._m_latency.observe(flush_s * 1e3)
        for i, (q, _, fut, session, sv, qid, sampled) in enumerate(batch):
            fut["ids"], fut["dists"] = ids[i], dists[i]
            fut["done"] = True
            if session:
                self._sessions.setdefault(session, set()).update(
                    int(x) for x in ids[i] if x != INVALID)
            if sampled and self._query_log is not None:
                self._query_log.write(make_record(
                    qid=qid, query=q, k=self.k, ids=ids[i], dists=dists[i],
                    hops=int(hops[i]), evals=int(evals[i]),
                    seed_vertex=sv,
                    exclude_n=len(items[i].exclude),
                    visited_frac=None if vfrac is None else float(vfrac[i]),
                    flush_index=flush_index, bucket=bucket,
                    latency_ms=flush_s * 1e3))
        # continuous refinement between flushes (the paper's core idea);
        # refine() counts improved EDGES (can exceed the vertex budget)
        if self.refine_budget:
            self.stats.refine_iterations += self.index.refine(
                self.refine_budget, seed=self.stats.flushes)
        return B
