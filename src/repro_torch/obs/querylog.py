"""Sampled, rotating JSONL query log — the serving-side record that feeds
continuous refinement.

The paper's signature claim is refinement that never stops; EnhanceGraph
(PAPERS.md, arxiv 2506.13144) shows the best refinement signal is
production traffic itself.  This module defines the record the mining
pass will consume (ROADMAP item 4: hard negatives, unreachable-in-L hops,
shortcut-edge proposals into the Alg. 5 swap machinery), so the schema
leads with the traversal facts that matter for graph quality, not just
latency:

    v                 schema version (1)
    qid               admission sequence number (engine-local, monotone)
    qhash             16-hex blake2b of the query vector bytes — joins
                      repeated queries across engines without storing the
                      vector itself
    k / seed / exclude_n   the request as dispatched (seed null = medoid)
    ids / dists       returned top-k (INVALID-padded ids dropped)
    hops / evals      per-lane traversal counters, surfaced from the beam
                      engine at zero extra device work (the search program
                      always computes them)
    visited_frac      visited-table occupancy in [0,1] (null when the
                      search ran the beam-broadcast dedup) — saturation
                      predicts dropped inserts / duplicate work
    budget_exhausted  lane ran under a hop budget (deadline shed)
    partial           completed flagged partial (best-so-far beam)
    flush_index / bucket   which flush served it, at what padded width
    latency_ms / spans     obs/trace.span_fields timings
    t_mono / t_wall_unix   submit instant — monotonic, plus a wall anchor
                      derived from one wall read per writer (never a
                      hot-path wall-clock call)

Sampling is decided *before* a record is built (``obs/trace.Sampler``):
a sampled-out query allocates nothing and appears nowhere in the log.

The reader side closes the loop: :func:`read_query_log` reloads a log
(rotated segments included, oldest first), :func:`replay_registry`
rebuilds the engine's latency histograms from it — bucket-for-bucket
identical to the live registry, which ``benchmarks/serving_load.py``
asserts — and :func:`recall_from_log` recomputes recall@k from the
recorded ids alone.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Callable, Optional, Sequence

import numpy as np

from . import clock
from .metrics import MetricsRegistry
from .trace import span_fields

SCHEMA_VERSION = 1

#: registry metric name the engines record request latency under; replay
#: rebuilds exactly this metric (see :func:`replay_registry`)
LATENCY_METRIC = "serving_request_latency_ms"


def query_hash(query: np.ndarray) -> str:
    """Stable 16-hex digest of the query vector bytes (float32 view)."""
    q = np.ascontiguousarray(np.asarray(query, np.float32))
    return hashlib.blake2b(q.tobytes(), digest_size=8).hexdigest()


def make_record(*, qid: int, query: np.ndarray, k: int,
                ids: np.ndarray, dists: np.ndarray,
                hops: int, evals: int,
                seed_vertex: Optional[int] = None,
                exclude_n: int = 0,
                visited_frac: Optional[float] = None,
                budget_exhausted: bool = False,
                partial: bool = False,
                flush_index: Optional[int] = None,
                bucket: Optional[int] = None,
                latency_ms: Optional[float] = None,
                result=None,
                t_mono: Optional[float] = None) -> dict:
    """One query-log record (a plain dict; the writer JSON-encodes it).
    ``result`` (an ``AsyncResult``-like with monotonic stamps) supplies
    the span timings when given."""
    keep = np.asarray(ids) >= 0
    rec = {
        "v": SCHEMA_VERSION,
        "qid": int(qid),
        "qhash": query_hash(query),
        "k": int(k),
        "seed": None if seed_vertex is None else int(seed_vertex),
        "exclude_n": int(exclude_n),
        "ids": [int(x) for x in np.asarray(ids)[keep]],
        "dists": [float(x) for x in np.asarray(dists)[keep]],
        "hops": int(hops),
        "evals": int(evals),
        "visited_frac": None if visited_frac is None else float(visited_frac),
        "budget_exhausted": bool(budget_exhausted),
        "partial": bool(partial),
        "flush_index": None if flush_index is None else int(flush_index),
        "bucket": None if bucket is None else int(bucket),
        "latency_ms": None if latency_ms is None else float(latency_ms),
        "spans": span_fields(result) if result is not None else {},
        "t_mono": float(t_mono) if t_mono is not None else None,
    }
    return rec


class QueryLogWriter:
    """Rotating JSONL writer.  One JSON object per line; when the active
    file exceeds ``max_bytes`` it is rotated to ``<path>.1`` (existing
    segments shift up, the oldest beyond ``max_files`` is dropped).

    Writes happen on the engine's extract thread; ``close()`` may race it
    from the caller's thread, hence the lock.  The writer stamps each
    record's ``t_wall_unix`` from a single wall-clock read taken at
    construction plus the record's monotonic offset — the hot path never
    reads the wall clock."""

    def __init__(self, path, *, max_bytes: int = 64 * 1024 * 1024,
                 max_files: int = 4):
        self.path = str(path)
        self.max_bytes = int(max_bytes)
        self.max_files = max(1, int(max_files))
        self._lock = threading.Lock()
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")
        self._bytes = self._f.tell()
        self._anchor_wall = clock.wall_unix()
        self._anchor_mono = clock.now()
        self.records_written = 0

    def write(self, rec: dict) -> None:
        if rec.get("t_mono") is not None:
            rec["t_wall_unix"] = (self._anchor_wall
                                  + (rec["t_mono"] - self._anchor_mono))
        line = json.dumps(rec, separators=(",", ":"), default=float) + "\n"
        data = line.encode("utf-8")
        with self._lock:
            if self._f is None:
                return
            if self._bytes and self._bytes + len(data) > self.max_bytes:
                self._rotate()
            self._f.write(line)
            self._bytes += len(data)
            self.records_written += 1

    def _rotate(self) -> None:
        self._f.close()
        oldest = f"{self.path}.{self.max_files}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.max_files - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a", encoding="utf-8")
        self._bytes = 0

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def read_query_log(path, *, include_rotated: bool = True) -> list[dict]:
    """Reload a query log: rotated segments first (oldest to newest), then
    the active file — chronological record order.  Unknown schema versions
    are rejected rather than silently misparsed."""
    path = str(path)
    files: list[str] = []
    if include_rotated:
        i = 1
        seen = []
        while os.path.exists(f"{path}.{i}"):
            seen.append(f"{path}.{i}")
            i += 1
        files.extend(reversed(seen))          # .N is oldest
    if os.path.exists(path):
        files.append(path)
    records: list[dict] = []
    for fp in files:
        with open(fp, encoding="utf-8") as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                v = rec.get("v")
                if v != SCHEMA_VERSION:
                    raise ValueError(
                        f"{fp}:{ln}: unknown query-log schema version {v!r} "
                        f"(reader supports {SCHEMA_VERSION})")
                records.append(rec)
    return records


def replay_registry(records: Sequence[dict],
                    registry: Optional[MetricsRegistry] = None
                    ) -> MetricsRegistry:
    """Rebuild the engine's request-latency histogram (and traversal
    counters) from log records.  With sample rate 1.0 the result is
    bucket-for-bucket identical to the live engine's registry — the
    round-trip ``benchmarks/serving_load.py`` asserts (p50/p99 equality is
    *exact*, not approximate: both sides are the same pure function of
    the same observations)."""
    reg = registry or MetricsRegistry()
    lat = reg.histogram(LATENCY_METRIC)
    hops = reg.counter("serving_hops_total")
    evals = reg.counter("serving_evals_total")
    partials = reg.counter("serving_deadline_partials_total")
    for rec in records:
        if rec.get("latency_ms") is not None:
            lat.observe(rec["latency_ms"])
        hops.inc(rec["hops"])
        evals.inc(rec["evals"])
        if rec["partial"]:
            partials.inc()
    return reg


def recall_from_log(records: Sequence[dict], gt_for_qid: Callable[[int],
                    Sequence[int]], k: int, *,
                    include_partial: bool = False) -> float:
    """recall@k over the recorded result ids.  ``gt_for_qid(qid)`` maps a
    record back to its exact ground-truth ids (the caller owns that
    mapping — e.g. the bench's submit-order index).  Partial
    (deadline-shed) results are load-shedding by design and excluded
    unless asked for."""
    hits = 0
    total = 0
    for rec in records:
        if rec["partial"] and not include_partial:
            continue
        gt = set(int(g) for g in list(gt_for_qid(rec["qid"]))[:k])
        got = set(rec["ids"][:k])
        hits += len(gt & got)
        total += len(gt)
    return hits / total if total else 0.0


def mining_view(records: Sequence[dict]) -> dict:
    """Aggregate traversal statistics by query hash — the shape of input
    ROADMAP item 4's learned-edges miner consumes: repeated queries
    (Zipfian traffic) grouped with their hop/eval costs and result sets,
    so expensive-but-frequent traversals stand out as shortcut-edge
    candidates."""
    by_hash: dict[str, dict] = {}
    for rec in records:
        agg = by_hash.setdefault(rec["qhash"], {
            "count": 0, "hops_sum": 0, "evals_sum": 0, "partials": 0,
            "ids": set()})
        agg["count"] += 1
        agg["hops_sum"] += rec["hops"]
        agg["evals_sum"] += rec["evals"]
        agg["partials"] += int(rec["partial"])
        agg["ids"].update(rec["ids"])
    return {h: {**a, "ids": sorted(a["ids"])} for h, a in by_hash.items()}
