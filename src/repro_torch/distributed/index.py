"""Sharded Dynamic Exploration Graph, the port of
``src/repro/distributed/index.py`` onto ``torch.distributed``.

The DB of N vectors is partitioned **round-robin** into S sub-DEGs, one per
``"model"``-axis shard (global id g lives on shard ``g % S`` at local row
``g // S``).  Each sub-DEG is an independent even-regular DEG built and
refined incrementally.  Queries are split along the batch axes and
replicated along ``"model"``; one search step on rank ``(data=i,
model=s)``:

    shard s's beam search over batch slice i  ->  all-gather (the k best
    of each shard, over "model")  ->  exact top-k merge  ->  all-gather
    over "data" (every rank returns the whole batch)

Collective volume per query: ``S * k * 8`` bytes, independent of N.
Losing one shard (``drop_shard``) degrades recall by ~1/S while the other
shards keep serving.

The local search is the port's own beam engine
(``core/beam.py::beam_search`` and ``extract``): on the card one
``beam_search`` kernel launch a call for every store under l2.  Builds
run in one process on the port's ``DEGIndex``; ranks only search.

One difference from the JAX package is kept: the JAX search runs only the
first of the shards a device holds and numbers ids by the model axis'
size, so an index of S shards searched over a model axis of another size
returns wrong ids there.  Here that raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import beam
from repro_torch.core.build import DEGIndex, DEGParams
from repro_torch.core.distances import get_metric
from repro_torch.core.graph import DEGraph, INVALID
from repro_torch.launch.mesh import lazy_groups

from .collectives import (all_gather_cat, all_reduce, block,
                          topk_merge_allgather)


# ---------------------------------------------------------------------------
# the search step
# ---------------------------------------------------------------------------
def make_sharded_search(mesh, *, k: int, eps: float = 0.1,
                        beam_width: Optional[int] = None,
                        metric: str = "l2", shard_axis: str = "model",
                        batch_axes="data", exclude_width: int = 0,
                        codec: str = "float32",
                        rerank_k: int = 0, expand_width: int = 1,
                        visited_size: Optional[int] = None,
                        hop_backend: str = "composed",
                        stage_ms: Optional[dict] = None) -> Callable:
    """Build the sharded search step, called alike on every rank.

    f(adjacency (S, Ns, d) i32, vectors (S, Ns, m) f32, n (S,) i32,
      seeds (S,) i32, queries (B, m) f32[, exclude (B, X) i32])
      -> (ids (B, k) global i32, dists (B, k) f32), on every rank

    S must equal the size of ``shard_axis`` and B divide evenly over
    ``batch_axes``.  With a compressed ``codec``, f additionally takes
    ``codes (S, Ns, ·)`` / ``scales (S, m)`` (and, for pq,
    ``codebooks (S, m_sub, 256, dsub)``) after ``vectors`` and runs the
    two-stage protocol: each shard's beam traverses its quantized store,
    ``rerank_k`` (default ``4 * k``) candidates per shard merge through
    :func:`topk_merge_allgather`, and the merged list is re-scored exactly
    after the merge: each shard scores the merged rows it owns against its
    float rows and a MIN over the shard axis fills every lane.

    ``expand_width`` / ``visited_size`` / ``hop_backend`` configure the
    shard-local engine (``visited_size=None`` sizes the visited table for
    the fused hop and leaves it off otherwise).  ``stage_ms``, when given,
    gets the wall ms of each call's local search, merge (and rerank) and
    batch gather added under "search", "merge" and "gather", the device
    synchronised at each stage's end.
    """
    from repro_torch.quant.store import VectorStore, as_store

    groups = lazy_groups(mesh, shard_axis, batch_axes)
    quantized = codec != "float32"
    rr = max(rerank_k, k) if quantized else k
    if quantized and rerank_k <= 0:
        rr = 4 * k
    n_args = 5 + (2 if quantized else 0) + (codec == "pq") + (
        exclude_width > 0)

    def f(*args):
        if len(args) != n_args:
            raise TypeError(f"the sharded search over codec {codec!r} "
                            f"with exclude_width={exclude_width} takes "
                            f"{n_args} arguments, got {len(args)}")
        adj, vecs, *rest = args
        codes = scales = books = None
        if quantized:
            codes, scales, *rest = rest
            if codec == "pq":
                books, *rest = rest
        n, seed, queries, *rest = rest
        exclude = rest[0] if rest else None
        shards, batch = groups()
        n_shards = shards.size
        if adj.shape[0] != n_shards:
            raise ValueError(
                f"{adj.shape[0]} shards over a {shard_axis!r} axis of "
                f"{n_shards}: each rank searches exactly one shard")
        s = shards.index
        dev = adj.device
        clock = _StageClock(stage_ms, dev)

        q = block(queries, batch).to(dev, torch.float32)
        b = q.shape[0]
        store = (VectorStore(data=codes[s], codec=codec,
                             scale=scales[s] if codec == "sq8" else None,
                             codebooks=None if books is None else books[s])
                 if quantized else as_store(vecs[s]))
        # the search reads no edge weight: a broadcast zero holds none (a
        # (Ns, d) float32 tensor took 2 GB a call at 2^24 rows)
        g = DEGraph(adjacency=adj[s],
                    weights=torch.zeros((), device=dev).expand(adj.shape[1:]),
                    n=int(n[s]))
        seed_col = seed[s:s + 1].to(dev, torch.int32).reshape(1, 1).expand(
            b, 1)
        if exclude is None:
            seeds, excl_local = seed_col.contiguous(), None
        else:
            # exploration: global seed/exclude ids -> local rows where
            # owned (floor % and //: INVALID maps to row INVALID)
            ex = block(exclude, batch).to(dev, torch.int32)
            own = (ex % n_shards) == s
            excl_local = torch.where(own, ex // n_shards, INVALID)
            seeds = torch.cat([excl_local[:, :1], seed_col], dim=1)
        n_ex = excl_local.shape[1] if excl_local is not None else 0
        L = (beam_width if beam_width is not None
             else beam.default_beam_width(rr, g.degree, seeds.shape[1],
                                          n_ex))
        L = max(L, rr, seeds.shape[1], rr + n_ex)
        vs = visited_size
        if vs is None:
            vs = (beam.default_visited_size(L, g.degree)
                  if hop_backend == "fused" else 0)
        state = beam.beam_search(
            g, store, q, seeds, k=rr, eps=eps, beam_width=L,
            max_hops=beam.default_max_hops(L), metric=metric,
            exclude=excl_local, expand_width=expand_width, visited_size=vs,
            hop_backend=hop_backend)
        lids, ldists = beam.extract(state, rr, dedup=vs > 0)
        gids = torch.where(lids == INVALID, INVALID, lids * n_shards + s)
        clock.mark("search")
        dists, ids = topk_merge_allgather(ldists, gids, rr, shards)
        if quantized:
            ids, dists = _exact_rerank_owned(
                vecs[s], q, ids, k=k, metric=metric, n_shards=n_shards,
                shard=s, group=shards)
        clock.mark("merge")
        ids, dists = all_gather_cat(ids, batch, 0), all_gather_cat(
            dists, batch, 0)
        clock.mark("gather")
        return ids, dists

    return f


class _StageClock:
    """Wall ms between marks, added into ``into`` (a no-op when None)."""

    def __init__(self, into: Optional[dict], device):
        self.into = into
        self.device = torch.device(device)
        self.t = self._now() if into is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, stage: str) -> None:
        if self.into is None:
            return
        t = self._now()
        self.into[stage] = self.into.get(stage, 0.0) + (t - self.t) * 1e3
        self.t = t


def _exact_rerank_owned(vecs, queries, ids, *, k, metric, n_shards, shard,
                        group):
    """Exact rerank of merged global ids: each shard scores the rows it
    owns against its float rows; a MIN over the shard axis fills the
    unowned lanes; the exact top-k wins (stable sort)."""
    own = (ids != INVALID) & ((ids % n_shards) == shard)
    rows = torch.where(own, ids // n_shards, 0).to(torch.int64)
    ed = get_metric(metric).pair(queries[:, None, :],
                                 vecs[rows].to(torch.float32))
    ed = torch.where(own, ed, torch.inf)
    ed = all_reduce(ed, group, torch.distributed.ReduceOp.MIN)
    ed = torch.where(ids == INVALID, torch.inf, ed)
    order = torch.argsort(ed, dim=1, stable=True)[:, :k]
    out_ids = torch.gather(ids, 1, order)
    out_d = torch.gather(ed, 1, order)
    out_ids = torch.where(torch.isinf(out_d), INVALID, out_ids)
    return out_ids, out_d


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardedDEG:
    """S independently built sub-DEGs + the stacked tensors.

    ``quantize()`` attaches per-shard compressed stores (codes calibrated
    per shard from its live rows); ``search`` then runs the two-stage
    protocol of :func:`make_sharded_search`.  A rank that only searches
    may hold the stacked tensors with ``shards=[]``."""

    shards: list                     # list[DEGIndex]
    adjacency: torch.Tensor          # (S, Ns, d) int32
    vectors: torch.Tensor            # (S, Ns, m) float32
    n: torch.Tensor                  # (S,) int32
    seeds: torch.Tensor              # (S,) int32 per-shard medoid
    params: DEGParams
    codec: str = "float32"
    codes: Optional[torch.Tensor] = None      # (S, Ns, ·) compressed rows
    scales: Optional[torch.Tensor] = None     # (S, m) sq8 scales, else ones
    codebooks: Optional[torch.Tensor] = None  # (S, m_sub, 256, dsub), pq

    @classmethod
    def from_shards(cls, shards: list, params: DEGParams) -> "ShardedDEG":
        """Stack built sub-DEGs (each shard's medoid its seed)."""
        adj, vecs = _stack(shards, params.degree)
        dev = shards[0].device
        return cls(shards=shards, adjacency=adj, vectors=vecs,
                   n=torch.tensor([sh.n for sh in shards], dtype=torch.int32,
                                  device=dev),
                   seeds=torch.tensor([sh.medoid() for sh in shards],
                                      dtype=torch.int32, device=dev),
                   params=params)

    @property
    def n_shards(self) -> int:
        return self.adjacency.shape[0]

    @property
    def n_total(self) -> int:
        return int(self.n.sum())

    def quantize(self, codec: str) -> "ShardedDEG":
        """Post-training: encode every shard's store under ``codec``
        (per-shard calibration over its live rows; pq fits shard s's
        codebooks on the host with seed s)."""
        from repro_torch.quant import codec as qc
        from repro_torch.quant import pq as pqm

        if codec not in qc.CODECS:
            raise ValueError(f"unknown codec {codec!r} "
                             f"(have {sorted(qc.CODECS)})")
        if codec == "float32":
            return dataclasses.replace(self, codec=codec, codes=None,
                                       scales=None, codebooks=None)
        S, _, m = self.vectors.shape
        n_host = self.n.tolist()
        ones = torch.ones((S, m), dtype=torch.float32,
                          device=self.vectors.device)
        if codec == "pq":
            host = self.vectors.cpu().numpy()
            books = torch.tensor(np.stack(
                [pqm.fit(host[s], n_host[s], seed=s) for s in range(S)]),
                device=self.vectors.device)
            codes = torch.stack([pqm.encode(self.vectors[s], books[s])
                                 for s in range(S)])
            return dataclasses.replace(self, codec=codec, codes=codes,
                                       scales=ones, codebooks=books)
        scales = (torch.stack([qc.calibrate_sq8_scale(self.vectors[s],
                                                      n_host[s])
                               for s in range(S)])
                  if codec == "sq8" else ones)
        codes = torch.stack([qc.encode(codec, self.vectors[s], scales[s])
                             for s in range(S)])
        return dataclasses.replace(self, codec=codec, codes=codes,
                                   scales=scales, codebooks=None)

    def memory_stats(self) -> dict:
        """Per-shard traversal-store bytes (live rows) under the attached
        codec vs the exact float32 store."""
        from repro_torch.quant import codec as qc

        m = self.vectors.shape[2]
        per_shard = self.n.tolist()
        exact = sum(qc.store_bytes("float32", ns, m) for ns in per_shard)
        b = sum(qc.store_bytes(self.codec, ns, m) for ns in per_shard)
        return {"n": sum(per_shard), "dim": m, "codec": self.codec,
                "exact_bytes": exact, "store_bytes": b,
                "ratio": exact / b if b else 0.0}

    def search_args(self) -> list:
        """The stacked tensors, in the argument order of
        :func:`make_sharded_search`'s step (queries excepted)."""
        args = [self.adjacency, self.vectors]
        if self.codec != "float32":
            args += [self.codes, self.scales]
            if self.codec == "pq":
                args += [self.codebooks]
        return args + [self.n, self.seeds]

    def search(self, mesh, queries, k: int, eps: float = 0.1,
               batch_axes="data", rerank_k: int = 0,
               expand_width: Optional[int] = None,
               visited_size: Optional[int] = None,
               hop_backend: Optional[str] = None):
        """(ids (B, k), dists (B, k)) tensors of the whole batch, on every
        rank of ``mesh``, on the device of the stacked tensors."""
        p = self.params
        f = make_sharded_search(
            mesh, k=k, eps=eps, metric=p.metric, batch_axes=batch_axes,
            codec=self.codec, rerank_k=rerank_k,
            expand_width=p.expand_width if expand_width is None
            else expand_width,
            visited_size=p.visited_size if visited_size is None
            else visited_size,
            hop_backend=p.hop_backend if hop_backend is None
            else hop_backend)
        q = torch.as_tensor(np.asarray(queries, np.float32)
                            if isinstance(queries, np.ndarray) else queries,
                            device=self.adjacency.device)
        return f(*self.search_args(), q)

    def refine(self, iterations: int, seed: Optional[int] = None) -> int:
        """Shard-local continuous refinement (Alg. 5): each sub-DEG runs
        ``iterations`` of the batched refine path independently (sub-DEGs
        share no edges, so shard-local surgery is exact), then the stacked
        adjacency is refreshed from the builders.  Returns the total
        number of improved edges."""
        improved = 0
        for s, sh in enumerate(self.shards):
            improved += sh.refine(
                iterations, seed=None if seed is None else seed + s)
        if improved:
            self.adjacency = _stack(self.shards, self.params.degree)[0]
        return improved

    # -- persistence (persist/sharded.py owns the format) ------------------
    def save(self, path) -> None:
        """Snapshot every sub-DEG (full persist sections) behind one
        manifest, in the JAX package's format."""
        from repro_torch.persist import save_sharded

        save_sharded(self, path)

    @classmethod
    def load(cls, path, n_shards: Optional[int] = None, wave_size: int = 8,
             device="cuda") -> "ShardedDEG":
        """Restore exactly, or onto another shard count by rebuilding
        (reshard-on-restore)."""
        from repro_torch.persist import load_sharded

        return load_sharded(path, n_shards=n_shards, wave_size=wave_size,
                            device=device)

    def drop_shard(self, idx: int) -> "ShardedDEG":
        """Simulate losing one model shard: its sub-DEG serves nothing
        (n=0 makes every seed invalid, so its lanes return INVALID / +inf
        rows; recall degrades by ~1/S, service continues)."""
        n = self.n.clone()
        n[idx] = 0
        return dataclasses.replace(self, n=n)


def _stack(shards: list, degree: int):
    """(adjacency (S, Ns, d) INVALID-padded, vectors (S, Ns, m)) of the
    shards' live rows, Ns the largest shard's n, on the shards' device."""
    ns = max(sh.n for sh in shards)
    m = shards[0].dim
    adj = np.full((len(shards), ns, degree), INVALID, dtype=np.int32)
    vecs = np.zeros((len(shards), ns, m), dtype=np.float32)
    for s, sh in enumerate(shards):
        adj[s, : sh.n] = sh.builder.adjacency[: sh.n]
        vecs[s, : sh.n] = sh.vectors[: sh.n]
    dev = shards[0].device
    return (torch.tensor(adj, device=dev), torch.tensor(vecs, device=dev))


def build_sharded_deg(vectors: np.ndarray, n_shards: int,
                      params: Optional[DEGParams] = None,
                      wave_size: int = 8, refine_iterations: int = 0,
                      codec: str = "float32", device="cuda") -> ShardedDEG:
    """Round-robin partition + per-shard incremental DEG build on
    ``device``.  ``codec`` != "float32" attaches quantized shard stores."""
    params = params or DEGParams()
    vectors = np.asarray(vectors, dtype=np.float32)
    m = vectors.shape[1]
    shards = []
    for s in range(n_shards):
        rows = vectors[s::n_shards]
        idx = DEGIndex(m, params, capacity=rows.shape[0], device=device)
        idx.add(rows, wave_size=wave_size)
        if refine_iterations:
            idx.refine(refine_iterations)
        shards.append(idx)
    sd = ShardedDEG.from_shards(shards, params)
    return sd.quantize(codec) if codec != "float32" else sd
