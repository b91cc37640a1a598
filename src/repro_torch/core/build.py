"""Incremental DEG construction (paper Algorithm 3 + Sec. 5.2) and
continuous refinement (Alg. 5).

:class:`DEGIndex` is the user-facing object: it owns the host-side mutable
graph (:class:`GraphBuilder`), a host mirror of the vectors, and a device
vector buffer kept in sync by in-place row writes.  Construction is
host-orchestrated around batched range searches on the device:

* ``wave_size=1`` — paper-faithful sequential insertion;
* ``wave_size=W`` — the candidate searches of W pending vertices run as one
  batched search against the pre-wave graph, then the W extensions are
  applied in blocks.

The Alg. 3 extension runs on the device by default
(``DEGParams.device_extend``): per block of ``extend_block`` vertices one
selection pass of ``core/extend.py`` against the freshly synced graph, one
vectorized apply, and a host completion of the lanes a conflict left short.
``device_extend=False`` runs the numpy extension vertex by vertex.
:meth:`DEGIndex.refine` runs Alg. 5 through ``core/optimize.py``;
:meth:`DEGIndex.remove` deletes vertices through ``core/delete.py``.  The
randomness is numpy (``default_rng(0)`` entry vertices, the refinement
seed), so with the same inputs a build or a refinement replays the JAX
package's.

Persistence (``persist/``): :meth:`DEGIndex.save` / :meth:`DEGIndex.load`
write and read the JAX package's snapshot format;
:meth:`DEGIndex.enable_wal` journals every mutation unit before it is
applied, so ``persist.recover(snapshot, wal)`` is bit-identical to the
uninterrupted index; :meth:`DEGIndex.enable_checkpoints` snapshots the
index at wave boundaries.

Live mutation under serving (``core/epoch.py``): every mutator holds the
index's re-entrant mutation lock, and once :meth:`DEGIndex.enable_publishing`
ran, :meth:`DEGIndex.publish` captures an immutable epoch (a cloned graph
and vector buffer, the quarantine set and a medoid outside it) that
serving flushes search through :meth:`DEGIndex.acquire_view`, while writers
go on mutating the live index.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import clock

from .graph import DEGraph, GraphBuilder, INVALID, complete_graph
from .mrng import check_mrng_candidate
from .search import SearchResult, medoid_seed, range_search


# ---------------------------------------------------------------------------
# host-side metric helpers (small vectors; avoids device dispatch overhead)
# ---------------------------------------------------------------------------
def np_pair_dist(metric: str, x: np.ndarray, ys: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    ys = np.asarray(ys, dtype=np.float32)
    if ys.ndim == 1:
        ys = ys[None, :]
    if metric in ("l2", "sqeuclidean"):
        d = ys - x[None, :]
        sq = np.maximum(np.einsum("ij,ij->i", d, d), 0.0)
        return sq if metric == "sqeuclidean" else np.sqrt(sq)
    if metric == "ip":
        return -(ys @ x)
    if metric == "cos":
        xn = x / max(np.linalg.norm(x), 1e-12)
        yn = ys / np.maximum(np.linalg.norm(ys, axis=1, keepdims=True), 1e-12)
        return 1.0 - yn @ xn
    raise ValueError(metric)


@dataclasses.dataclass
class DEGParams:
    """Paper Table 3 hyperparameters, plus the query-engine knobs every
    search of the index inherits unless a call overrides them."""

    degree: int = 20          # d
    k_ext: int = 40
    eps_ext: float = 0.3
    k_opt: int = 20
    eps_opt: float = 0.001
    i_opt: int = 5
    scheme: str = "C"         # paper default: C for extension
    rng_checks: bool = True   # Algorithm 2 during extension
    # Alg. 3 line 17, optional in the paper: optimize the new vertex's far
    # edges at insertion (off, as in the JAX package; refine() is the
    # continuous path)
    optimize_new: bool = False
    metric: str = "l2"
    # Alg. 3 neighbor selection on the device (core/extend.py); False runs
    # the per-vertex host path
    device_extend: bool = True
    # vertices selected per device pass within an insert wave, each pass
    # against the graph synced after the previous block's edge swaps
    extend_block: int = 16
    expand_width: int = 1
    hop_backend: str = "composed"     # "composed" | "fused"
    visited_size: Optional[int] = None  # None = auto (0 unless fused hop)

    def __post_init__(self):
        if self.k_ext < self.degree:
            raise ValueError("k_ext must be >= degree (paper Sec. 5.2)")


def _locked(fn):
    """Serialize a mutator on the index's mutation lock (re-entrant, so
    mutators may call each other and ``publish`` from inside)."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._mutex:
            return fn(self, *args, **kwargs)
    return wrapper


def search_view(view, graph: DEGraph, vectors: torch.Tensor,
                queries: np.ndarray, seed_ids: Optional[np.ndarray] = None,
                exclude: Optional[np.ndarray] = None, *, k: int,
                eps: float = 0.1, beam_width: Optional[int] = None,
                quantized: Optional[str] = None,
                rerank_k: Optional[int] = None,
                expand_width: Optional[int] = None,
                visited_size: Optional[int] = None,
                hop_backend: Optional[str] = None,
                hop_budget: Optional[np.ndarray] = None) -> SearchResult:
    """The search of ``DEGIndex.search_batch`` over ``graph`` and
    ``vectors``, with the defaults, the medoid and the compressed stores
    of ``view``: the live index, or one of its published epochs."""
    p = view.params
    dev = view.device
    E = p.expand_width if expand_width is None else expand_width
    hb = p.hop_backend if hop_backend is None else hop_backend
    vs = p.visited_size if visited_size is None else visited_size
    q = torch.as_tensor(np.atleast_2d(np.ascontiguousarray(
        queries, np.float32))).to(dev)
    if seed_ids is None:
        seeds = torch.full((q.shape[0], 1), view.medoid(),
                           dtype=torch.int32, device=dev)
    else:
        seeds = torch.as_tensor(np.ascontiguousarray(seed_ids, np.int32)
                                ).to(dev)
        if seeds.ndim == 1:
            seeds = seeds[:, None]

    def dev_i32(x):
        return None if x is None else torch.as_tensor(
            np.ascontiguousarray(x, np.int32)).to(dev)

    kw = dict(k=k, eps=eps, beam_width=beam_width, metric=p.metric,
              exclude=dev_i32(exclude), expand_width=E, visited_size=vs,
              hop_backend=hb, hop_budget=dev_i32(hop_budget))
    if quantized in (None, "float32"):
        return range_search(graph, vectors, q, seeds, **kw)
    rk = int(rerank_k) if rerank_k else 4 * k
    return range_search(graph, view.store_for(quantized), q, seeds,
                        rerank_k=max(rk, k), exact_vectors=vectors, **kw)


class DEGIndex:
    """A Dynamic Exploration Graph over a growing set of vectors."""

    def __init__(self, dim: int, params: DEGParams | None = None,
                 capacity: int = 1024, device="cuda"):
        self.params = params or DEGParams()
        self.dim = dim
        self.device = torch.device(device)
        capacity = max(capacity, self.params.degree + 1)
        self.vectors = np.zeros((capacity, dim), dtype=np.float32)
        self._dev_vectors = torch.zeros((capacity, dim), dtype=torch.float32,
                                        device=self.device)
        self.builder: Optional[GraphBuilder] = None
        self._pending: list[np.ndarray] = []   # points before K_{d+1} exists
        self._rng = np.random.default_rng(0)
        self._medoid: Optional[int] = None     # cached medoid_seed entry
        # codec -> VectorStore encoded from the current vector set
        self._stores: dict = {}
        # per-stage wall time of _insert_wave (candidate search vs vertex
        # extension)
        self.build_stats = {"search_s": 0.0, "extend_s": 0.0, "vertices": 0}
        # running totals of refine_sweep (whether or not a registry is
        # attached)
        self.refine_stats = {"vertices": 0, "edge_tasks": 0, "improved": 0}
        # optional obs.MetricsRegistry: when attached, insert waves and
        # refine sweeps record their stage spans and counters into it under
        # the JAX package's names; None (the default) costs a None check
        self.metrics = None
        # mid-build checkpointing (persist/snapshot.py): every insert wave
        # and refine chunk ticks the counter; when due, the full index state
        # is snapshotted at the wave boundary (the only mid-build points
        # where the graph invariants hold)
        self._ckpt_path = None
        self._ckpt_every = 0
        self._wave_counter = 0
        # mutation WAL (persist/wal.py): when enabled, every mutation unit
        # (bootstrap take / insert wave / remove / refine) is journaled
        # before it is applied.  _wal_replay holds the record being
        # re-applied (verify, don't re-append); _wal_op_active suppresses
        # checkpoint saves inside a journaled op (a snapshot there would
        # advance the cursor past a half-applied record)
        self._wal = None
        self._wal_seq = 0
        self._wal_replay = None
        self._wal_op_active = False
        # live mutation under serving (core/epoch.py): mutators serialize
        # on _mutex (re-entrant: publish() runs inside remove's lock);
        # _epochs holds the refcounted published epochs once
        # enable_publishing() ran; quarantine is the scrubber's set of
        # damaged vertices, kept out of published seeds and results until
        # they are repaired and audited clean
        self._mutex = threading.RLock()
        self._epochs = None
        self.quarantine: set[int] = set()
        self._publish_every_chunks = 0
        self._refine_chunk_counter = 0

    # -- sizes -------------------------------------------------------------
    @property
    def n(self) -> int:
        return 0 if self.builder is None else self.builder.n

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    def grow(self, new_capacity: int) -> None:
        if new_capacity <= self.capacity:
            return
        vecs = np.zeros((new_capacity, self.dim), dtype=np.float32)
        vecs[: self.capacity] = self.vectors
        self.vectors = vecs
        self._dev_vectors = torch.tensor(vecs, device=self.device)
        self._stores = {}
        if self.builder is not None:
            self.builder.grow(new_capacity)

    # -- device sync ---------------------------------------------------------
    def _put_rows(self, rows: np.ndarray, start: int) -> None:
        self._medoid = None                    # vector set changed
        self._stores = {}
        self._dev_vectors[start : start + rows.shape[0]] = torch.as_tensor(
            np.ascontiguousarray(rows, np.float32)).to(self.device)

    def medoid(self) -> int:
        """Cached approximate-median entry vertex (paper Sec. 5.4),
        invalidated whenever the indexed vector set changes."""
        if self._medoid is None or self._medoid >= self.n:
            self._medoid = medoid_seed(self._dev_vectors, self.n)
        return self._medoid

    def frozen(self) -> DEGraph:
        """The device twin consumed by every search call: valid until the
        next graph mutation + sync (the rows are updated in place); use
        ``builder.freeze()`` for a snapshot that must survive mutations."""
        return self.builder.device_graph()

    # -- epoch publication (core/epoch.py; live mutation under serving) ------
    @property
    def mutation_lock(self) -> threading.RLock:
        """The re-entrant lock every mutator holds; external writers (the
        scrubber, a refinement thread) take it around direct builder
        surgery, so a ``publish()`` never captures a half-applied edit."""
        return self._mutex

    @property
    def publishing(self) -> bool:
        return self._epochs is not None

    def enable_publishing(self, publish_now: bool = True,
                          every_chunks: int = 0):
        """Turn on epoch publication: serving flushes then search
        refcounted immutable epochs (``acquire_view``) instead of the live
        buffers, which writers update in place, so the index may be
        mutated while an engine serves.  ``every_chunks > 0`` also
        republishes every that many refine chunks.  Returns the manager."""
        from .epoch import EpochManager

        with self._mutex:
            if self._epochs is None:
                self._epochs = EpochManager(self)
            self._publish_every_chunks = int(every_chunks)
            if publish_now and self.builder is not None:
                self.publish()
        return self._epochs

    def publish(self) -> int:
        """Publish the current graph and vectors as a new epoch, at a
        mutation-batch boundary.  Journals an ``epoch_publish`` record when
        a WAL is attached and the publish is not inside a journaled op, so
        ``recover()`` lands on the last published epoch.  Returns the new
        epoch number.

        The epoch holds clones: ``freeze()`` clones the graph, and the
        vectors are cloned here, since ``_put_rows`` writes the live buffer
        in place and an uncloned epoch would change under the next
        insert."""
        from repro_torch.obs.metrics import EPOCH_GAUGE, EPOCH_PUBLISH_TOTAL
        from repro_torch.resilience import faults as _faults

        from .epoch import PublishedEpoch

        if self._epochs is None:
            raise RuntimeError("enable_publishing() first")
        if self.builder is None:
            raise RuntimeError("nothing to publish: index is empty")
        with self._mutex:
            e = self._epochs.next_epoch
            gen = self.builder.generation
            quar = tuple(sorted(q for q in self.quarantine if q < self.n))
            # publishes inside a journaled op (refine-chunk ticks) serve
            # readers only: the enclosing record replays the mutations
            if not self._wal_op_active and self._wal_replay is None:
                self._wal_record("epoch_publish",
                                 {"epoch": int(e), "n": int(self.n),
                                  "gen": int(gen),
                                  "quarantine": [int(q) for q in quar]}, {})
            ep = PublishedEpoch(
                epoch=e, graph=self.builder.freeze(),
                vectors=self._dev_vectors.clone(), n=self.n,
                medoid_id=self._publish_medoid(quar),
                metric=self.params.metric, params=self.params,
                quarantine=quar, builder_gen=gen)
            _faults.fire("publish.swap", epoch=e, n=self.n)
            self._epochs.publish(ep)
        if self.metrics is not None:
            self.metrics.gauge(EPOCH_GAUGE).set(e)
            self.metrics.counter(EPOCH_PUBLISH_TOTAL).inc()
        return e

    def _publish_medoid(self, quarantine) -> int:
        """The entry vertex an epoch seeds from: the cached medoid unless
        it is quarantined, else the healthy vertex nearest the centroid."""
        m = self.medoid()
        bad = set(quarantine)
        if m not in bad:
            return m
        vecs = self.vectors[: self.n]
        dist = np.linalg.norm(vecs - vecs.mean(axis=0), axis=1)
        dist[list(bad)] = np.inf
        return int(np.argmin(dist))

    def acquire_view(self):
        """The view a serving flush searches.  With publishing on, the
        current epoch, refcounted: pass it back to :meth:`release_view`
        once the results are on the host.  Without, the index itself (the
        single-writer mode), and release does nothing."""
        if self._epochs is not None:
            return self._epochs.acquire()
        return self

    def release_view(self, view) -> None:
        if self._epochs is not None and view is not self and view is not None:
            self._epochs.release(view)

    def _publish_tick(self) -> None:
        """Refine-chunk boundary hook (``core/optimize.py``): republish
        every ``every_chunks`` chunks when ``enable_publishing`` set it."""
        if self._epochs is None or self._publish_every_chunks <= 0:
            return
        self._refine_chunk_counter += 1
        if self._refine_chunk_counter % self._publish_every_chunks == 0:
            self.publish()

    # -- insertion -----------------------------------------------------------
    @_locked
    def add(self, points: np.ndarray, wave_size: int = 1) -> None:
        """Insert points (Alg. 3). ``wave_size>1`` enables bulk build."""
        points = np.ascontiguousarray(points, dtype=np.float32)
        if points.ndim == 1:
            points = points[None]
        if self.n + len(self._pending) + points.shape[0] > self.capacity:
            self.grow(max(2 * self.capacity,
                          self.n + len(self._pending) + points.shape[0]))
        d = self.params.degree
        i = 0
        # bootstrap: K_{d+1} complete graph (Sec. 5.1)
        if self.builder is None:
            take = min(d + 1 - len(self._pending), points.shape[0])
            if take:
                self._wal_record("add", {"wave_size": int(wave_size)},
                                 {"points": points[:take]})
            self._pending.extend(points[:take])
            i = take
            if len(self._pending) == d + 1:
                init = np.stack(self._pending)
                self.vectors[: d + 1] = init
                self._put_rows(init, 0)
                self.builder = complete_graph(
                    init, d, self.capacity, self.params.metric, self.device)
                self._pending = []
        while i < points.shape[0]:
            w = min(wave_size, points.shape[0] - i)
            # one WAL record per wave, durable before the wave mutates
            # anything, so the end-of-wave checkpoint sees a cursor that
            # covers exactly the applied waves
            self._wal_record("add", {"wave_size": int(w)},
                             {"points": points[i : i + w]})
            self._insert_wave(points[i : i + w])
            i += w

    def _insert_wave(self, pts: np.ndarray) -> None:
        W = pts.shape[0]
        start = self.builder.n
        self.vectors[start : start + W] = pts
        self._put_rows(pts, start)
        # one batched candidate search for the whole wave (pre-wave graph)
        t0 = clock.now()
        seeds = np.full((W, 1), self._entry_vertex(), dtype=np.int32)
        res = self.search_batch(pts, seeds, k=self.params.k_ext,
                                eps=self.params.eps_ext)
        ids = res.ids.cpu().numpy()
        dists = res.dists.cpu().numpy()
        t1 = clock.now()
        use_device = self.params.device_extend
        block = max(int(self.params.extend_block), 1) if use_device else W
        for j0 in range(0, W, block):
            j1 = min(j0 + block, W)
            vs = [self.builder.add_vertex() for _ in range(j0, j1)]
            assert vs[0] == start + j0
            if use_device:
                # one selection pass for the block against the freshly
                # synced graph, then one apply of every selection that
                # survived the block's conflicts (first lane wins, the
                # host application order)
                from .extend import extend_wave

                sel_ids, sel_d, ok = extend_wave(
                    self, pts[j0:j1], res.ids[j0:j1], res.dists[j0:j1],
                    start + j0)
                self._apply_extension_block(start + j0, sel_ids, sel_d, ok)
            for j in range(j0, j1):
                v = start + j
                # warm start from the live row: a host completion of an
                # earlier lane may have taken (or added) edges of this
                # vertex since the block's apply
                live = self.builder.neighbors(v)
                if len(live) == self.params.degree:
                    new_edges = [int(x) for x in live]
                else:
                    new_edges = self._extend_vertex(
                        v, pts[j], ids[j], dists[j],
                        [int(x) for x in live],
                        [float(x) for x in self.builder.neighbor_weights(v)])
                self._post_insert(v, new_edges, ids[j])
        t2 = clock.now()
        self.build_stats["search_s"] += t1 - t0
        self.build_stats["extend_s"] += t2 - t1
        self.build_stats["vertices"] += W
        if self.metrics is not None:
            # the same stamps as build_stats, as per-wave histograms
            self.metrics.histogram("build_wave_search_ms").observe(
                (t1 - t0) * 1e3)
            self.metrics.histogram("build_wave_extend_ms").observe(
                (t2 - t1) * 1e3)
            self.metrics.counter("build_vertices_total").inc(W)
        self._checkpoint_tick()

    def _post_insert(self, v: int, new_edges, cand_ids) -> None:
        if not self.params.optimize_new:
            return
        from .optimize import optimize_edge

        in_s = set(int(x) for x in cand_ids if x != INVALID)
        for u in new_edges:
            if u not in in_s and self.builder.has_edge(v, u):
                # Alg. 3 line 17: replace the far neighbors of the new
                # vertex.  Alg. 4's search finds a new neighbor for its
                # second argument, so the new vertex goes second, as in
                # the JAX package
                optimize_edge(self, u, v, i_opt=self.params.i_opt,
                              k_opt=self.params.k_opt,
                              eps_opt=self.params.eps_opt)

    def _entry_vertex(self) -> int:
        return int(self._rng.integers(0, max(self.builder.n, 1)))

    def _apply_extension_block(self, start_v: int, sel_ids: np.ndarray,
                               sel_d: np.ndarray, ok: np.ndarray) -> None:
        """Apply a block of device-selected neighborhoods in one vectorized
        pass of Alg. 3 edge swaps.

        An edge may be claimed by several lanes of the block (all selected
        against the same snapshot); the first lane wins, the host
        application order, by a lane-major first-occurrence dedup, and
        ``GraphBuilder.replace_edges`` skips any other stale claim.  Lanes
        left short of ``degree`` edges are completed on the host by the
        caller, off the live rows."""
        b = self.builder
        Wb, D = sel_ids.shape
        P = D // 2
        v_arr = start_v + np.arange(Wb)
        lane_ok = np.asarray(ok, bool).copy()
        # structural sanity (the device pass guarantees these; cheap)
        lane_ok &= ((sel_ids >= 0).all(axis=1)
                    & (sel_ids < v_arr[:, None]).all(axis=1))
        srt = np.sort(sel_ids, axis=1)
        lane_ok &= (srt[:, 1:] != srt[:, :-1]).all(axis=1)
        bs, ns = sel_ids[:, 0::2], sel_ids[:, 1::2]          # (Wb, P)
        lo = np.minimum(bs, ns).astype(np.int64)
        hi = np.maximum(bs, ns).astype(np.int64)
        key = lo * b.capacity + hi
        # failed lanes claim nothing: give them unique sentinel keys
        sentinel = -1 - (np.arange(Wb, dtype=np.int64)[:, None] * P
                         + np.arange(P, dtype=np.int64)[None, :])
        key = np.where(lane_ok[:, None], key, sentinel)
        _, first = np.unique(key.reshape(-1), return_index=True)
        keep = np.zeros(key.size, dtype=bool)
        keep[first] = True
        keep = keep.reshape(Wb, P) & lane_ok[:, None]
        k = keep.reshape(-1)
        # v-row slots stay at the pair's position (2t, 2t+1); dropped pairs
        # leave INVALID holes that the host completion fills
        t_idx = np.broadcast_to(np.arange(P), (Wb, P))
        b.replace_edges(
            np.broadcast_to(v_arr[:, None], (Wb, P)).reshape(-1)[k],
            (2 * t_idx).reshape(-1)[k].astype(np.int64),
            bs.reshape(-1)[k], ns.reshape(-1)[k],
            sel_d[:, 0::2].reshape(-1)[k], sel_d[:, 1::2].reshape(-1)[k])

    # -- Alg. 3 core: select d/2 (b, n) pairs -------------------------------
    def _extend_vertex(self, v: int, vec: np.ndarray, cand_ids: np.ndarray,
                       cand_dists: np.ndarray,
                       U0: Optional[list[int]] = None,
                       U0_d: Optional[list[float]] = None) -> list[int]:
        """Host Alg. 3 selection of the d/2 (b, n) edge pairs of ``v``.
        ``U0`` / ``U0_d`` seed the selected set with pairs already in the
        graph (the completion of a device-extended lane)."""
        b = self.builder
        d = b.degree
        metric = self.params.metric
        cands: list[tuple[int, float]] = [
            (int(c), float(x)) for c, x in zip(cand_ids, cand_dists)
            if c != INVALID and c < v
        ]
        U: list[int] = list(U0 or [])
        U_d: list[float] = list(U0_d or [])
        n_pre = len(U)            # warm-start edges already in the graph

        def select_n(bb: int, b_dist: float) -> Optional[tuple[int, float]]:
            nbrs = [int(x) for x in b.neighbors(bb) if int(x) not in U]
            if not nbrs:
                return None
            ws = np.array([b.edge_weight(bb, x) for x in nbrs])
            scheme = self.params.scheme
            if scheme == "C":
                j = int(np.argmax(ws))
            elif scheme == "B":
                j = int(np.argmin(ws))
            else:
                nd = np_pair_dist(metric, vec, self.vectors[nbrs])
                if scheme == "A":
                    j = int(np.argmin(nd))
                elif scheme == "D":
                    j = int(np.argmin(nd - ws))
                else:
                    raise ValueError(self.params.scheme)
            n_sel = nbrs[j]
            n_dist = float(np_pair_dist(metric, vec, self.vectors[n_sel])[0])
            return n_sel, n_dist

        skip_rng = not self.params.rng_checks
        exhausted_fallbacks = 0
        while len(U) < d:
            progressed = False
            for bb, bd in cands:
                if len(U) >= d:
                    break
                if bb in U:
                    continue
                if not skip_rng and not check_mrng_candidate(b, bb, bd, U, U_d):
                    continue
                sel = select_n(bb, bd)
                if sel is None:
                    continue
                n_sel, n_dist = sel
                b.remove_edge(bb, n_sel)
                U.extend((bb, n_sel))
                U_d.extend((bd, n_dist))
                progressed = True
            if len(U) >= d:
                break
            if not skip_rng:
                skip_rng = True      # phase 2 (Alg. 3 line 14)
                continue
            if not progressed:
                # candidate list exhausted — widen with exact nearest actives
                exhausted_fallbacks += 1
                if exhausted_fallbacks > 3:
                    raise RuntimeError(
                        f"cannot complete neighborhood for vertex {v}")
                cands = self._exact_candidates(vec, set(U), v)
        for u, w in zip(U[n_pre:], U_d[n_pre:]):
            b.add_edge(v, u, w)
        return U

    def _exact_candidates(self, vec, exclude, v):
        """Widened pool for an exhausted extension: every vertex below the
        one being inserted (vertices of the same block above ``v`` are
        added but not yet extended, so ``builder.n`` is not the bound)."""
        ds = np_pair_dist(self.params.metric, vec, self.vectors[:v])
        order = np.argsort(ds)
        return [(int(i), float(ds[i])) for i in order if int(i) not in exclude]

    # -- deletion (beyond the paper: completes "fully dynamic", Table 1) ------
    @_locked
    def remove(self, ids, refine_after: int = 0) -> int:
        """Delete vertices preserving regularity and connectivity (no
        tombstones); see ``core/delete.py``.  Returns the number deleted.
        Deletion compacts slots: the last vertex moves into each freed
        slot, so ids held outside the index must be remapped."""
        from .delete import delete_vertices

        id_list = [int(v) for v in
                   (ids if hasattr(ids, "__iter__") else [ids])]
        self._wal_record("remove", {"refine_after": int(refine_after)},
                         {"ids": np.asarray(id_list, np.int64)})
        self._medoid = None
        self._stores = {}
        self._wal_op_active = True
        try:
            return delete_vertices(self, id_list, refine_after=refine_after)
        finally:
            self._wal_op_active = False

    # -- continuous refinement (Alg. 5) ---------------------------------------
    @_locked
    def refine(self, iterations: int, seed: Optional[int] = None) -> int:
        """Continuous edge optimization (Alg. 5) over ``iterations`` vertices
        drawn with ``numpy.random.default_rng(seed)``, through the batched
        path of ``optimize.refine_sweep``.  Returns the number of improved
        edges.  With the WAL on, ``seed=None`` is resolved from the build
        RNG stream (a replayable run cannot depend on OS entropy)."""
        from .optimize import refine_sweep

        if self.builder is None or self.builder.n <= self.builder.degree + 1:
            return 0
        journaled = self._wal is not None or self._wal_replay is not None
        drew = seed is None
        if drew and journaled:
            # replay restores the stream from the snapshot, so it re-draws
            # this seed exactly
            seed = int(self._rng.integers(0, 2**31 - 1))
        self._wal_record("refine",
                         {"iterations": int(iterations),
                          "seed": None if seed is None else int(seed),
                          "drew": drew}, {})
        rng = np.random.default_rng(seed)
        vertices = rng.integers(0, self.builder.n, size=int(iterations))
        self._wal_op_active = journaled
        try:
            return refine_sweep(self, vertices, i_opt=self.params.i_opt,
                                k_opt=self.params.k_opt,
                                eps_opt=self.params.eps_opt)
        finally:
            self._wal_op_active = False

    # -- compressed store views ---------------------------------------------
    def store_for(self, codec: str):
        """The :class:`repro_torch.quant.store.VectorStore` the beam
        traverses under ``codec``: encoded once per codec and vector set,
        and cached until the indexed vectors change."""
        from repro_torch.quant.store import make_store

        if codec not in self._stores:
            self._stores[codec] = make_store(self._dev_vectors, codec,
                                             n=self.n)
        return self._stores[codec]

    def memory_stats(self) -> dict:
        """Bytes of the traversal store of the live rows under each codec.
        The exact float32 copy the rerank reads (``rerank_k`` rows per
        query, not per hop) is reported apart as ``exact_bytes``."""
        from repro_torch.quant import codec as qc

        n, m = self.n, self.dim
        exact = qc.store_bytes("float32", n, m)
        out = {"n": n, "dim": m, "exact_bytes": exact}
        for name in qc.CODECS:
            b = qc.store_bytes(name, n, m)
            out[f"{name}_bytes"] = b
            out[f"{name}_ratio"] = exact / b if b else 0.0
        return out

    # -- persistence (persist/snapshot.py owns the format) -------------------
    def save(self, path) -> None:
        """Snapshot the complete index state (graph, vectors, materialized
        compressed stores, params, RNG/build counters, medoid cache, WAL
        cursor) to one versioned npz, in the JAX package's format."""
        from repro_torch.persist import save_index

        save_index(self, path)

    @classmethod
    def load(cls, path, params: "DEGParams | None" = None,
             capacity: Optional[int] = None, device="cuda") -> "DEGIndex":
        """Restore an index saved by :meth:`save` (or by the JAX package)
        onto ``device``: search-identical and immediately mutable."""
        from repro_torch.persist import load_index

        return load_index(path, params=params, capacity=capacity,
                          device=device)

    def enable_wal(self, path, sync: bool = True) -> None:
        """Journal every future mutation unit to ``path`` (append-only,
        CRC-framed, ``persist/wal.py``) before applying it.  Recovery is
        ``persist.recover(snapshot, wal)``: load the snapshot, replay the
        records past its cursor, bit-identical to the uninterrupted
        index."""
        from repro_torch.persist.wal import WALWriter

        self._wal = WALWriter(path, sync=sync)

    def _wal_record(self, op: str, meta: dict, arrays: dict) -> None:
        """Journal one mutation unit, or during replay verify the op
        against the record being re-applied instead of re-appending it.
        No-op when the WAL is off (the sequence counter advances only for
        journaled ops, keeping snapshot cursors aligned)."""
        rec = self._wal_replay
        if rec is not None:
            from repro_torch.persist.wal import WALError

            if rec.op != op:
                raise WALError(
                    f"replay mismatch at seq {rec.seq}: journal says "
                    f"{rec.op!r}, index replayed {op!r}")
            if op == "refine" and rec.meta.get("seed") != meta.get("seed"):
                raise WALError(
                    f"replay mismatch at seq {rec.seq}: refine seed "
                    f"{meta.get('seed')} != journaled "
                    f"{rec.meta.get('seed')} — RNG stream diverged "
                    "(snapshot and WAL don't belong together?)")
            self._wal_seq += 1
            return
        if self._wal is not None:
            self._wal.append(self._wal_seq, op, meta, arrays)
            self._wal_seq += 1

    def enable_checkpoints(self, path, every_waves: int = 1) -> None:
        """Snapshot the full index to ``path`` every ``every_waves`` insert
        waves / refine chunks (at wave boundaries, where the graph
        invariants hold).  ``path`` may contain ``{waves}`` / ``{n}``
        placeholders to keep a checkpoint series instead of overwriting.
        ``every_waves=0`` disables."""
        try:
            str(path).format(waves=0, n=0)   # fail at config time, not
        except (KeyError, IndexError) as e:  # waves deep into the build
            raise ValueError(
                f"bad checkpoint path template {path!r}: only {{waves}} and "
                f"{{n}} placeholders are supported ({e!r})")
        self._ckpt_path = path
        self._ckpt_every = int(every_waves)

    def _checkpoint_tick(self) -> None:
        self._wave_counter += 1
        if (self._ckpt_path is not None and self._ckpt_every > 0
                and self._wave_counter % self._ckpt_every == 0
                # inside a journaled remove/refine the WAL cursor already
                # covers the op but the graph is mid-surgery: a snapshot
                # here could not be continued by replay.  Waves are safe
                # (one record per wave).  Replay itself never writes.
                and not self._wal_op_active and self._wal_replay is None):
            self.save(str(self._ckpt_path).format(
                waves=self._wave_counter, n=self.n))

    # -- queries --------------------------------------------------------------
    def search_batch(self, queries: np.ndarray,
                     seed_ids: Optional[np.ndarray] = None,
                     exclude: Optional[np.ndarray] = None, *, k: int,
                     eps: float = 0.1, beam_width: Optional[int] = None,
                     quantized: Optional[str] = None,
                     rerank_k: Optional[int] = None,
                     expand_width: Optional[int] = None,
                     visited_size: Optional[int] = None,
                     hop_backend: Optional[str] = None,
                     hop_budget: Optional[np.ndarray] = None) -> SearchResult:
        """The one device entry point every query path funnels through:
        plain searches, exploration sessions and the insert waves.

        ``seed_ids`` (B, S) / ``exclude`` (B, X) go straight into the beam
        engine.  ``quantized`` picks the codec the beam traverses ("fp16",
        "sq8" or "pq"; None or "float32" is the exact path).  With a
        compressed codec the search is two-stage: the beam runs over
        compressed distances, then its best ``rerank_k`` candidates
        (default ``4 * k``) are re-scored exactly against the float rows.
        ``expand_width`` / ``visited_size`` / ``hop_backend`` default to the
        index's ``DEGParams``; ``hop_budget`` (B,) caps each lane's
        expansions."""
        return search_view(
            self, self.frozen(), self._dev_vectors, queries, seed_ids,
            exclude, k=k, eps=eps, beam_width=beam_width, quantized=quantized,
            rerank_k=rerank_k, expand_width=expand_width,
            visited_size=visited_size, hop_backend=hop_backend,
            hop_budget=hop_budget)

    def search(self, queries: np.ndarray, k: int, eps: float = 0.1,
               beam_width: Optional[int] = None, seed: Optional[int] = None,
               quantized: Optional[str] = None,
               rerank_k: Optional[int] = None,
               expand_width: Optional[int] = None,
               visited_size: Optional[int] = None,
               hop_backend: Optional[str] = None) -> SearchResult:
        if seed is None:
            seed = self.medoid()
        q = np.atleast_2d(np.asarray(queries, np.float32))
        seeds = np.full((q.shape[0], 1), seed, dtype=np.int32)
        return self.search_batch(q, seeds, k=k, eps=eps,
                                 beam_width=beam_width, quantized=quantized,
                                 rerank_k=rerank_k,
                                 expand_width=expand_width,
                                 visited_size=visited_size,
                                 hop_backend=hop_backend)

    def explore(self, seed_vertices: Sequence[int], k: int, eps: float = 0.1,
                exclude: Optional[np.ndarray] = None,
                beam_width: Optional[int] = None) -> SearchResult:
        """Exploration queries (paper Sec. 6.7): seed == query vertex; the
        seed (and optionally already-seen vertices) are excluded from
        results."""
        sv = np.asarray(seed_vertices, dtype=np.int32).reshape(-1)
        if exclude is None:
            excl = sv[:, None]
        else:
            excl = np.concatenate([sv[:, None], np.asarray(exclude, np.int32)],
                                  axis=1)
        return self.search_batch(self.vectors[sv], sv[:, None], excl,
                                 k=k, eps=eps, beam_width=beam_width)


    # -- internal searches of core/optimize.py ---------------------------------
    def _search_from(self, query_vec: np.ndarray, seed_ids: Sequence[int],
                     k: int, eps: float) -> tuple[np.ndarray, np.ndarray]:
        s = np.full((1, 2), INVALID, dtype=np.int32)
        for j, sid in enumerate(list(seed_ids)[:2]):
            s[0, j] = sid
        res = self.search_batch(
            np.asarray(query_vec, np.float32)[None, :], s, k=k, eps=eps)
        return res.ids.cpu().numpy()[0], res.dists.cpu().numpy()[0]

    def _search_from_batch(self, query_vecs: np.ndarray,
                           seed_ids: np.ndarray, k: int, eps: float
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Batched sibling of ``_search_from``: (B, m) queries, (B, S)
        seeds -> host (B, k) ids/dists.  Lanes are independent, so unlike
        the JAX package (which pads them to a power of two for its compile
        cache) nothing is padded."""
        res = self.search_batch(query_vecs, seed_ids, k=k, eps=eps)
        return res.ids.cpu().numpy(), res.dists.cpu().numpy()


def build_deg(vectors: np.ndarray, params: DEGParams | None = None,
              wave_size: int = 1, refine_iterations: int = 0,
              capacity: Optional[int] = None, device="cuda") -> DEGIndex:
    """One-shot construction of a DEG over ``vectors``, then
    ``refine_iterations`` vertices of continuous refinement."""
    vectors = np.asarray(vectors, dtype=np.float32)
    idx = DEGIndex(vectors.shape[1], params,
                   capacity=capacity or vectors.shape[0], device=device)
    idx.add(vectors, wave_size=wave_size)
    if refine_iterations:
        idx.refine(refine_iterations)
    return idx
