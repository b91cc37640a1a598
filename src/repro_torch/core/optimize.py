"""Dynamic edge optimization (paper Algorithms 4 and 5, Sec. 5.3).

``optimize_edge`` tries to replace one edge (v1, v2) with a better edge
constellation.  All mutations are recorded in a change log and rolled back
if no configuration with positive *gain* (reduction in total edge weight,
i.e. in the average neighbor distance, Eq. 4) is found, so the graph
invariants (regularity, connectivity) hold after every call, success or
not.

:func:`refine_sweep` is the batched Alg. 5 loop behind
``DEGIndex.refine``: per chunk of vertices it computes the conformity of
every edge in one device pass (``extend.mrng_conform_batch``), prefetches
the first Alg.-4 candidate search of every edge task as one batched search,
and scans every task's first swap in one device pass
(``extend.propose_swaps``); the host-side graph surgery is sequential.  The
prefetched search and scan see the pre-chunk graph, a bounded staleness:
every structural decision is validated again against the live builder, so
only candidate quality can drift, never the invariants.

Every chunk boundary and the end of a sweep tick the index's checkpoint
cadence (``DEGIndex._checkpoint_tick``), and a sweep records its ``obs``
metrics (chunk span, edge tasks, improved edges, vertices) into
``DEGIndex.metrics`` when one is attached, under the JAX package's names;
``DEGIndex.refine_stats`` keeps the same totals either way.  Left out of
the JAX module (``src/repro/core/optimize.py``): the epoch-publish tick
at chunk boundaries, which waits for epoch publishing (ROADMAP A9).

Note on Alg. 4 line 30: the paper's pseudocode says ``add (v1,v5),(v1,v3)``
which contradicts the prose of step (4a) ("the edge (vE,vF) is replaced with
the two edges (vA,vE) and (vA,vF)"); as the JAX package, this follows the
prose: add (v1,v5) and (v1,v6), remove (v5,v6), the only degree-conserving
reading.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import clock

from .build import DEGIndex, np_pair_dist
from .graph import INVALID
from .mrng import mrng_conform_mask


class ChangeLog:
    """Invertible edit log over a GraphBuilder."""

    def __init__(self, builder):
        self.builder = builder
        self.ops: list[tuple[str, int, int, float]] = []

    def add_edge(self, u: int, v: int, w: float) -> None:
        self.builder.add_edge(u, v, w)
        self.ops.append(("add", u, v, w))

    def remove_edge(self, u: int, v: int) -> float:
        w = self.builder.remove_edge(u, v)
        self.ops.append(("remove", u, v, w))
        return w

    def revert(self) -> None:
        for op, u, v, w in reversed(self.ops):
            if op == "add":
                self.builder.remove_edge(u, v)
            else:
                self.builder.add_edge(u, v, w)
        self.ops.clear()

    def __len__(self) -> int:
        return len(self.ops)


def _search(index: DEGIndex, query_vertex: int, seeds, k: int, eps: float):
    ids, dists = index._search_from(index.vectors[query_vertex], seeds, k, eps)
    keep = ids != INVALID
    return ids[keep], dists[keep]


def optimize_edge(index: DEGIndex, v1: int, v2: int, *, i_opt: int = 5,
                  k_opt: int = 20, eps_opt: float = 0.001,
                  first_search: Optional[tuple] = None,
                  first_found: Optional[tuple] = None) -> bool:
    """Algorithm 4.  Returns True iff the graph was improved (changes kept).

    ``first_search`` optionally supplies a prefetched (ids, dists) result
    for the first step-(2) candidate search (the batched Alg. 5 path);
    INVALID lanes are filtered here.  Later iterations always search live.

    ``first_found`` optionally supplies the device-proposed first swap
    (s, n, ds, found) from ``extend.propose_swaps``, computed from the same
    prefetched search against the pre-chunk graph.  A no-swap proposal ends
    the attempt before any mutation; a proposed swap is validated against
    the live builder (and its gain recomputed) before it is taken, with the
    host scan as the fallback when it is stale.
    """
    b = index.builder
    metric = index.params.metric
    vecs = index.vectors

    def dist(u: int, v: int) -> float:
        return float(np_pair_dist(metric, vecs[u], vecs[v])[0])

    if not b.has_edge(v1, v2):
        return False
    if first_found is not None and not first_found[3]:
        return False                # device scan: no improving first swap
    log = ChangeLog(b)
    gain = log.remove_edge(v1, v2)
    v3, v4 = v1, v1

    for it in range(max(i_opt, 1)):
        # ---- step (2): find (v3', v4') maximizing the running gain --------
        best, found = gain, None
        if it == 0 and first_found is not None:
            s, n, ds = (int(first_found[0]), int(first_found[1]),
                        float(first_found[2]))
            if (s not in (v1, v2) and n != v2 and not b.has_edge(v2, s)
                    and b.has_edge(s, n)):
                cand = gain - ds + b.edge_weight(s, n)
                if cand > best:
                    best, found = cand, (s, n, ds)
        if found is None:
            if it == 0 and first_search is not None:
                ids, dists = first_search
                keep = ids != INVALID
                ids, dists = ids[keep], dists[keep]
            else:
                ids, dists = _search(index, v2, (v3, v4), k_opt, eps_opt)
            for s, ds in zip(ids.tolist(), dists.tolist()):
                if s in (v1, v2) or b.has_edge(v2, s):
                    continue
                for n in b.neighbors(int(s)).tolist():
                    if n == v2:
                        continue
                    cand = gain - ds + b.edge_weight(int(s), int(n))
                    if cand > best:
                        best, found = cand, (int(s), int(n), float(ds))
        if found is None:           # Alg. 4 lines 14-15
            break
        s, n, ds = found
        gain = best
        # step (3): replace (vC, vD) with (vB, vC).  The paper's pseudocode
        # adds before removing (transient degree d+1); removing first gives
        # the same end state and keeps the degree cap checkable throughout.
        log.remove_edge(s, n)
        log.add_edge(v2, s, ds)
        v3, v4 = s, n

        if v4 == v1:
            # ---- step (4a): v1 is missing two edges -----------------------
            ids1, dists1 = _search(index, v1, (v2, v3), k_opt, eps_opt)
            best2, found2 = 0.0, None
            for s2, ds2 in zip(ids1.tolist(), dists1.tolist()):
                s2 = int(s2)
                if s2 == v1 or b.has_edge(v1, s2):
                    continue
                for n2 in b.neighbors(s2).tolist():
                    n2 = int(n2)
                    if n2 == v1 or b.has_edge(v1, n2):
                        continue
                    cand = (gain + b.edge_weight(s2, n2)
                            - ds2 - dist(v1, n2))
                    if cand > best2:
                        best2, found2 = cand, (s2, n2, float(ds2))
            if found2 is not None:
                s2, n2, ds2 = found2
                log.remove_edge(s2, n2)
                log.add_edge(v1, s2, ds2)
                log.add_edge(v1, n2, dist(v1, n2))
                return True
        else:
            # ---- step (4b): connect the two deficient vertices v1, v4 -----
            d14 = dist(v1, v4)
            if (not b.has_edge(v1, v4)) and gain - d14 > 0:
                ids1, _ = _search(index, v1, (v2, v3), k_opt, eps_opt)
                ids4, _ = _search(index, v4, (v2, v3), k_opt, eps_opt)
                if v1 in set(ids1.tolist()) or v4 in set(ids4.tolist()):
                    log.add_edge(v1, v4, d14)
                    return True
        # ---- step (5): rotate labels, keep searching -----------------------
        v2, v3, v4 = v4, v2, v3

    log.revert()                    # step (6)
    return False


def _edge_tasks(b, v1: int, conform=None) -> list:
    """Alg. 5's edge agenda for one vertex: every non-MRNG-conform edge,
    then the longest remaining edge (Alg. 5 lines 6-7).

    ``conform`` optionally supplies a precomputed per-slot conformity mask
    (the batched device pass in ``refine_sweep``) in place of a host
    neighbor scan."""
    tasks: list[int] = []
    if conform is None:
        conform = mrng_conform_mask(b, v1)
    nbrs = b.adjacency[v1].copy()
    for slot, v2 in enumerate(nbrs):
        if v2 == INVALID or conform[slot]:
            continue
        tasks.append(int(v2))
    if b.vertex_degree(v1):
        slot = b.longest_edge_slot(v1)
        v2 = int(b.adjacency[v1, slot])
        if v2 != INVALID:
            tasks.append(v2)
    return tasks


def dynamic_edge_optimization(index: DEGIndex, rng: np.random.Generator, *,
                              i_opt: int = 5, k_opt: int = 20,
                              eps_opt: float = 0.001,
                              vertex: Optional[int] = None) -> bool:
    """Algorithm 5: improve the edges of one (random) vertex (serial path)."""
    b = index.builder
    if b is None or b.n <= b.degree + 1:
        return False
    v1 = int(rng.integers(0, b.n)) if vertex is None else vertex
    improved = False
    for v2 in _edge_tasks(b, v1):
        if b.has_edge(v1, v2):             # may have been removed by a swap
            improved |= optimize_edge(index, v1, v2, i_opt=i_opt,
                                      k_opt=k_opt, eps_opt=eps_opt)
    return improved


def refine_sweep(index: DEGIndex, vertices: Sequence[int], *,
                 i_opt: int = 5, k_opt: int = 20, eps_opt: float = 0.001,
                 chunk: int = 16) -> int:
    """Batched Algorithm 5 over many vertices, ``DEGIndex.refine``'s path.

    Per chunk of vertices: build the edge agenda from one conformity pass
    on the device, prefetch the first step-(2) candidate search of every
    edge task in one batched search, scan every task's first swap in one
    device pass, then run the host-side surgery edge by edge with the
    prefetched warm start.  Searches inside later Alg. 4 iterations run
    live.  Returns the number of improved edges."""
    from .extend import mrng_conform_batch, propose_swaps

    b = index.builder
    if b is None or b.n <= b.degree + 1:
        return 0
    dev = index.device
    metrics = index.metrics
    improved = 0
    verts = [int(v) for v in vertices]
    for c0 in range(0, len(verts), chunk):
        t_chunk = clock.now()
        if c0:
            # a chunk boundary is an invariant-clean point: the same
            # checkpoint cadence as _insert_wave
            index._checkpoint_tick()
        verts_c = verts[c0:c0 + chunk]
        g = b.device_graph()
        conform = mrng_conform_batch(
            g.adjacency, g.weights, index._dev_vectors,
            torch.tensor(verts_c, dtype=torch.int32, device=dev),
            metric=index.params.metric).cpu().numpy()
        tasks = [(v1, v2) for i, v1 in enumerate(verts_c)
                 for v2 in _edge_tasks(b, v1, conform=conform[i])]
        index.refine_stats["edge_tasks"] += len(tasks)
        if not tasks:
            continue
        # lane j: query = vectors[v2], seed = v1 (the (v3, v4) = (v1, v1)
        # seeds of Alg. 4's first iteration)
        v1s = np.asarray([v1 for v1, _ in tasks], np.int32)
        v2s = np.asarray([v2 for _, v2 in tasks], np.int32)
        ids, dists = index._search_from_batch(index.vectors[v2s],
                                              v1s[:, None], k_opt, eps_opt)
        gains = np.asarray([b.edge_weight(v1, v2) for v1, v2 in tasks],
                           np.float32)

        def on_dev(x):
            return torch.from_numpy(x).to(dev)

        prop = [x.cpu().numpy() for x in propose_swaps(
            g.adjacency, g.weights, on_dev(ids), on_dev(dists), on_dev(v1s),
            on_dev(v2s), on_dev(gains))]
        clean = True     # no surgery since the chunk snapshot was taken
        for t, ((v1, v2), lane_ids, lane_d) in enumerate(
                zip(tasks, ids, dists)):
            if not b.has_edge(v1, v2):     # removed by an earlier swap
                continue
            # a found=True proposal is validated live inside optimize_edge,
            # so it stays usable on a mutated chunk; the found=False
            # shortcut (skip the attempt) is only sound while the chunk
            # snapshot still matches the graph: a reverted attempt
            # restores it exactly, a kept one does not
            p_found = bool(prop[4][t])
            first_found = ((prop[0][t], prop[1][t], prop[2][t], p_found)
                           if (p_found or clean) else None)
            changed = optimize_edge(
                index, v1, v2, i_opt=i_opt, k_opt=k_opt, eps_opt=eps_opt,
                first_search=(lane_ids, lane_d), first_found=first_found)
            improved += int(changed)
            clean = clean and not changed
        if metrics is not None:
            metrics.histogram("refine_chunk_ms").observe(
                (clock.now() - t_chunk) * 1e3)
            metrics.counter("refine_edge_tasks_total").inc(len(tasks))
    index.refine_stats["vertices"] += len(verts)
    index.refine_stats["improved"] += improved
    if metrics is not None and verts:
        metrics.counter("refine_improved_edges_total").inc(improved)
        metrics.counter("refine_vertices_total").inc(len(verts))
    if verts:
        index._checkpoint_tick()
    return improved
