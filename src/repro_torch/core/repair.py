"""Quarantine repair: restore Table-1 invariants on damaged vertices.

The online scrubber (serving/scrub.py) quarantines vertices whose rows
fail the vectorized audit (core/invariants.py).  This module turns a
quarantined set back into a clean even-regular undirected graph in three
stages, mirroring the delete-repair machinery (core/delete.py):

1. **Sanitize** — drop every structurally invalid adjacency entry
   (out-of-range id, self loop, duplicate slot, asymmetric half-edge) and
   heal weight drift in place by recomputing the true distance on both
   ends.  After this stage the graph is undirected and duplicate-free but
   the touched vertices may be degree-deficient.
2. **Complete** — re-pair the deficient slots greedily by ascending true
   distance (the same Eq.-4 reasoning as deletion's matching), falling
   back to Alg.-3-style edge splits (remove an existing (c, e), add
   (a, c) and (b, e)) when no direct pair is valid — including the
   same-vertex case where one vertex is short two slots.  Degree-sum
   parity guarantees the deficiency total is even, so completion
   terminates with exact regularity whenever splits are available.
3. **Reconnect** — if the damage (or the repair) split the graph, splice
   minor components back into the main one with edge swaps that preserve
   regularity on both sides.

``repair_vertices`` drives all three and optionally finishes with a
batched Alg.-5 refinement sweep (core/optimize.py) over the repaired
vertices, so the re-completed edges are immediately pulled toward the
continuous-refinement optimum rather than left wherever the greedy pairing
put them.  Re-admission (a clean re-audit) is the caller's decision.

This is the JAX package's ``core/repair.py``: host numpy over the builder
rows, every write through the builder's mutators or ``mark_dirty``, so the
next ``device_graph()`` copies the repaired rows to the card.  The
refinement sweep runs ``beam_search`` and ``mrng_occlusion`` there.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .build import DEGIndex, np_pair_dist
from .graph import INVALID
from .invariants import component_labels

_W_RTOL, _W_ATOL = 1e-5, 1e-6


def _true_dist(index: DEGIndex, u: int, v: int) -> float:
    return float(np_pair_dist(index.params.metric, index.vectors[u],
                              index.vectors[v])[0])


def sanitize_rows(index: DEGIndex, rows: Sequence[int]) -> list[int]:
    """Stage 1: drop invalid entries from the given rows and heal weight
    drift; returns the vertices left degree-deficient.

    Must be called with *all* quarantined rows at once: a flipped entry
    ``u -> w`` leaves a dangling reverse edge ``v -> u`` on the old
    partner, and the audit flags both ``u`` and ``v``, so sanitizing the
    full flagged set drops both halves and confines deficiency to the
    quarantined rows."""
    b = index.builder
    n = b.n
    for u in sorted(set(int(r) for r in rows)):
        if not (0 <= u < n):
            continue
        seen: set[int] = set()
        for s in range(b.degree):
            v = int(b.adjacency[u, s])
            if v == INVALID:
                continue
            bad = not (0 <= v < n) or v == u or v in seen
            if not bad:
                sv = b.edge_slot(v, u)
                if sv < 0:
                    bad = True          # asymmetric half-edge
                else:
                    w_true = _true_dist(index, u, v)
                    if not (np.isclose(b.weights[u, s], w_true,
                                       rtol=_W_RTOL, atol=_W_ATOL)
                            and np.isclose(b.weights[v, sv], w_true,
                                           rtol=_W_RTOL, atol=_W_ATOL)):
                        b.weights[u, s] = w_true
                        b.weights[v, sv] = w_true
                        b.mark_dirty(u, v)
            if bad:
                b.adjacency[u, s] = INVALID
                b.weights[u, s] = 0.0
                b.mark_dirty(u)
            else:
                seen.add(v)
    return [u for u in sorted(set(int(r) for r in rows))
            if 0 <= u < n and b.vertex_degree(u) < b.degree]


def _complete_deficient(index: DEGIndex, deficient: Sequence[int]) -> bool:
    """Stage 2: add edges until every listed vertex is back at degree d.
    Greedy nearest valid pairing over the deficient slot pool, with edge
    splits when the pool can't pair directly.  Returns True when every
    slot was filled."""
    b = index.builder
    d = b.degree
    pool: list[int] = []
    for v in sorted(set(int(v) for v in deficient)):
        pool.extend([v] * (d - b.vertex_degree(v)))
    while pool:
        if len(pool) == 1:
            return False                # odd parity: sanitize was partial
        # nearest valid direct pair anywhere in the pool
        best = None
        for i in range(len(pool)):
            for j in range(i + 1, len(pool)):
                a, c = pool[i], pool[j]
                if a == c or b.has_edge(a, c):
                    continue
                w = _true_dist(index, a, c)
                if best is None or w < best[0]:
                    best = (w, i, j)
        if best is not None:
            _, i, j = best
            a, c = pool[i], pool[j]
            b.add_edge(a, c, _true_dist(index, a, c))
            del pool[j], pool[i]        # j > i: delete high index first
            continue
        # no direct pair (dense neighborhood or a == c twice): split an
        # existing edge (x, y) away from the pool — add (a, x), (c, y)
        a, c = pool[0], pool[1]
        pool_set = set(pool)
        split = None
        for x in range(b.n):
            if x in pool_set or x == a or b.has_edge(a, x):
                continue
            for y in b.neighbors(x):
                y = int(y)
                if (y in pool_set or y == c or y == a
                        or b.has_edge(c, y)):
                    continue
                cost = (_true_dist(index, a, x) + _true_dist(index, c, y)
                        - b.edge_weight(x, y))
                if split is None or cost < split[0]:
                    split = (cost, x, y)
            if split is not None and split[0] <= 0:
                break                   # good enough; keep the scan bounded
        if split is None:
            return False
        _, x, y = split
        b.remove_edge(x, y)
        b.add_edge(a, x, _true_dist(index, a, x))
        b.add_edge(c, y, _true_dist(index, c, y))
        del pool[1], pool[0]
    return True


def reconnect(index: DEGIndex, max_rounds: int = 32) -> bool:
    """Stage 3: splice minor components into the largest one with
    regularity-preserving double swaps: remove (u, x) inside the minor
    component and (c, e) inside the main one, add (u, c) and (x, e).
    Returns True when the graph ends single-component."""
    b = index.builder
    for _ in range(max_rounds):
        labels = component_labels(b)
        if labels.size == 0 or int(labels.max()) == 0:
            return True
        counts = np.bincount(labels)
        main = int(np.argmax(counts))
        minor = int(np.argmin(counts))
        minor_ids = np.flatnonzero(labels == minor)
        main_ids = np.flatnonzero(labels == main)
        done = False
        for u in minor_ids:
            u = int(u)
            for x in b.neighbors(u):
                x = int(x)
                # nearest main-side anchor for u with a spare edge to break
                best = None
                for c in main_ids:
                    c = int(c)
                    if b.has_edge(u, c):
                        continue
                    for e in b.neighbors(c):
                        e = int(e)
                        if e == c or b.has_edge(x, e) or x == e:
                            continue
                        cost = (_true_dist(index, u, c)
                                + _true_dist(index, x, e))
                        if best is None or cost < best[0]:
                            best = (cost, c, e)
                    if best is not None:
                        break           # first anchor is fine; stay bounded
                if best is None:
                    continue
                _, c, e = best
                # all four adds/removes pre-validated (no dups, no self
                # loops, one free slot on each endpoint after the removes)
                b.remove_edge(u, x)
                b.remove_edge(c, e)
                b.add_edge(u, c, _true_dist(index, u, c))
                b.add_edge(x, e, _true_dist(index, x, e))
                done = True
                break
            if done:
                break
        if not done:
            return False
    return int(component_labels(b).max()) == 0


def repair_vertices(index: DEGIndex, vertices: Sequence[int], *,
                    refine_after: bool = True
                    ) -> tuple[list[int], list[int]]:
    """Full repair pipeline over a quarantined set; call under the index
    mutation lock.  Returns ``(candidates, failed)`` — ``candidates`` are
    the vertices that went through repair and should be re-audited before
    re-admission; ``failed`` is the subset whose completion could not
    restore regularity (they must stay quarantined)."""
    b = index.builder
    if b is None:
        return [], []
    rows = [int(v) for v in sorted(set(int(v) for v in vertices))
            if 0 <= int(v) < b.n]
    if not rows:
        return [], []
    deficient = sanitize_rows(index, rows)
    completed = _complete_deficient(index, deficient)
    reconnect(index)
    failed = [] if completed else [v for v in rows
                                   if b.vertex_degree(v) != b.degree]
    repaired = [v for v in rows if v not in set(failed)]
    if refine_after and repaired:
        from .optimize import refine_sweep

        refine_sweep(index, repaired, i_opt=index.params.i_opt,
                     k_opt=index.params.k_opt,
                     eps_opt=index.params.eps_opt)
    return repaired, failed
