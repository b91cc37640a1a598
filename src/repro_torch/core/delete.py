"""Vertex deletion — the missing half of "fully dynamic" (beyond the paper).

Paper Table 1 lists DEG as the only *fully dynamic* graph but defers the
deletion procedure to future work (Sec. 8); Appendix A sketches the
requirement: removal must preserve even regularity and connectivity,
without tombstones.

Procedure for deleting vertex ``v`` (degree d, d even):

1. remove the d edges (v, u_i) — the d neighbors are now degree d-1;
2. re-pair the d deficient neighbors with a *perfect matching* among
   themselves, chosen greedily by ascending distance subject to
   no-duplicate-edge validity; when greedy jams (a dense neighborhood),
   pair what can be paired and give each leftover pair (a, bb) an edge
   split: connect (a, c), (bb, e) and remove an existing (c, e);
3. verify connectivity among the neighbors (a BFS that avoids ``v``); if
   the graph split, retry with a randomized matching, else revert and
   report;
4. compact storage: move the last vertex into slot ``v``, shrink ``n`` —
   the index stays a dense ``[0, n)`` array;
5. optionally run Alg. 5 refinement on the re-paired vertices.

This is the JAX package's ``core/delete.py`` with one repair: the JAX
``_split_matching`` plans every split against the graph as it stood
before any planned edge was added or removed, so two splits can pick the
same (c, e) edge and the second removal raises ``KeyError``.  Here the
plan is made against a :class:`_Shadow` edge set that every planned pair
and split updates, so no edge is removed or added twice.  Where the greedy
matching succeeds (almost every deletion on a real graph) the two packages
delete edge for edge alike.  The index's quarantine set (the scrubber's
damaged vertices, ``serving/scrub.py``) follows the compaction's remap.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Optional, Sequence

import numpy as np

from .build import DEGIndex, np_pair_dist
from .graph import GraphBuilder


def _dist(index: DEGIndex, x: int, y: int) -> float:
    return float(np_pair_dist(index.params.metric, index.vectors[x],
                              index.vectors[y])[0])


def _greedy_matching(cands: list, pairs_needed: int,
                     invalid: set) -> Optional[list]:
    """cands: [(w, a, b)] ascending; returns pairs or None."""
    used: set = set()
    out = []
    for w, a, b in cands:
        if a in used or b in used or (a, b) in invalid:
            continue
        out.append((a, b, w))
        used.add(a)
        used.add(b)
        if len(out) == pairs_needed:
            return out
    return None


def delete_vertex(index: DEGIndex, v: int, *, rng=None,
                  refine_after: int = 0, max_retries: int = 8) -> bool:
    """Delete vertex ``v`` preserving regularity + connectivity.

    Returns True on success.  Raises ValueError for out-of-range ids and
    RuntimeError if the graph is at its minimum size (K_{d+1}).
    """
    b = index.builder
    if b is None or not (0 <= v < b.n):
        raise ValueError(f"no such vertex {v}")
    d = b.degree
    if b.n <= d + 2:
        raise RuntimeError("cannot shrink below the minimal DEG (K_{d+1})")
    rng = rng or np.random.default_rng(v)
    metric = index.params.metric

    nbrs = [int(x) for x in b.neighbors(v)]
    assert len(nbrs) == d, (v, nbrs)
    # 1. remove v's edges (log for rollback)
    removed = [(u, b.remove_edge(v, u)) for u in nbrs]

    # candidate pair weights among the deficient neighbors
    base_cands = []
    invalid = set()
    for i, a in enumerate(nbrs):
        ds = np_pair_dist(metric, index.vectors[a],
                          index.vectors[np.asarray(nbrs[i + 1:])]) \
            if i + 1 < len(nbrs) else []
        for off, bb in enumerate(nbrs[i + 1:]):
            if a == bb or b.has_edge(a, bb):
                invalid.add((a, bb))
                invalid.add((bb, a))
            base_cands.append((float(ds[off]), a, bb))
            base_cands.append((float(ds[off]), bb, a))

    def try_matching(cands) -> Optional[list]:
        return _greedy_matching(sorted(cands), d // 2, invalid)

    success = False
    for attempt in range(max_retries):
        if attempt == 0:
            matching = try_matching(base_cands)
        else:                       # randomized retry: jitter the order
            jit = [(w * (1.0 + 0.5 * rng.random()), a, bb)
                   for w, a, bb in base_cands]
            matching = try_matching(jit)
        added = []
        if matching is None:
            # dense fallback (small graphs: neighbors mutually adjacent):
            # pair the leftover deficient vertices via an Alg.3-style edge
            # split — connect (a, c), (bb, e) and remove an existing (c, e).
            matching = _split_matching(index, b, nbrs, invalid, v)
            if matching is None:
                continue
            for a, bb, kind, c, e in matching:
                if kind == "pair":
                    b.add_edge(a, bb, _dist(index, a, bb))
                    added.append(("pair", a, bb, 0.0))
                else:
                    w_ce = b.remove_edge(c, e)
                    b.add_edge(a, c, _dist(index, a, c))
                    b.add_edge(bb, e, _dist(index, bb, e))
                    added.append(("split", a, bb, w_ce, c, e))
        else:
            for a, bb, w in matching:
                b.add_edge(a, bb, _dist(index, a, bb))
                added.append(("pair", a, bb, 0.0))
        # 3. connectivity check from one affected vertex
        if _connected_among(b, nbrs, exclude=v):
            success = True
            break
        for op in reversed(added):  # revert this attempt, retry
            if op[0] == "pair":
                b.remove_edge(op[1], op[2])
            else:
                _, a, bb, w_ce, c, e = op
                b.remove_edge(a, c)
                b.remove_edge(bb, e)
                b.add_edge(c, e, w_ce)
    if not success:
        for u, w in removed:       # full rollback
            b.add_edge(v, u, w)
        return False

    # 4. compact: move the last vertex into slot v
    index._medoid = None     # the vector set shrinks even when v == last
    last = b.n - 1
    if v != last:
        last_nbrs = [int(x) for x in b.neighbors(last)]
        last_ws = [b.edge_weight(last, u) for u in last_nbrs]
        for u in last_nbrs:
            b.remove_edge(last, u)
        index.vectors[v] = index.vectors[last]
        index._put_rows(index.vectors[v][None], v)
        for u, w in zip(last_nbrs, last_ws):
            b.add_edge(v, u if u != v else last, w)
    b.clear_vertex(last)           # marks the row dirty for the device sync
    b.n -= 1

    # the quarantine follows the remap: the deleted vertex leaves the set,
    # and a quarantined last vertex carries its damage into slot v
    q = index.quarantine
    if q:
        q.discard(v)
        if last in q:
            q.discard(last)
            if v != last:
                q.add(v)

    if refine_after:
        # one batched Alg. 5 sweep over the re-paired neighbors
        from .optimize import refine_sweep

        refine_sweep(index, [u for u in nbrs[: refine_after] if u < b.n],
                     i_opt=index.params.i_opt, k_opt=index.params.k_opt,
                     eps_opt=index.params.eps_opt)
    return True


class _Shadow:
    """The graph as a split plan leaves it: the builder's edges, less the
    planned removals, plus the planned additions (each with its weight).
    ``neighbors`` keeps the builder row's order and appends additions in
    plan order."""

    def __init__(self, b: GraphBuilder):
        self.b = b
        self.removed: set = set()
        self.added: dict = {}          # u -> {x: w}, both directions

    @staticmethod
    def _key(u: int, x: int) -> tuple:
        return (u, x) if u < x else (x, u)

    def has_edge(self, u: int, x: int) -> bool:
        if x in self.added.get(u, {}):
            return True
        return (self._key(u, x) not in self.removed
                and self.b.has_edge(u, x))

    def neighbors(self, u: int) -> list:
        out = [int(x) for x in self.b.neighbors(u)
               if self._key(u, int(x)) not in self.removed]
        return out + list(self.added.get(u, {}))

    def edge_weight(self, u: int, x: int) -> float:
        if x in self.added.get(u, {}):
            return self.added[u][x]
        return self.b.edge_weight(u, x)

    def add(self, u: int, x: int, w: float) -> None:
        self.added.setdefault(u, {})[x] = w
        self.added.setdefault(x, {})[u] = w

    def remove(self, u: int, x: int) -> None:
        if x in self.added.get(u, {}):
            del self.added[u][x]
            del self.added[x][u]
        else:
            self.removed.add(self._key(u, x))


def _split_matching(index: DEGIndex, b: GraphBuilder, nbrs: Sequence[int],
                    invalid: set, v: int) -> Optional[list]:
    """Fallback matching for dense neighborhoods: pair what greedy can,
    resolve leftover deficient pairs (a, bb) by splitting an existing edge
    (c, e) not incident to the deficient set: add (a, c), (bb, e).  Every
    check reads the shadow graph of the plan so far, so the plan applies
    in order without removing or adding an edge twice.  Returns
    [(a, bb, 'pair'|'split', c, e)] or None."""
    g = _Shadow(b)
    left = list(nbrs)
    out = []
    # first: valid direct pairs greedily
    while len(left) >= 2:
        a = left[0]
        best = None
        for bb in left[1:]:
            if (a, bb) in invalid or g.has_edge(a, bb):
                continue
            w = _dist(index, a, bb)
            if best is None or w < best[0]:
                best = (w, bb)
        if best is not None:
            out.append((a, best[1], "pair", -1, -1))
            g.add(a, best[1], best[0])
            left.remove(a)
            left.remove(best[1])
            continue
        # a cannot pair directly with anyone -> split an existing edge
        bb = left[1]
        deficient = set(left) | {v}
        split = None
        for c in range(b.n):
            if c in deficient or g.has_edge(a, c):
                continue
            for e in g.neighbors(c):
                if e in deficient or e == c or g.has_edge(bb, e):
                    continue
                cost = (_dist(index, a, c) + _dist(index, bb, e)
                        - g.edge_weight(c, e))
                if split is None or cost < split[0]:
                    split = (cost, c, e)
            if split is not None and split[0] <= 0:
                break               # good enough; keep scan bounded
        if split is None:
            return None
        _, c, e = split
        out.append((a, bb, "split", c, e))
        g.remove(c, e)
        g.add(a, c, _dist(index, a, c))
        g.add(bb, e, _dist(index, bb, e))
        left.remove(a)
        left.remove(bb)
    return out


def _connected_among(b: GraphBuilder, seeds: Sequence[int],
                     exclude: int, cap: int = 100000) -> bool:
    """BFS from seeds[0]: all other seeds reachable without ``exclude``?"""
    target = set(int(s) for s in seeds)
    seen = {int(seeds[0])}
    dq = deque([int(seeds[0])])
    hits = 1
    steps = 0
    while dq and hits < len(target) and steps < cap:
        u = dq.popleft()
        steps += 1
        for w in b.neighbors(u):
            w = int(w)
            if w == exclude or w in seen:
                continue
            seen.add(w)
            if w in target:
                hits += 1
            dq.append(w)
    return hits == len(target)


def delete_vertices(index: DEGIndex, ids: Iterable[int], *,
                    refine_after: int = 0) -> int:
    """Delete several vertices; later ids are remapped as slots compact
    (each deletion moves the last vertex into the freed slot).  Returns the
    number deleted."""
    remaining = sorted(set(int(i) for i in ids), reverse=True)
    done = 0
    for v in remaining:             # descending: compaction-safe
        if delete_vertex(index, v, refine_after=refine_after):
            done += 1
    return done
