"""Structural invariants of DEG (paper Table 1 / Sec. 5.1), vectorized on
the host graph:

* even regularity: every active vertex has exactly ``d`` valid neighbors;
* undirectedness: ``v in N(u)  <=>  u in N(v)`` with equal weights;
* no self loops, no duplicate edges;
* connectivity: a single connected component.

Out-of-range neighbor ids make a vectorized check return ``False`` instead
of raising, so a live index holding damaged rows can be audited.  The
per-edge Python loops ``check_undirected_loop`` and
``connected_components_loop`` are the references the vectorized checks are
held against; they assume in-range ids.

``audit_rows`` is the online scrubber's entry point: a per-row reason
bitmask (the ``BAD_*`` bits) instead of one bool, so quarantine and repair
touch only the damaged vertices.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .graph import DEGraph, GraphBuilder, INVALID

# ``audit_rows`` reason bits (a row may carry several)
BAD_RANGE = np.uint8(1)     # neighbor id outside [0, n)
BAD_SELF = np.uint8(2)      # self loop
BAD_DUP = np.uint8(4)       # duplicate neighbor in the row
BAD_DEGREE = np.uint8(8)    # valid-slot count != d
BAD_ASYM = np.uint8(16)     # neighbor does not list this vertex back
BAD_WEIGHT = np.uint8(32)   # reverse edge exists but the weights disagree

_W_RTOL, _W_ATOL = 1e-5, 1e-6


def _as_builder(g) -> GraphBuilder:
    return g.to_builder() if isinstance(g, DEGraph) else g


def check_regular(g, *, allow_partial: bool = False) -> bool:
    """Every active row holds ``d`` valid slots (at most ``d`` with
    ``allow_partial``)."""
    b = _as_builder(g)
    degs = (b.adjacency[: b.n] != INVALID).sum(axis=1)
    if allow_partial:
        return bool((degs <= b.degree).all())
    return bool((degs == b.degree).all())


def check_undirected(g) -> bool:
    """Every directed entry ``u -> v`` has exactly one matching ``v -> u``
    with the same weight (sorted edge keys + binary search)."""
    b = _as_builder(g)
    n = b.n
    adj = b.adjacency[:n]
    valid = adj != INVALID
    vs = adj[valid].astype(np.int64)
    if vs.size == 0:
        return True
    if (vs < 0).any() or (vs >= n).any():
        return False
    us = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None],
                         adj.shape)[valid]
    ws = b.weights[:n][valid]
    key = us * n + vs
    order = np.argsort(key, kind="stable")
    skey = key[order]
    if skey.size > 1 and (skey[1:] == skey[:-1]).any():
        return False
    pos = np.searchsorted(skey, vs * n + us)
    if (pos >= skey.size).any() or (skey[pos] != vs * n + us).any():
        return False
    return bool(np.isclose(ws[order][pos], ws,
                           rtol=_W_RTOL, atol=_W_ATOL).all())


def check_no_self_loops(g) -> bool:
    b = _as_builder(g)
    return not bool((b.adjacency[: b.n] == np.arange(b.n)[:, None]).any())


def check_no_duplicate_edges(g) -> bool:
    b = _as_builder(g)
    srt = np.sort(b.adjacency[: b.n], axis=1)
    return not bool(((srt[:, 1:] == srt[:, :-1])
                     & (srt[:, 1:] != INVALID)).any())


def check_undirected_loop(g) -> bool:
    """Per-edge reference for :func:`check_undirected` (in-range ids)."""
    b = _as_builder(g)
    for u in range(b.n):
        for s, v in enumerate(b.adjacency[u]):
            if v == INVALID:
                continue
            v = int(v)
            back = np.nonzero(b.adjacency[v] == u)[0]
            if back.size != 1:
                return False
            if not np.isclose(b.weights[v, back[0]], b.weights[u, s],
                              rtol=_W_RTOL, atol=_W_ATOL):
                return False
    return True


def component_labels(g) -> np.ndarray:
    """Component label of every active vertex (0-based, in discovery
    order) by a vectorized frontier sweep; out-of-range ids are ignored."""
    b = _as_builder(g)
    n = b.n
    labels = np.full(n, -1, dtype=np.int64)
    adj = b.adjacency[:n]
    comp = 0
    cursor = 0
    while True:
        unseen = np.flatnonzero(labels[cursor:] < 0)
        if unseen.size == 0:
            break
        start = cursor + int(unseen[0])
        cursor = start
        labels[start] = comp
        frontier = np.array([start], dtype=np.int64)
        while frontier.size:
            nxt = adj[frontier].reshape(-1)
            nxt = np.unique(nxt[(nxt >= 0) & (nxt < n)].astype(np.int64))
            nxt = nxt[labels[nxt] < 0]
            labels[nxt] = comp
            frontier = nxt
        comp += 1
    return labels


def connected_components(g) -> int:
    """Number of connected components."""
    b = _as_builder(g)
    if b.n == 0:
        return 0
    return int(component_labels(b).max()) + 1


def connected_components_loop(g) -> int:
    """Breadth-first reference for :func:`connected_components`."""
    b = _as_builder(g)
    seen = np.zeros(b.n, dtype=bool)
    comps = 0
    for start in range(b.n):
        if seen[start]:
            continue
        comps += 1
        q = deque([start])
        seen[start] = True
        while q:
            u = q.popleft()
            for v in b.adjacency[u]:
                if v != INVALID and not seen[v]:
                    seen[int(v)] = True
                    q.append(int(v))
    return comps


def check_connected(g) -> bool:
    return connected_components(g) <= 1


def unreachable_vertices(g, entry: int = 0) -> np.ndarray:
    """Active vertices not reachable from ``entry`` (ascending ids)."""
    b = _as_builder(g)
    if b.n == 0:
        return np.empty(0, dtype=np.int64)
    labels = component_labels(b)
    return np.flatnonzero(labels != labels[int(entry)])


def audit_rows(b: GraphBuilder, rows) -> np.ndarray:
    """The scrubber's chunked Table-1 audit: a ``uint8`` reason bitmask per
    requested row (0 = clean).  Row-local properties, reciprocity and
    weight agreement of every listed edge are checked with batched numpy
    gathers.  A dangling reverse entry (``v`` lists ``u``, ``u`` does not
    list ``v``) is flagged on ``v``'s row, so a sweep over all rows covers
    both ends of every broken edge."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    out = np.zeros(rows.size, dtype=np.uint8)
    n, d = b.n, b.degree
    if rows.size == 0 or n == 0:
        return out
    adj = b.adjacency[rows]                     # (R, d)
    w = b.weights[rows]
    valid = adj != INVALID
    out[valid.sum(axis=1) != d] |= BAD_DEGREE
    in_range = valid & (adj >= 0) & (adj < n)
    out[(valid & ~in_range).any(axis=1)] |= BAD_RANGE
    out[(adj == rows[:, None]).any(axis=1)] |= BAD_SELF
    srt = np.sort(adj, axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != INVALID)
    out[dup.any(axis=1)] |= BAD_DUP
    # reciprocity and weights over in-range entries only (the rest are
    # flagged BAD_RANGE and would poison the gather)
    safe = np.where(in_range, adj, 0)
    back = b.adjacency[safe]                    # (R, d, d)
    match = back == rows[:, None, None]
    has_back = match.any(axis=2)
    out[(in_range & ~has_back).any(axis=1)] |= BAD_ASYM
    slot = np.argmax(match, axis=2)             # first matching back slot
    bw = b.weights[safe, slot]
    w_ok = np.isclose(bw, w, rtol=_W_RTOL, atol=_W_ATOL)
    out[(in_range & has_back & ~w_ok).any(axis=1)] |= BAD_WEIGHT
    return out


def assert_valid_deg(g, *, context: str = "") -> None:
    """Assert every DEG invariant; the AssertionError names the first
    that fails, in the JAX package's order and words."""
    b = _as_builder(g)
    assert check_no_self_loops(b), f"self loop {context}"
    assert check_no_duplicate_edges(b), f"duplicate edge {context}"
    assert check_undirected(b), f"asymmetric adjacency {context}"
    assert check_regular(b), f"not {b.degree}-regular {context}"
    assert check_connected(b), f"disconnected {context}"


def check_table1(g) -> dict:
    """Every Table-1 check by name -> bool."""
    b = _as_builder(g)
    return {"even_regular": b.degree % 2 == 0 and check_regular(b),
            "undirected": check_undirected(b),
            "no_self_loops": check_no_self_loops(b),
            "no_duplicate_edges": check_no_duplicate_edges(b),
            "connected": connected_components(b) == 1}


def check_invariants(g) -> tuple[bool, list]:
    """All Table-1 invariants at once: (ok, failure messages), the JAX
    package's messages in its order."""
    b = _as_builder(g)
    msgs = []
    if not check_regular(b):
        msgs.append("not even-regular")
    if not check_undirected(b):
        msgs.append("not undirected")
    if not check_no_self_loops(b):
        msgs.append("self loops present")
    if not check_no_duplicate_edges(b):
        msgs.append("duplicate edges present")
    comps = connected_components(b)
    if comps > 1:
        msgs.append(f"{comps} connected components")
    return (not msgs), msgs
