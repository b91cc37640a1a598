"""Structural invariants of DEG (paper Table 1 / Sec. 5.1), vectorized on
the host graph:

* even regularity: every active vertex has exactly ``d`` valid neighbors;
* undirectedness: ``v in N(u)  <=>  u in N(v)`` with equal weights;
* no self loops, no duplicate edges;
* connectivity: a single connected component.

Out-of-range neighbor ids make a check return ``False`` instead of raising.
"""
from __future__ import annotations

import numpy as np

from .graph import DEGraph, GraphBuilder, INVALID

_W_RTOL, _W_ATOL = 1e-5, 1e-6


def _as_builder(g) -> GraphBuilder:
    return g.to_builder() if isinstance(g, DEGraph) else g


def check_regular(g) -> bool:
    b = _as_builder(g)
    degs = (b.adjacency[: b.n] != INVALID).sum(axis=1)
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


def connected_components(g) -> int:
    """Number of connected components (vectorized frontier sweep)."""
    b = _as_builder(g)
    n = b.n
    labels = np.full(n, -1, dtype=np.int64)
    adj = b.adjacency[:n]
    comp = 0
    for start in range(n):
        if labels[start] >= 0:
            continue
        labels[start] = comp
        frontier = np.array([start], dtype=np.int64)
        while frontier.size:
            nxt = adj[frontier].reshape(-1)
            nxt = np.unique(nxt[(nxt >= 0) & (nxt < n)].astype(np.int64))
            nxt = nxt[labels[nxt] < 0]
            labels[nxt] = comp
            frontier = nxt
        comp += 1
    return comp


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
