"""checkMRNG (paper Algorithm 2), host variants (numpy); the batched device
variant is ``core/extend.py::mrng_conform_batch``.

An edge (v1, v2) is MRNG-conform iff no *common neighbor* u of v1 and v2 lies
inside the lune, i.e. ``delta(v1, v2) <= max(w(v1,u), w(v2,u))`` for all
``u in N(v1) & N(v2)``.  During insertion (Alg. 3) the "neighborhood" of the
new vertex is the set ``U`` of neighbors selected so far (Appendix D: the
order of operations is what makes DEG an MRNG *approximation*).
"""
from __future__ import annotations

import numpy as np

from .graph import GraphBuilder, INVALID


def check_mrng(builder: GraphBuilder, v1: int, v2: int, dist_v1_v2: float) -> bool:
    """Algorithm 2 for two existing vertices."""
    n1 = builder.neighbors(v1)
    n2 = set(builder.neighbors(v2).tolist())
    common = [u for u in n1.tolist() if u in n2]
    for u in common:
        w1 = builder.edge_weight(v1, u)
        w2 = builder.edge_weight(v2, u)
        if dist_v1_v2 > max(w1, w2):
            return False
    return True


def check_mrng_candidate(builder: GraphBuilder, cand: int, dist_v_cand: float,
                         selected: list[int], selected_dists: list[float]) -> bool:
    """Algorithm 2 during insertion of a *new* vertex v.

    ``selected`` plays the role of N(G, v): the neighbors already chosen for v
    with their distances ``selected_dists``.  The common-neighbor set is
    ``selected & N(G, cand)``.
    """
    if not selected:
        return True
    cand_nbrs = builder.adjacency[cand]
    cand_set = set(int(x) for x in cand_nbrs if x != INVALID)
    for u, w_vu in zip(selected, selected_dists):
        if u in cand_set:
            w_cu = builder.edge_weight(cand, u)
            if dist_v_cand > max(w_vu, w_cu):
                return False
    return True


def mrng_conform_mask(builder: GraphBuilder, v1: int) -> np.ndarray:
    """For Alg. 5: boolean mask over v1's adjacency slots, True where the
    edge in that slot is MRNG-conform (INVALID slots are True)."""
    row = builder.adjacency[v1]
    out = np.zeros(row.shape, dtype=bool)
    for s, v2 in enumerate(row):
        if v2 == INVALID:
            out[s] = True
            continue
        out[s] = check_mrng(builder, v1, int(v2), float(builder.weights[v1, s]))
    return out
