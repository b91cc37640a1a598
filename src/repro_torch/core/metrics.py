"""Quality metrics from the paper: recall@k (Eq. 2), graph quality GQ
(Eq. 3) and the average neighbor distance (Eq. 4)."""
from __future__ import annotations

import numpy as np

from .distances import exact_knn_batched
from .graph import DEGraph, GraphBuilder, INVALID


def recall_at_k(found_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Eq. (2): mean fraction of true k-NN retrieved. Shapes (Q, k)."""
    found_ids = np.asarray(found_ids)
    true_ids = np.asarray(true_ids)
    q, k = true_ids.shape
    hits = 0
    for i in range(q):
        t = set(true_ids[i].tolist())
        t.discard(INVALID)
        f = set(int(x) for x in found_ids[i].tolist() if x != INVALID)
        hits += len(t & f)
    return hits / (q * k)


def graph_quality(builder: GraphBuilder, vectors: np.ndarray,
                  metric: str = "l2") -> float:
    """Eq. (3): neighborhood vs. true k-NN overlap, k = per-vertex degree.
    The exact neighbors come from ``exact_knn_batched`` on the builder's
    device.

    The paper notes GQ is insensitive to small beneficial changes, which
    Eq. (4) sees (Fig. 1)."""
    n = builder.n
    d = builder.degree
    # true (d+1)-NN includes the vertex itself at distance 0
    _, knn = exact_knn_batched(vectors[:n], vectors[:n], d + 1, metric,
                               device=builder.device)
    total = 0.0
    for v in range(n):
        nbrs = set(builder.neighbors(v).tolist())
        true = [int(x) for x in knn[v] if int(x) != v][: len(nbrs)]
        if not nbrs:
            continue
        total += len(nbrs & set(true)) / len(nbrs)
    return total / max(n, 1)


def average_neighbor_distance(graph_or_builder) -> float:
    """Eq. (4), the paper's edge-quality metric, of a ``GraphBuilder`` or a
    ``DEGraph``."""
    b = graph_or_builder
    if isinstance(b, DEGraph):
        b = b.to_builder()
    return b.average_neighbor_distance()


def hop_histogram(hops, bins: int = 16):
    """``np.histogram`` of per-query hop counts (an array or a tensor)."""
    if hasattr(hops, "cpu"):
        hops = hops.cpu()
    return np.histogram(np.asarray(hops), bins=bins)
