"""Quality metrics from the paper: recall@k (Eq. 2) and the average
neighbor distance (Eq. 4)."""
from __future__ import annotations

import numpy as np

from .graph import DEGraph, INVALID


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


def average_neighbor_distance(graph_or_builder) -> float:
    """Eq. (4), the paper's edge-quality metric, of a ``GraphBuilder`` or a
    ``DEGraph``."""
    b = graph_or_builder
    if isinstance(b, DEGraph):
        b = b.to_builder()
    return b.average_neighbor_distance()
