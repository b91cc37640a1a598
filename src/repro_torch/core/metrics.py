"""Quality metrics from the paper: recall@k (Eq. 2)."""
from __future__ import annotations

import numpy as np

from .graph import INVALID


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
