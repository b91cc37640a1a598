"""NN-descent k-NN graph (kGraph baseline, paper Sec. 3 / Dong et al. 2011).

"A neighbor of a neighbor is probably also a neighbor": start from a random
directed K-NN list and iteratively refine it with neighbor-of-neighbor joins.
The candidate distances are evaluated on the device in chunks; the
sampling, the reverse lists and the per-row merge are the JAX package's
host loops, line for line, so one seed gives one graph in both packages.

The resulting *directed* graph is searched with the same batched range search
(adjacency rows are just followed); the paper's Table 1 / Appendix F points —
no connectivity guarantee, source vertices with zero in-degree, poor
exploration — are reproduced as benchmark observations.
"""
from __future__ import annotations

import numpy as np
import torch

from ..distances import get_metric
from ..graph import DEGraph


def _batch_dists(vectors: np.ndarray, src: np.ndarray, cand: np.ndarray,
                 metric: str, device, chunk: int = 512) -> np.ndarray:
    """dist(vectors[src[i]], vectors[cand[i, j]]) -> (n, C)."""
    m = get_metric(metric)
    out = np.empty(cand.shape, dtype=np.float32)
    for lo in range(0, src.shape[0], chunk):
        hi = min(lo + chunk, src.shape[0])
        x = torch.as_tensor(vectors[src[lo:hi]], device=device)[:, None, :]
        y = torch.as_tensor(vectors[cand[lo:hi]], device=device)
        out[lo:hi] = m.pair(x, y).cpu().numpy()
    return out


def nn_descent(vectors: np.ndarray, K: int, iterations: int = 8,
               sample: int = 8, metric: str = "l2", seed: int = 0,
               verbose: bool = False, device="cuda"):
    """Returns (ids (n, K) int32, dists (n, K) f32) approximate KNN lists."""
    vectors = np.asarray(vectors, dtype=np.float32)
    n = vectors.shape[0]
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    ids = np.empty((n, K), dtype=np.int32)
    for v in range(n):
        ids[v] = rng.choice(n - 1, size=K, replace=False)
        ids[v][ids[v] >= v] += 1  # exclude self
    src = np.arange(n)
    dists = _batch_dists(vectors, src, ids, metric, dev)
    order = np.argsort(dists, axis=1)
    ids = np.take_along_axis(ids, order, axis=1)
    dists = np.take_along_axis(dists, order, axis=1)

    for it in range(iterations):
        # forward sample: neighbors of (sampled) neighbors
        cols = rng.integers(0, K, size=(n, sample))
        hop1 = np.take_along_axis(ids, cols, axis=1)            # (n, s)
        cand_fwd = ids[hop1.reshape(-1)].reshape(n, sample * K)
        if cand_fwd.shape[1] > sample * sample:
            sub = rng.integers(0, cand_fwd.shape[1], size=(n, sample * sample))
            cand_fwd = np.take_along_axis(cand_fwd, sub, axis=1)
        # reverse sample: who points at me
        rev_src = ids.reshape(-1)
        rev_dst = np.repeat(np.arange(n), K)
        perm = rng.permutation(rev_src.shape[0])
        rev_cand = np.full((n, sample), -1, dtype=np.int64)
        fill = np.zeros(n, dtype=np.int32)
        for s, t in zip(rev_src[perm], rev_dst[perm]):
            if fill[s] < sample:
                rev_cand[s, fill[s]] = t
                fill[s] += 1
        cand = np.concatenate([cand_fwd, np.where(rev_cand < 0, cand_fwd[:, :sample], rev_cand)], axis=1)
        cand = np.where(cand == src[:, None], ids[:, :1], cand)  # no self
        cdist = _batch_dists(vectors, src, cand, metric, dev)
        # merge + dedup per row
        allc = np.concatenate([ids, cand], axis=1)
        alld = np.concatenate([dists, cdist], axis=1)
        o = np.argsort(alld, axis=1, kind="stable")
        allc = np.take_along_axis(allc, o, axis=1)
        alld = np.take_along_axis(alld, o, axis=1)
        updates = 0
        for v in range(n):
            seen: set[int] = set()
            row_i, row_d, w = ids[v], dists[v], 0
            for c, dd in zip(allc[v], alld[v]):
                c = int(c)
                if c in seen or c == v:
                    continue
                seen.add(c)
                if w < K:
                    if row_i[w] != c:
                        updates += 1
                    row_i[w], row_d[w] = c, dd
                    w += 1
                else:
                    break
        if verbose:
            print(f"nn-descent iter {it}: {updates} updates")
        if updates == 0:
            break
    return ids, dists


def build_knng(vectors: np.ndarray, K: int, iterations: int = 8,
               metric: str = "l2", seed: int = 0, device="cuda") -> DEGraph:
    """kGraph-style directed index as a device DEGraph."""
    ids, dists = nn_descent(vectors, K, iterations, metric=metric, seed=seed,
                            device=device)
    dev = torch.device(device)
    return DEGraph(adjacency=torch.tensor(ids, device=dev),
                   weights=torch.tensor(dists, device=dev), n=ids.shape[0])
