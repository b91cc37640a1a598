"""Reproducible synthetic datasets.

The paper evaluates on SIFT1M / GloVe / Audio / Enron and stresses that the
*local intrinsic dimensionality* (LID) of a dataset governs difficulty
(Sec. 6.1, observation 2 in Sec. 6.5).  Offline we generate controlled
analogues: ``planted_manifold`` embeds a k-dimensional manifold into R^m so
the LID (~k) can be dialed independently of the ambient dimension — letting
benchmarks reproduce the paper's LID-dependent behavior without the files.
"""
from __future__ import annotations

import numpy as np


def gaussian_mixture(n: int, dim: int, n_clusters: int = 32,
                     cluster_std: float = 0.15, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    pts = centers[assign] + cluster_std * rng.normal(size=(n, dim))
    return pts.astype(np.float32)


def planted_manifold(n: int, dim: int, intrinsic_dim: int = 8,
                     noise: float = 0.01, seed: int = 0) -> np.ndarray:
    """Points on a random smooth intrinsic_dim-manifold in R^dim (LID control)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, intrinsic_dim)).astype(np.float32)
    # random degree-2 feature lift, then random projection to R^dim
    n_feat = intrinsic_dim * (intrinsic_dim + 3) // 2
    feats = [z]
    iu = np.triu_indices(intrinsic_dim)
    feats.append((z[:, :, None] * z[:, None, :])[:, iu[0], iu[1]])
    phi = np.concatenate(feats, axis=1)
    proj = rng.normal(size=(phi.shape[1], dim)).astype(np.float32)
    proj /= np.sqrt(phi.shape[1])
    x = phi @ proj + noise * rng.normal(size=(n, dim))
    return x.astype(np.float32)


def uniform_cube(n: int, dim: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(n, dim)).astype(np.float32)


_GENERATORS = {
    "gaussian": gaussian_mixture,
    "manifold": planted_manifold,
    "uniform": uniform_cube,
}


def make_dataset(kind: str, n_base: int, n_query: int, dim: int,
                 seed: int = 0, **kw):
    """Returns (base (n_base, dim), queries (n_query, dim))."""
    gen = _GENERATORS[kind]
    pts = gen(n_base + n_query, dim, seed=seed, **kw)
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(pts.shape[0])
    return pts[perm[:n_base]], pts[perm[n_base:]]
