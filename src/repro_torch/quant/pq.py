"""Product quantization: per-subspace k-means codebooks and uint8 codes.

A row of dimension ``m`` is split into ``m_sub`` contiguous subspaces of
``subspace_dim(m)`` dims; each subspace gets a 256-centroid codebook fit
over the live rows with deterministic Lloyd k-means, and a row is stored
as ``m_sub`` uint8 centroid indices.

Asymmetric distance computation (ADC) searches the codes without decoding
them: for l2,

    ||q - decode(x)||^2  =  sum_s ||q_s - C[s, code_s(x)]||^2,

so a per-query (m_sub, 256) table of squared sub-distances (:func:`adc_lut`)
turns a gathered code row into ``m_sub`` lookups and adds
(``kernels/pq_adc``).

The fit is host numpy, seeded, and copied line for line from the JAX
package, so the same rows, seed and ``iters`` give byte-identical
codebooks.  ``encode`` computes in full float32 (no TF32) with the same
formula and the same first-minimum ``argmin``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distances import _no_tf32

#: centroids per subspace — one uint8 code byte addresses the full book
PQ_K = 256


def subspace_dim(dim: int) -> int:
    """Dims per PQ subspace: the largest of 8/4/2/1 dividing ``dim``."""
    if dim < 1:
        raise ValueError(f"dim must be >= 1, got {dim}")
    for cand in (8, 4, 2, 1):
        if dim % cand == 0:
            return cand
    raise AssertionError("unreachable: 1 divides every dim")


def n_subspaces(dim: int) -> int:
    """Code bytes per row (= number of subspaces) for a ``dim``-dim store."""
    return dim // subspace_dim(dim)


def fit(vectors, n=None, *, seed: int = 0, iters: int = 25) -> np.ndarray:
    """Fit per-subspace k-means codebooks over the first ``n`` rows (all
    when None): (capacity, dim) -> (m_sub, 256, dsub) float32.

    Deterministic Lloyd: init = a seeded permutation of the training rows
    (tiled when fewer than 256 rows), then ``iters`` rounds of assign /
    recenter, empty clusters keeping their old centroid."""
    x = np.asarray(vectors, np.float32)
    rows = x if n is None else x[: int(n)]
    if rows.shape[0] < 1:
        raise ValueError("pq.fit needs at least one live row")
    dim = x.shape[1]
    dsub = subspace_dim(dim)
    m_sub = dim // dsub
    rng = np.random.default_rng(seed)
    books = np.empty((m_sub, PQ_K, dsub), np.float32)
    for s in range(m_sub):
        xs = np.ascontiguousarray(rows[:, s * dsub: (s + 1) * dsub])
        init = np.resize(rng.permutation(xs.shape[0]), PQ_K)
        cent = xs[init].copy()
        xn = np.sum(xs * xs, axis=1)
        prev = None
        for _ in range(iters):
            cn = np.sum(cent * cent, axis=1)
            d2 = xn[:, None] - 2.0 * (xs @ cent.T) + cn[None, :]
            assign = np.argmin(d2, axis=1)
            if prev is not None and np.array_equal(assign, prev):
                break
            prev = assign
            counts = np.bincount(assign, minlength=PQ_K)
            sums = np.zeros((PQ_K, dsub), np.float64)
            np.add.at(sums, assign, xs)
            nonempty = counts > 0
            cent[nonempty] = (sums[nonempty]
                              / counts[nonempty, None]).astype(np.float32)
        books[s] = cent
    return books


def encode(vectors: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid codes: (rows, dim) -> (rows, m_sub) uint8."""
    _no_tf32()
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("pq.encode needs float32 products at 'highest' "
                           "precision, as the JAX package computes them")
    cb = codebooks.to(torch.float32)
    m_sub, _, dsub = cb.shape
    v = vectors.to(torch.float32)
    sub = v.reshape(v.shape[0], m_sub, dsub)
    sn = torch.sum(sub * sub, dim=-1)[:, :, None]          # (n, m_sub, 1)
    cn = torch.sum(cb * cb, dim=-1)[None]                  # (1, m_sub, 256)
    cross = torch.einsum("nsd,skd->nsk", sub, cb)
    d2 = sn - 2.0 * cross + cn
    # the first of equal minima, as jnp.argmin
    return torch.argmin(d2, dim=-1).to(torch.uint8)


def decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Centroid lookup: (..., m_sub) uint8 -> (..., dim) float32."""
    cb = codebooks.to(torch.float32)
    m_sub, _, dsub = cb.shape
    s = torch.arange(m_sub, device=codes.device)
    g = cb[s, codes.to(torch.int64)]                       # (..., m_sub, dsub)
    return g.reshape(codes.shape[:-1] + (m_sub * dsub,))


def adc_lut(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Per-query squared sub-distance tables: (B, dim) -> (B, m_sub, 256),
    ``lut[b, s, c] = ||q_b[s] - C[s, c]||^2``."""
    cb = codebooks.to(torch.float32)
    m_sub, _, dsub = cb.shape
    q = queries.to(torch.float32)
    qs = q.reshape(q.shape[0], m_sub, dsub)
    diff = qs[:, :, None, :] - cb[None]                    # (B, m_sub, 256, d)
    return torch.sum(diff * diff, dim=-1)
