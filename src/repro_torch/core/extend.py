"""Device construction programs (paper Alg. 2/3 and the Alg. 5 decisions).

Graph surgery stays sequential numpy (``GraphBuilder``), but the inner
decisions of construction are functions of a graph snapshot, computed here
on the :meth:`GraphBuilder.device_graph` tensors:

* :func:`extend_wave_device`: Alg. 3 steps 4-16 for a block of new
  vertices, on the card one ``kernels/extend_select`` launch: the
  occlusion matrix is computed once, then the (b, n) pair selection runs
  ``d/2`` masked steps (``kernels/extend_select/ref.py`` says why "take
  the first eligible candidate" reproduces the host's pass order).  Lanes
  that run out of candidates report ``ok=False`` and are completed on the
  host.
* :func:`mrng_conform_batch`: Alg. 2 for every edge of a batch of
  vertices (the Alg. 5 agenda), through the ``kernels/mrng_occlusion``
  gather + distance + lune-test kernel.
* :func:`propose_swaps`: Alg. 4 step (2), the best first swap of every
  edge task of a refinement chunk.

As in the JAX package (``src/repro/core/extend.py``), distances the host
path reads from stored edge weights are recomputed here in float32, and the
swap gains are float32 where the host sums Python floats; every structural
decision is validated again against the live builder before edges are
written.  The JAX ``fori_loop`` is a loop in the kernel (and a Python
loop in its plain version), and every first-index choice is an explicit
minimum over the eligible positions, so the card breaks ties as the CPU
does.  Lane counts are not padded: nothing here is compiled per shape.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.extend_select import ops as es_ops
from repro_torch.kernels.extend_select.ref import (extend_select_ref,
                                                   first_max)
from repro_torch.kernels.mrng_occlusion import ops as occ_ops

from .graph import INVALID

_INF = float("inf")


# ---------------------------------------------------------------------------
# Alg. 3: block-batched vertex extension
# ---------------------------------------------------------------------------
def extend_wave_device(adjacency: torch.Tensor, weights: torch.Tensor,
                       vectors: torch.Tensor, cand_ids: torch.Tensor,
                       cand_dists: torch.Tensor, queries: torch.Tensor,
                       v_ids: torch.Tensor, *, scheme: str = "C",
                       rng_checks: bool = True, metric: str = "l2"):
    """Select the d neighbors of W new vertices in one pass on the device.

    cand_ids/cand_dists (W, K): each lane's Alg. 3 candidate search result
    (ascending, INVALID-padded); queries (W, m): the new points; v_ids (W,):
    the ids the new vertices take.  Returns ``(sel_ids (W, d) int32,
    sel_dists (W, d) float32, ok (W,) bool)``: slot 2t holds the t-th
    selected candidate b, slot 2t+1 its surrendered neighbor n (the edge
    (b, n) is replaced by (v, b) and (v, n)).  ``ok=False`` lanes ran out of
    candidates and take the host path.

    On the card, under l2 or sqeuclidean, the whole pass is one
    ``extend_select`` launch; a CPU tensor takes its plain version.  The
    ip and cos metrics, and a degree or candidate list beyond the kernel's
    shared memory, take the two-step path: the ``mrng_occlusion`` wrapper
    (the kernel for l2, the plain version otherwise), then the selection
    steps in torch.  All give the same selections."""
    if cand_ids.device.type == "cpu" or es_ops.kernel_takes(
            cand_ids.device, metric, cand_ids.shape[1], adjacency.shape[1],
            vectors.shape[1]):
        return es_ops.extend_select(adjacency, weights, vectors, cand_ids,
                                    cand_dists, queries, v_ids, scheme=scheme,
                                    rng_checks=rng_checks, metric=metric)
    return extend_select_ref(adjacency, weights, vectors, cand_ids,
                             cand_dists, queries, v_ids, scheme=scheme,
                             rng_checks=rng_checks, metric=metric,
                             occlusion=occ_ops.mrng_occlusion)


def extend_wave(index, pts, cand_ids, cand_dists, start: int):
    """Run :func:`extend_wave_device` for ``index`` against its
    freshly synced device graph; returns numpy selections.  ``pts``,
    ``cand_ids`` and ``cand_dists`` may be numpy arrays or tensors."""
    dev = index.device
    W = pts.shape[0]
    g = index.builder.device_graph()
    sel_ids, sel_d, ok = extend_wave_device(
        g.adjacency, g.weights, index._dev_vectors,
        torch.as_tensor(cand_ids, dtype=torch.int32).to(dev),
        torch.as_tensor(cand_dists, dtype=torch.float32).to(dev),
        torch.as_tensor(pts, dtype=torch.float32).to(dev),
        torch.arange(start, start + W, dtype=torch.int32, device=dev),
        scheme=index.params.scheme, rng_checks=index.params.rng_checks,
        metric=index.params.metric)
    return sel_ids.cpu().numpy(), sel_d.cpu().numpy(), ok.cpu().numpy()


# ---------------------------------------------------------------------------
# Alg. 5: batched conformity + first-swap proposals
# ---------------------------------------------------------------------------
def mrng_conform_batch(adjacency: torch.Tensor, weights: torch.Tensor,
                       vectors: torch.Tensor, v_ids: torch.Tensor, *,
                       metric: str = "l2") -> torch.Tensor:
    """Alg. 2 for every edge of a batch of vertices: (C,) ids -> (C, d)
    bool, True where the edge in that slot is MRNG-conform (INVALID slots
    are True).  The batched twin of ``mrng.mrng_conform_mask``."""
    v = v_ids.to(torch.int64)
    row_ids = adjacency[v]                                  # (C, d)
    row_w = weights[v]
    row_valid = row_ids != INVALID
    safe = torch.where(row_valid, row_ids, 0).to(torch.int64)
    nbr2 = torch.where(row_valid[:, :, None], adjacency[safe], INVALID)
    w2 = weights[safe]
    _, occl = occ_ops.mrng_occlusion(vectors, nbr2, vectors[v], row_w, w2,
                                     metric=metric)
    # only *common* neighbors (u adjacent to both endpoints) occlude
    common = ((nbr2[:, :, :, None] == row_ids[:, None, None, :]).any(-1)
              & (nbr2 != INVALID))
    violated = (occl & common).any(-1)
    return torch.where(row_valid, ~violated, True)


def propose_swaps(adjacency: torch.Tensor, weights: torch.Tensor,
                  ids: torch.Tensor, dists: torch.Tensor, v1: torch.Tensor,
                  v2: torch.Tensor, gain: torch.Tensor):
    """Batched Alg. 4 step (2), first iteration.

    ids/dists (C, k): the prefetched candidate search around each task's
    v2; v1/v2/gain (C,): the edge under optimization and its weight.
    Returns ``(s, n, ds, best, found)``, each (C,): the swap maximizing
    ``gain - d(v2, s) + w(s, n)`` over admissible pairs, with ``found`` iff
    it beats keeping the edge.  The first maximum in row-major order
    matches the host scan's first-strict-improvement tie-break.  The gains
    are float32, as the JAX program computes them."""
    C, k = ids.shape
    D = adjacency.shape[1]
    valid_s = (ids != INVALID) & (ids != v1[:, None]) & (ids != v2[:, None])
    v2row = adjacency[v2.to(torch.int64)]
    valid_s &= ~(ids[:, :, None] == v2row[:, None, :]).any(-1)
    safe = torch.where(ids == INVALID, 0, ids).to(torch.int64)
    srow = adjacency[safe]                                  # (C, k, D)
    srow_w = weights[safe]
    valid_n = (valid_s[:, :, None] & (srow != INVALID)
               & (srow != v2[:, None, None]))
    cand = gain[:, None, None] - dists[:, :, None] + srow_w
    flat = torch.where(valid_n, cand, -_INF).reshape(C, k * D)
    idx = first_max(flat)
    best = flat.gather(1, idx[:, None])[:, 0]
    lane = torch.arange(C, device=ids.device)
    s_sel = ids[lane, idx // D]
    n_sel = srow[lane, idx // D, idx % D]
    ds_sel = dists[lane, idx // D]
    return s_sel, n_sel, ds_sel, best, best > gain
