"""Device construction programs (paper Alg. 2/3 and the Alg. 5 decisions).

Graph surgery stays sequential numpy (``GraphBuilder``), but the inner
decisions of construction are functions of a graph snapshot, computed here
on the :meth:`GraphBuilder.device_graph` tensors, all through the
``kernels/mrng_occlusion`` gather + distance + lune-test kernel:

* :func:`extend_wave_device`: Alg. 3 steps 4-16 for a block of new
  vertices.  The occlusion matrix is computed once, then the (b, n) pair
  selection runs ``d/2`` masked steps.  Candidate eligibility under Alg. 2
  is monotone (the selected set U only grows, and the rows of unselected
  candidates never change), so "take the first eligible candidate"
  reproduces the host's pass order, including the one-way phase-2 switch
  that drops the occlusion check (Alg. 3 line 14).  Lanes that run out of
  candidates report ``ok=False`` and are completed on the host.
* :func:`mrng_conform_batch`: Alg. 2 for every edge of a batch of
  vertices (the Alg. 5 agenda).
* :func:`propose_swaps`: Alg. 4 step (2), the best first swap of every
  edge task of a refinement chunk.

As in the JAX package (``src/repro/core/extend.py``), distances the host
path reads from stored edge weights are recomputed here in float32, and the
swap gains are float32 where the host sums Python floats; every structural
decision is validated again against the live builder before edges are
written.  The JAX ``fori_loop`` is a Python loop, and every first-index
choice is an explicit minimum over the eligible positions, so the card
breaks ties as the CPU does.  Lane counts are not padded: nothing here is
compiled per shape.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mrng_occlusion import ops as occ_ops

from .graph import INVALID

_INF = float("inf")


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis; 0 where there is none
    (as ``jnp.argmax`` of an all-False row)."""
    n = mask.shape[-1]
    pos = torch.arange(n, device=mask.device).expand_as(mask)
    idx = torch.where(mask, pos, n).amin(dim=-1)
    return torch.where(idx == n, 0, idx)


def _first_max(x: torch.Tensor) -> torch.Tensor:
    return _first(x == x.amax(dim=-1, keepdim=True))


def _first_min(x: torch.Tensor) -> torch.Tensor:
    return _first(x == x.amin(dim=-1, keepdim=True))


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
    candidates and take the host path."""
    if scheme not in ("A", "B", "C", "D"):
        raise ValueError(f"unknown selection scheme {scheme!r}")
    W, K = cand_ids.shape
    D = adjacency.shape[1]
    dev = cand_ids.device
    valid = (cand_ids != INVALID) & (cand_ids < v_ids[:, None])
    safe_cand = torch.where(valid, cand_ids, 0).to(torch.int64)
    nbr_ids = torch.where(valid[:, :, None], adjacency[safe_cand], INVALID)
    nbr_w = torch.where(valid[:, :, None], weights[safe_cand], 0.0)
    # the wrapper clips the INVALID slots to row 0; they are masked below
    nbr_dist, occl = occ_ops.mrng_occlusion(
        vectors, nbr_ids, queries, cand_dists, nbr_w, metric=metric)
    nbr_valid = nbr_ids != INVALID
    occl = occl & nbr_valid
    nbr_dist = torch.where(nbr_valid, nbr_dist, _INF)
    lane = torch.arange(W, device=dev)

    U_ids = torch.full((W, D), INVALID, dtype=torch.int32, device=dev)
    U_d = torch.full((W, D), _INF, dtype=torch.float32, device=dev)
    skip = torch.full((W,), not rng_checks, dtype=torch.bool, device=dev)
    fail = torch.zeros((W,), dtype=torch.bool, device=dev)
    for t in range(D // 2):
        cand_in_U = (cand_ids[:, :, None] == U_ids[:, None, :]).any(-1) & valid
        nbr_in_U = ((nbr_ids[:, :, :, None] == U_ids[:, None, None, :]).any(-1)
                    & nbr_valid)
        blocked = (occl & nbr_in_U).any(-1)                 # Alg. 2 over U
        # surrendered edges need no extra mask: both endpoints of a taken
        # (b, n) pair joined U, so ~nbr_in_U already hides those slots
        avail = nbr_valid & ~nbr_in_U
        elig_base = valid & ~cand_in_U & avail.any(-1)
        elig_mrng = elig_base & ~blocked
        skip = skip | ~elig_mrng.any(-1)                    # phase 2 latch
        elig = torch.where(skip[:, None], elig_base, elig_mrng)
        any_elig = elig.any(-1)
        i_sel = _first(elig)                                # first eligible
        row_avail = avail[lane, i_sel]
        row_w = nbr_w[lane, i_sel]
        row_nd = nbr_dist[lane, i_sel]
        if scheme == "C":
            j_sel = _first_max(torch.where(row_avail, row_w, -_INF))
        elif scheme == "B":
            j_sel = _first_min(torch.where(row_avail, row_w, _INF))
        elif scheme == "A":
            j_sel = _first_min(torch.where(row_avail, row_nd, _INF))
        else:
            j_sel = _first_min(torch.where(row_avail, row_nd - row_w, _INF))
        do = any_elig & ~fail
        U_ids[:, 2 * t] = torch.where(do, cand_ids[lane, i_sel],
                                      U_ids[:, 2 * t])
        U_ids[:, 2 * t + 1] = torch.where(do, nbr_ids[lane, i_sel, j_sel],
                                          U_ids[:, 2 * t + 1])
        U_d[:, 2 * t] = torch.where(do, cand_dists[lane, i_sel],
                                    U_d[:, 2 * t])
        U_d[:, 2 * t + 1] = torch.where(do, nbr_dist[lane, i_sel, j_sel],
                                        U_d[:, 2 * t + 1])
        fail = fail | ~any_elig
    return U_ids, U_d, ~fail


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
    idx = _first_max(flat)
    best = flat.gather(1, idx[:, None])[:, 0]
    lane = torch.arange(C, device=ids.device)
    s_sel = ids[lane, idx // D]
    n_sel = srow[lane, idx // D, idx % D]
    ds_sel = dists[lane, idx // D]
    return s_sel, n_sel, ds_sel, best, best > gain
