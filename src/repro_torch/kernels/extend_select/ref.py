"""Plain PyTorch version of the Alg. 3 selection pass
(``csrc/extend_select.cu``): the neighbor gather, the lune test of Alg. 2
(``mrng_occlusion``) and the ``d/2`` masked selection steps for a block of
new vertices, the body of ``core/extend.py::extend_wave_device`` and the
twin of the JAX package's (``src/repro/core/extend.py``).

Candidate eligibility under Alg. 2 is monotone (the selected set U only
grows, and the rows of unselected candidates never change), so "take the
first eligible candidate" reproduces the host's pass order, including the
one-way phase-2 switch that drops the occlusion check (Alg. 3 line 14).
Every first-index choice is an explicit minimum over the eligible
positions, so that every version breaks ties alike.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mrng_occlusion.ref import mrng_occlusion_ref

INVALID = -1
_INF = float("inf")
SCHEMES = ("A", "B", "C", "D")


def first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis; 0 where there is none
    (as ``jnp.argmax`` of an all-False row)."""
    n = mask.shape[-1]
    pos = torch.arange(n, device=mask.device).expand_as(mask)
    idx = torch.where(mask, pos, n).amin(dim=-1)
    return torch.where(idx == n, 0, idx)


def first_max(x: torch.Tensor) -> torch.Tensor:
    return first(x == x.amax(dim=-1, keepdim=True))


def first_min(x: torch.Tensor) -> torch.Tensor:
    return first(x == x.amin(dim=-1, keepdim=True))


def extend_select_latched(adjacency, weights, vectors, cand_ids, cand_dists,
                          queries, v_ids, *, scheme: str = "C",
                          rng_checks: bool = True, metric: str = "l2",
                          occlusion=mrng_occlusion_ref):
    """:func:`extend_select_ref` that also returns each lane's phase-2
    latch after the last step, (W,) bool.  ``occlusion`` computes the lune
    test (``mrng_occlusion_ref``, or the ``mrng_occlusion`` wrapper for the
    two-step path on the card)."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown selection scheme {scheme!r}")
    W, K = cand_ids.shape
    D = adjacency.shape[1]
    dev = cand_ids.device
    valid = (cand_ids != INVALID) & (cand_ids < v_ids[:, None])
    safe_cand = torch.where(valid, cand_ids, 0).to(torch.int64)
    nbr_ids = torch.where(valid[:, :, None], adjacency[safe_cand], INVALID)
    nbr_w = torch.where(valid[:, :, None], weights[safe_cand], 0.0)
    # the lune test clips the INVALID slots to row 0; they are masked below
    nbr_dist, occl = occlusion(vectors, nbr_ids, queries, cand_dists, nbr_w,
                               metric=metric)
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
        i_sel = first(elig)                                 # first eligible
        row_avail = avail[lane, i_sel]
        row_w = nbr_w[lane, i_sel]
        row_nd = nbr_dist[lane, i_sel]
        if scheme == "C":
            j_sel = first_max(torch.where(row_avail, row_w, -_INF))
        elif scheme == "B":
            j_sel = first_min(torch.where(row_avail, row_w, _INF))
        elif scheme == "A":
            j_sel = first_min(torch.where(row_avail, row_nd, _INF))
        else:
            j_sel = first_min(torch.where(row_avail, row_nd - row_w, _INF))
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
    return U_ids, U_d, ~fail, skip


def extend_select_ref(adjacency, weights, vectors, cand_ids, cand_dists,
                      queries, v_ids, *, scheme: str = "C",
                      rng_checks: bool = True, metric: str = "l2",
                      occlusion=mrng_occlusion_ref):
    """Select the d neighbors of W new vertices.

    adjacency / weights (N_adj, d): the graph snapshot; vectors (N, m);
    cand_ids / cand_dists (W, K): each lane's Alg. 3 candidate search
    result (ascending, INVALID-padded); queries (W, m): the new points;
    v_ids (W,): the ids the new vertices take.  Returns ``(sel_ids (W, d)
    int32, sel_dists (W, d) float32, ok (W,) bool)``: slot 2t holds the
    t-th selected candidate b, slot 2t+1 its surrendered neighbor n (the
    edge (b, n) is replaced by (v, b) and (v, n)).  ``ok=False`` lanes ran
    out of candidates and take the host path."""
    return extend_select_latched(
        adjacency, weights, vectors, cand_ids, cand_dists, queries, v_ids,
        scheme=scheme, rng_checks=rng_checks, metric=metric,
        occlusion=occlusion)[:3]
