"""Plain PyTorch version of the whole-search kernel (``csrc/beam_search.cu``):
the range search of the beam engine (paper Alg. 1) with the composed hop,
from an initialised beam to the final one.

The loop is self-contained: it repeats radius, selection of the E first
unchecked entries, adjacency gather, dedup (the beam broadcast, or the
visited set's probes; the first occurrence when E > 1), scoring with
``gather_dist_ref`` (float32, fp16 or bf16 rows upcast to float32; over
the sq8 store's code rows ``gather_dist_q_ref``;
over the pq store's, the table sum of ``pq_adc_ref`` from each lane's
table, built once a search as the kernel builds it: the values
``pq_adc_ref`` gives on every hop), the visited
insert and the merge with ``beam_merge_ref``.  Each lane runs until its
own death (a hop without an active selection, after which the lane is
frozen) or ``max_hops``; the lanes run side by side, and the host asks
whether any lane still lives every ``ALIVE_CHECK_EVERY`` hops.  A dead
lane's hop would change nothing, so the result is the lock-step loop's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import visited as visited_set
from repro_torch.kernels.beam_merge.ref import beam_merge_ref
from repro_torch.kernels.gather_dist.ref import gather_dist_ref
from repro_torch.kernels.gather_dist_q.ref import gather_dist_q_ref
from repro_torch.kernels.pq_adc.ref import pq_lut_sum_ref
from repro_torch.quant.pq import adc_lut

INVALID = -1
_INF = float("inf")
ALIVE_CHECK_EVERY = 8


def _radius(ids, dists, excluded, k: int) -> torch.Tensor:
    """(B,) distance of the k-th valid, non-excluded entry (inf if none)."""
    counted = (ids != INVALID) & ~excluded
    at_k = counted & (torch.cumsum(counted.to(torch.int32), dim=1) == k)
    kth = torch.where(at_k, dists, _INF).amin(dim=1)
    return torch.where(at_k.any(dim=1), kth, _INF)


def _first_unchecked(checked, E: int):
    """Positions (B, E) of the E first unchecked entries and whether each
    exists; a missing one is position 0, as the host loop's argmax gives."""
    open_ = ~checked
    rank = torch.cumsum(open_.to(torch.int32), dim=1) - 1
    e = torch.arange(E, device=checked.device)
    hit = open_[:, None, :] & (rank[:, None, :] == e[None, :, None])
    return torch.argmax(hit.to(torch.int32), dim=2), hit.any(dim=2)


def beam_search_ref(adjacency, rows, queries, exclude, ids, dists, checked,
                    excluded, hops, evals, visited=None, *, n_valid: int,
                    k: int, eps1: float, expand_width: int, max_hops: int,
                    squared: bool = False,
                    hop_budget: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None,
                    codebooks: Optional[torch.Tensor] = None):
    """The search from an initialised beam; see ``ops.beam_search`` for
    the arguments.  Returns (ids, dists, checked, excluded, hops, evals,
    visited)."""
    B, L = ids.shape
    E = expand_width
    n_adj, d = adjacency.shape
    lane_pos = torch.arange(L, device=ids.device)
    live = torch.ones((B,), dtype=torch.bool, device=ids.device)
    lut = None if codebooks is None else adc_lut(queries, codebooks)
    for it in range(max_hops):
        if it and it % ALIVE_CHECK_EVERY == 0 and not bool(live.any()):
            break
        bound = _radius(ids, dists, excluded, k) * eps1
        pos, un = _first_unchecked(checked, E)
        sel_id = torch.gather(ids, 1, pos)
        sel_d = torch.gather(dists, 1, pos)
        active = (un & (sel_d <= bound[:, None]) & (sel_id != INVALID)
                  & live[:, None])
        if hop_budget is not None:
            active &= (hops < hop_budget)[:, None]
        live = active.any(dim=1)
        checked = checked | ((lane_pos[None, None, :] == pos[:, :, None])
                             & active[:, :, None]).any(dim=1)

        rows_sel = torch.where(active, sel_id, 0).clamp(0, n_adj - 1)
        flat = adjacency[rows_sel.to(torch.int64)].reshape(B, E * d)
        vmask = (active[:, :, None].expand(B, E, d).reshape(B, E * d)
                 & (flat != INVALID) & (flat < n_valid))
        if E > 1:
            vmask = vmask & visited_set.first_occurrence_mask(flat, vmask)
        if visited is not None:
            ok = vmask & ~visited_set.contains(visited, flat)
        else:
            ok = vmask & ~(flat[:, :, None] == ids[:, None, :]).any(dim=2)
        safe = torch.where(ok, flat, 0)
        if lut is not None:
            nd = pq_lut_sum_ref(rows, lut, safe, squared=squared)
        elif scale is not None:
            nd = gather_dist_q_ref(rows, scale, safe, queries,
                                   squared=squared)
        else:
            nd = gather_dist_ref(rows, safe, queries, squared=squared)
        keep = ok & (nd <= bound[:, None])
        cand_ids = torch.where(keep, flat, INVALID)
        cand_d = torch.where(keep, nd, _INF)
        cand_exc = keep & (cand_ids[:, :, None]
                           == exclude[:, None, :]).any(dim=2)
        hops = hops + active.sum(dim=1, dtype=torch.int32)
        evals = evals + ok.sum(dim=1, dtype=torch.int32)
        if visited is not None:
            visited = visited_set.insert(visited, flat, ok)
        dists, ids, checked, excluded = beam_merge_ref(
            dists, ids, checked, excluded, cand_d, cand_ids,
            torch.zeros_like(cand_exc), cand_exc)
        checked = checked | (ids == INVALID)
    return ids, dists, checked, excluded, hops, evals, visited
