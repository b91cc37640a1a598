"""The beam engine: the shared inner loop (paper Alg. 1, RangeSearch).

Queries (``core/search.py``), the insert-wave candidate searches (Alg. 3,
``core/build.py``) and exploration all drive this one implementation:

* :class:`BeamState` holds the lock-step beam of ``B`` query lanes: ids /
  dists / checked / excluded, all ``(B, L)`` and sorted ascending by
  ``(dist, stable rank)``, per-lane hop and distance-evaluation counters,
  and optionally a per-lane visited hash set (``core/visited.py``);
* :func:`init` / :func:`expand` / :func:`merge` / :func:`extract` are the
  primitives, composed by :func:`beam_search` into a host loop;
* multi-expansion: ``expand_width=E`` expands the E closest unchecked
  entries per lane per hop;
* the per-hop dedup is the beam broadcast (no visited set) or the visited
  filter (``visited_size > 0``);
* ``hop_backend="fused"`` runs the whole hop body (adjacency gather,
  visited filter, vector gather, distance, compaction) in the
  ``fused_hop`` kernel; ``"composed"`` scores the hop with ``gather_dist``
  (``gather_dist_q`` or ``pq_adc`` over the sq8 or pq store).  Both merge
  with ``beam_merge``, and both give the same results.
* on the card, :func:`search_kernel_eligible` picks the configurations
  whose whole search runs as one launch of the ``beam_search`` kernel in
  place of the host loop: a CUDA tensor, any store (float32, fp16, sq8 or
  pq) and the l2 or sqeuclidean metric, at a beam, exclude list, visited
  table, sq8 scale and pq table that fit one block's shared memory.
  Either hop backend: the fused hop is the composed hop with the visited
  filter, and the kernel runs that.  The host loop keeps the rest: the ip
  and cos metrics, and a beam of thousands of entries or exclude ids.
  The choice is made from the configuration alone, before the search;
  both give the same final state.

Exploration queries (Sec. 6.7) are native: ``exclude`` removes vertices
from the result list (and the radius) while navigation still passes
through them.

Every sort here is stable, as ``jnp.argsort`` is, and every ``argmax`` over
a mask runs on an integer cast of it, so that it picks the first True.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.beam_merge import ops as bm_ops
from repro_torch.kernels.beam_search import ops as bs_ops
from repro_torch.kernels.fused_hop import ops as fh_ops
from repro_torch.kernels.pq_adc import ops as pq_ops
from repro_torch.quant.store import as_store

from . import visited as visited_set
from .distances import get_metric
from .graph import DEGraph, INVALID
from .visited import default_size as default_visited_size  # noqa: F401

_INF = float("inf")
# hops between two host reads of "is any lane still alive?"
ALIVE_CHECK_EVERY = 8
HOP_BACKENDS = ("composed", "fused")


@dataclasses.dataclass(frozen=True)
class BeamState:
    """Lock-step beam over B query lanes (sorted invariant along axis 1)."""

    ids: torch.Tensor        # (B, L) int32, INVALID-padded
    dists: torch.Tensor      # (B, L) float32, inf-padded
    checked: torch.Tensor    # (B, L) bool — expanded (or never-expandable)
    excluded: torch.Tensor   # (B, L) bool — in the beam, banned from results
    hops: torch.Tensor       # (B,) int32 — expanded vertices
    evals: torch.Tensor      # (B,) int32 — distance evaluations
    visited: Optional[torch.Tensor] = None   # (B, V) int32 table or None

    @property
    def width(self) -> int:
        return self.ids.shape[1]


def _eps1(eps: float) -> float:
    """1 + eps rounded to float32, as the JAX engine forms it."""
    return float(np.float32(1.0 + eps))


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along axis 1 (0 when none)."""
    return torch.argmax(mask.to(torch.int32), dim=1)


def in_set(ids: torch.Tensor, excl: torch.Tensor) -> torch.Tensor:
    """ids (B, L), excl (B, X) -> bool (B, L) membership (INVALID never
    a member)."""
    hit = (ids[:, :, None] == excl[:, None, :]).any(dim=2)
    return hit & (ids != INVALID)


def radius(state: BeamState, k: int) -> torch.Tensor:
    """k-th best non-excluded distance per lane (inf if fewer than k)."""
    ok = (state.ids != INVALID) & ~state.excluded
    cnt = torch.cumsum(ok.to(torch.int32), dim=1)
    at_k = ok & (cnt == k)
    kth = torch.where(at_k, state.dists, _INF).amin(dim=1)
    return torch.where(at_k.any(dim=1), kth, _INF)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def init(vectors, queries: torch.Tensor, seed_ids: torch.Tensor,
         exclude: torch.Tensor, n_valid: int, *, beam_width: int,
         metric: str, visited_size: int = 0) -> BeamState:
    """Seed the beam: dedup seeds per lane, score them, sort, pad to L.
    ``visited_size > 0`` also allocates the per-lane visited set and records
    the seeds in it."""
    B, S = seed_ids.shape
    L = beam_width
    dev = queries.device
    store = as_store(vectors)

    seed_valid = (seed_ids != INVALID) & (seed_ids < n_valid)
    # dedup seeds within each lane (keep the first occurrence)
    first_pos = torch.argmax(
        (seed_ids[:, :, None] == seed_ids[:, None, :]).to(torch.int32), dim=2)
    seed_valid &= first_pos == torch.arange(S, device=dev)[None, :]
    safe_seeds = torch.where(seed_valid, seed_ids, 0)
    seed_d = get_metric(metric).pair(queries[:, None, :],
                                     store.decode(safe_seeds))
    seed_d = torch.where(seed_valid, seed_d, _INF)
    seed_ids_m = torch.where(seed_valid, seed_ids, INVALID)

    pad = L - S
    ids = torch.cat([seed_ids_m, torch.full((B, pad), INVALID,
                                            dtype=torch.int32, device=dev)], 1)
    dists = torch.cat([seed_d, torch.full((B, pad), _INF, device=dev)], 1)
    checked = ids == INVALID        # invalid slots are never selected
    excl = in_set(ids, exclude)

    vis = None
    if visited_size:
        vis = visited_set.make_table(B, visited_size, dev)
        vis = visited_set.insert(vis, seed_ids_m, seed_valid)

    order = torch.argsort(dists, dim=1, stable=True)
    return BeamState(
        ids=torch.gather(ids, 1, order), dists=torch.gather(dists, 1, order),
        checked=torch.gather(checked, 1, order),
        excluded=torch.gather(excl, 1, order),
        hops=torch.zeros((B,), dtype=torch.int32, device=dev),
        evals=seed_valid.sum(dim=1, dtype=torch.int32), visited=vis)


def merge(state: BeamState, cand_ids: torch.Tensor, cand_dists: torch.Tensor,
          cand_exc: torch.Tensor) -> BeamState:
    """Fold (B, C) scored candidates into the beam, keeping the sorted
    invariant.  Newly merged INVALID slots become checked."""
    d, ids, chk, exc = bm_ops.beam_merge(
        state.dists, state.ids, state.checked, state.excluded,
        cand_dists, cand_ids, cand_exc)
    chk = chk | (ids == INVALID)
    return dataclasses.replace(state, ids=ids, dists=d, checked=chk,
                               excluded=exc)


def _select_unchecked(state: BeamState, expand_width: int):
    """Positions of the E closest unchecked beam entries per lane:
    (positions (B, E) int64, was_unchecked (B, E) bool).  The beam is
    sorted, so "closest unchecked" is "first unchecked"."""
    B = state.ids.shape[0]
    lane = torch.arange(B, device=state.ids.device)
    open_ = ~state.checked
    pos_list, un_list = [], []
    for _ in range(expand_width):
        p = _first_true(open_)
        pos_list.append(p)
        un_list.append(open_.any(dim=1))
        open_ = open_.clone()
        open_[lane, p] = False
    return torch.stack(pos_list, dim=1), torch.stack(un_list, dim=1)


def expand(state: BeamState, adjacency: torch.Tensor, n_valid: int,
           vectors, queries: torch.Tensor, exclude: torch.Tensor, *, k: int,
           eps: float, metric: str, expand_width: int = 1,
           hop_backend: str = "composed",
           hop_budget: Optional[torch.Tensor] = None) -> BeamState:
    """One hop: expand each lane's ``expand_width`` closest unchecked
    entries (Alg. 1 lines 8-15) and merge their scored neighbors into the
    beam.

    The dedup of fresh neighbors is the beam broadcast when
    ``state.visited is None`` and the visited filter otherwise.
    ``hop_backend="fused"`` runs the hop in the ``fused_hop`` kernel (needs
    the visited filter, an exact store and an l2 metric; otherwise the
    composed hop runs, with the same results).  ``hop_budget`` (B,) caps
    each lane's expansions (a lane may overshoot by up to E-1)."""
    B, L = state.ids.shape
    E = expand_width
    d = adjacency.shape[1]
    eps1 = _eps1(eps)
    r = radius(state, k)
    store = as_store(vectors)

    cur, sel_unchecked = _select_unchecked(state, E)
    sel_id = torch.gather(state.ids, 1, cur)
    sel_d = torch.gather(state.dists, 1, cur)
    active = (sel_unchecked & (sel_d <= (r * eps1)[:, None])
              & (sel_id != INVALID))
    if hop_budget is not None:
        active &= (state.hops < hop_budget)[:, None]

    # scatter-max == OR: marks active selections checked; inactive (or
    # duplicate, on exhausted lanes) selections are no-ops
    checked = state.checked.to(torch.uint8).scatter_reduce(
        1, cur, active.to(torch.uint8), "amax", include_self=True).bool()

    use_visited = state.visited is not None
    if (hop_backend == "fused" and use_visited and store.exact
            and metric in ("l2", "sqeuclidean")):
        cand_ids, cand_d, nbr_out, evals_inc = fh_ops.fused_hop(
            adjacency, store.data, torch.where(active, sel_id, INVALID),
            queries, r * eps1, state.visited, n_valid=n_valid,
            squared=metric == "sqeuclidean")
        cand_exc = in_set(cand_ids, exclude) & (cand_ids != INVALID)
        new_visited = visited_set.insert(state.visited, nbr_out,
                                         nbr_out != INVALID)
    else:
        rows = torch.where(active, sel_id, 0).reshape(-1)
        nbrs = adjacency.index_select(0, rows).reshape(B, E, d)
        valid = active[:, :, None] & (nbrs != INVALID) & (nbrs < n_valid)
        flat = nbrs.reshape(B, E * d)
        vmask = valid.reshape(B, E * d)
        if use_visited:
            if E > 1:
                # two expanded vertices may share a neighbor: keep the
                # first occurrence among valid ids
                vmask = vmask & visited_set.first_occurrence_mask(flat, vmask)
            ok = vmask & ~visited_set.contains(state.visited, flat)
        elif E > 1:
            in_beam = (flat[:, :, None] == state.ids[:, None, :]).any(dim=2)
            ok = (vmask & ~in_beam
                  & visited_set.first_occurrence_mask(flat, vmask))
        else:
            ok = vmask & ~(flat[:, :, None]
                           == state.ids[:, None, :]).any(dim=2)   # dedup
        safe = torch.where(ok, flat, 0)
        nd = store.neighbor_distances(queries, safe, metric)
        nd = torch.where(ok, nd, _INF)
        keep = ok & (nd <= r[:, None] * eps1)                     # line 12
        cand_ids = torch.where(keep, flat, INVALID)
        cand_d = torch.where(keep, nd, _INF)
        cand_exc = in_set(cand_ids, exclude) & keep
        evals_inc = ok.sum(dim=1, dtype=torch.int32)
        new_visited = (visited_set.insert(state.visited, flat, ok)
                       if use_visited else state.visited)

    state = dataclasses.replace(
        state, checked=checked,
        hops=state.hops + active.sum(dim=1, dtype=torch.int32),
        evals=state.evals + evals_inc, visited=new_visited)
    return merge(state, cand_ids, cand_d, cand_exc)


def alive(state: BeamState, *, k: int, eps: float,
          hop_budget: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) bool: does the lane still have an expandable entry within the
    range radius?  A lane whose ``hop_budget`` is spent is dead."""
    r = radius(state, k)
    nxt = _first_true(~state.checked)
    nxt_d = torch.gather(state.dists, 1, nxt[:, None])[:, 0]
    live = (~state.checked.all(dim=1)) & (nxt_d <= r * _eps1(eps))
    if hop_budget is not None:
        live &= state.hops < hop_budget
    return live


def extract(state: BeamState, k: int, *, dedup: bool = False):
    """Top-k non-excluded results: (ids (B, k), dists (B, k)).  The sort is
    stable; ``dedup`` masks repeated ids (keeping the first), the safety net
    for visited-filter searches."""
    final_d = torch.where(state.excluded | (state.ids == INVALID), _INF,
                          state.dists)
    if dedup:
        first = visited_set.first_occurrence_mask(state.ids,
                                                  state.ids != INVALID)
        final_d = torch.where(first, final_d, _INF)
    order = torch.argsort(final_d, dim=1, stable=True)[:, :k]
    out_ids = torch.gather(state.ids, 1, order)
    out_d = torch.gather(final_d, 1, order)
    out_ids = torch.where(torch.isinf(out_d), INVALID, out_ids)
    return out_ids, out_d


# ---------------------------------------------------------------------------
# the composed program
# ---------------------------------------------------------------------------
def search_kernel_eligible(vectors, metric: str, hop_backend: str, device,
                           *, beam_width: int = 0, degree: int = 0,
                           expand_width: int = 1, n_exclude: int = 0,
                           visited_size: int = 0) -> bool:
    """Does :func:`beam_search` run as one ``beam_search`` kernel launch?
    On a CUDA device, for either hop backend over a float32 (float32,
    float16 or bfloat16 rows), fp16, sq8 or pq store (of at most
    ``MAX_SUBSPACES`` subspaces) under the l2 or sqeuclidean metric, when
    one lane's beam of ``beam_width`` entries, its ``expand_width`` x
    ``degree`` candidates, its ``n_exclude`` excluded ids, its
    ``visited_size``-slot table, the sq8 store's scale and the pq
    store's sub-distance table fit the shared memory of one block;
    everything else runs the host loop.  The shapes default to an empty
    beam, for a caller that asks about the configuration alone."""
    store = as_store(vectors)
    m_sub = store.data.shape[1] if store.codec == "pq" else 0
    return (torch.device(device).type == "cuda"
            and hop_backend in HOP_BACKENDS
            and store.codec in ("float32", "fp16", "sq8", "pq")
            and metric in ("l2", "sqeuclidean")
            and m_sub <= pq_ops.MAX_SUBSPACES
            and bs_ops.smem_bytes(store.dim, beam_width,
                                  expand_width * degree, n_exclude,
                                  visited_size, expand_width, m_sub,
                                  store.codec == "sq8")
            <= bs_ops.MAX_SMEM)


def beam_search(graph: DEGraph, vectors, queries: torch.Tensor,
                seed_ids: torch.Tensor, *, k: int, eps: float,
                beam_width: int, max_hops: int, metric: str = "l2",
                exclude: Optional[torch.Tensor] = None,
                expand_width: int = 1, visited_size: int = 0,
                hop_backend: str = "composed",
                hop_budget: Optional[torch.Tensor] = None) -> BeamState:
    """init -> expand until no lane is alive or ``max_hops`` -> final state.

    Where :func:`search_kernel_eligible` holds, one ``beam_search`` launch
    runs every lane's hops to its own end.  Otherwise the loop runs on the
    host and asks the device whether any lane is alive once every
    ``ALIVE_CHECK_EVERY`` hops, never past ``max_hops``.  A dead lane is a
    fixed point of :func:`expand` (no active selection, and merging
    all-inf candidates keeps the beam), so the extra hops change no result
    and both give the same state."""
    if expand_width < 1:
        raise ValueError(f"expand_width must be >= 1, got {expand_width}")
    if hop_backend not in HOP_BACKENDS:
        raise ValueError(f"hop_backend must be one of {HOP_BACKENDS}")
    expand_width = min(expand_width, beam_width)
    if hop_backend == "fused" and not visited_size:
        raise ValueError("hop_backend='fused' requires the visited filter: "
                         "pass visited_size > 0")
    B = queries.shape[0]
    if exclude is None:
        exclude = torch.full((B, 1), INVALID, dtype=torch.int32,
                             device=queries.device)
    state = init(vectors, queries, seed_ids, exclude, graph.n,
                 beam_width=beam_width, metric=metric,
                 visited_size=visited_size)
    if search_kernel_eligible(vectors, metric, hop_backend, queries.device,
                              beam_width=state.width,
                              degree=graph.adjacency.shape[1],
                              expand_width=expand_width,
                              n_exclude=exclude.shape[1],
                              visited_size=(0 if state.visited is None
                                            else state.visited.shape[1])):
        store = as_store(vectors)
        return BeamState(*bs_ops.beam_search(
            graph.adjacency, store.data, queries, exclude, state.ids,
            state.dists, state.checked, state.excluded, state.hops,
            state.evals, state.visited, n_valid=graph.n, k=k,
            eps1=_eps1(eps), expand_width=expand_width, max_hops=max_hops,
            squared=metric == "sqeuclidean", hop_budget=hop_budget,
            scale=store.scale, codebooks=store.codebooks))
    return host_loop(state, graph, vectors, queries, exclude, k=k, eps=eps,
                     max_hops=max_hops, metric=metric,
                     expand_width=expand_width, hop_backend=hop_backend,
                     hop_budget=hop_budget)


def host_loop(state: BeamState, graph: DEGraph, vectors,
              queries: torch.Tensor, exclude: torch.Tensor, *, k: int,
              eps: float, max_hops: int, metric: str, expand_width: int,
              hop_backend: str,
              hop_budget: Optional[torch.Tensor] = None) -> BeamState:
    """The loop of :func:`beam_search` on the host, from an initialised
    beam: :func:`expand` in steps of ``ALIVE_CHECK_EVERY`` hops, then one
    read of "any lane alive?", never past ``max_hops``."""
    it = 0
    while it < max_hops:
        for _ in range(min(ALIVE_CHECK_EVERY, max_hops - it)):
            state = expand(state, graph.adjacency, graph.n, vectors, queries,
                           exclude, k=k, eps=eps, metric=metric,
                           expand_width=expand_width, hop_backend=hop_backend,
                           hop_budget=hop_budget)
            it += 1
        if not bool(alive(state, k=k, eps=eps, hop_budget=hop_budget).any()):
            break
    return state


def default_beam_width(k: int, degree: int, n_seeds: int,
                       n_exclude: int = 0) -> int:
    """The L heuristic shared by every driver (seed semantics)."""
    L = max(k + degree, 2 * k)
    L = max(L, k, n_seeds)
    if n_exclude:
        L = max(L, k + n_exclude)
    return L


def default_max_hops(beam_width: int) -> int:
    return 4 * beam_width + 64

