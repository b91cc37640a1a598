"""Plain PyTorch version of the fused multi-expansion hop: the batch
formulation of what ``csrc/fused_hop.cu`` computes per lane, and what the
beam engine's composed hop computes with the visited filter on."""
from __future__ import annotations

import torch

from repro_torch.core.graph import INVALID
from repro_torch.core.visited import (DEFAULT_PROBES, contains,
                                      first_occurrence_mask)


def fused_hop_ref(adjacency, vectors, sel_ids, queries, dmax, visited=None,
                  *, n_valid: int, squared: bool = False,
                  n_probes: int = DEFAULT_PROBES):
    """One multi-expansion hop for B lanes.

    Args:
      adjacency: (N, d) int32, INVALID-padded rows.
      vectors: (Nv, m) float32 store rows.
      sel_ids: (B, E) int32 vertices to expand (INVALID = inactive slot;
        other ids are clipped to [0, N)).
      queries: (B, m) float32.
      dmax: (B,) float32 keep threshold (the engine passes
        ``radius * (1 + eps)``).
      visited: (B, V) int32 visited table, or None (no filtering).
      n_valid: neighbors >= n_valid are invalid.
    Returns:
      cand_ids (B, E*d) int32, kept candidates compacted to the front in
        discovery order (e-major, j-minor), INVALID-padded;
      cand_dists (B, E*d) float32, matching distances, inf-padded;
      nbr_ids (B, E*d) int32, the gathered neighbor ids, valid-masked;
      evals (B,) int32, distance evaluations performed.
    """
    B, E = sel_ids.shape
    N, d = adjacency.shape
    act = sel_ids != INVALID
    rows = torch.where(act, sel_ids.clamp(0, N - 1), 0).to(torch.int64)
    nbrs = adjacency[rows]                                    # (B, E, d)
    valid = act[:, :, None] & (nbrs != INVALID) & (nbrs < n_valid)
    flat = nbrs.reshape(B, E * d)
    vmask = valid.reshape(B, E * d)

    scored = vmask & first_occurrence_mask(flat, vmask)
    if visited is not None:
        scored &= ~contains(visited, flat, n_probes=n_probes)

    safe = torch.where(scored, flat, 0).clamp(0, vectors.shape[0] - 1)
    g = vectors[safe.to(torch.int64)].to(torch.float32)       # (B, Ed, m)
    diff = g - queries.to(torch.float32)[:, None, :]
    d2 = torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0)
    nd = d2 if squared else torch.sqrt(d2)
    nd = torch.where(scored, nd, torch.inf)
    keep = scored & (nd <= dmax[:, None])

    # stable compaction: kept candidates first, discovery order preserved
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    cand_ids = torch.gather(torch.where(keep, flat, INVALID), 1, order)
    cand_d = torch.gather(torch.where(keep, nd, torch.inf), 1, order)
    nbr_out = torch.where(vmask, flat, INVALID)
    return cand_ids, cand_d, nbr_out, scored.sum(dim=1, dtype=torch.int32)
