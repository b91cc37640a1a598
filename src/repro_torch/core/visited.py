"""Per-lane visited filter for the multi-expansion beam engine.

A fixed-size open-addressing hash set per query lane, carried in
:class:`repro_torch.core.beam.BeamState`:

* membership is ``P = n_probes`` gathered compares per candidate;
* insertion is ``P`` rounds of deterministic parallel claiming: empty slots
  (``INVALID`` = -1) are claimed with a scatter-``amax``, so same-slot races
  resolve to the largest id whatever the order, and losers retry at their
  next probe position;
* the table is best-effort: an id whose probes are all taken is dropped.
  A dropped insert can only cost a re-scored candidate later, never a
  missed vertex.

Tables are bit-identical to the JAX package's, because the layout decides
``evals`` once a table saturates.  The probe hash is uint32 arithmetic
that wraps modulo 2^32; torch has no uint32 multiply, so it runs in int64
with the multiply split into 16-bit halves (``0xFFFFFFFF * 2654435761``
does not fit in int64).  ``kernels/csrc/fused_hop.cu`` computes the same
probes in native uint32.
"""
from __future__ import annotations

import torch

from .graph import INVALID, pow2_bucket

# Knuth multiplicative hash + a golden-ratio second hash (forced odd) for
# double hashing; the table size is a power of two so ``& (V - 1)`` folds.
_MULT1 = 2654435761        # 2^32 / phi, Knuth
_MULT2 = 0x9E3779B1        # golden-ratio constant
_U32 = 0xFFFFFFFF
DEFAULT_PROBES = 4


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _U32


def probe_positions(ids: torch.Tensor, n_slots: int,
                    n_probes: int) -> torch.Tensor:
    """(...,) int ids -> (..., P) int64 slot positions in [0, n_slots).
    ``n_slots`` must be a power of two."""
    x = ids.to(torch.int64) & _U32                 # the uint32 view of the id
    h1 = _mul_u32(x, _MULT1)
    h2 = _mul_u32(x, _MULT2) | 1                   # odd stride
    t = torch.arange(n_probes, dtype=torch.int64, device=ids.device)
    return (h1[..., None] + t * h2[..., None]) & (n_slots - 1)


def make_table(batch: int, n_slots: int, device="cuda") -> torch.Tensor:
    """Empty (B, V) table (all INVALID), V rounded up to a power of two."""
    return torch.full((batch, pow2_bucket(n_slots)), INVALID,
                      dtype=torch.int32, device=device)


def _probe_values(table, pos):
    B, C, P = pos.shape
    return torch.gather(table, 1, pos.reshape(B, C * P)).reshape(B, C, P)


def contains(table: torch.Tensor, ids: torch.Tensor, *,
             n_probes: int = DEFAULT_PROBES) -> torch.Tensor:
    """(B, V) table, (B, C) ids -> (B, C) bool membership (INVALID never a
    member)."""
    pos = probe_positions(ids, table.shape[1], n_probes)
    vals = _probe_values(table, pos)
    return (vals == ids[..., None]).any(dim=-1) & (ids != INVALID)


def insert(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, *,
           n_probes: int = DEFAULT_PROBES) -> torch.Tensor:
    """Insert ``ids`` where ``mask`` into each lane's table (best-effort);
    returns a new table.

    Ids already present in their probe sequence are skipped.  The rest run
    P rounds of probe-claim: in round t every unplaced id reads its slot
    ``pos[..., t]`` and claims it if empty via scatter-``amax`` (the
    largest id wins a race; the loser retries at its next probe)."""
    pos = probe_positions(ids, table.shape[1], n_probes)   # (B, C, P)
    vals = _probe_values(table, pos)
    present = (vals == ids[..., None]).any(dim=-1)
    need = mask & (ids != INVALID) & ~present
    table = table.clone()
    ids = ids.to(table.dtype)
    for t in range(n_probes):
        p = pos[..., t]
        cur = torch.gather(table, 1, p)
        need = need & (cur != ids)       # a same-batch duplicate placed it
        claim = need & (cur == INVALID)
        table.scatter_reduce_(1, p, torch.where(claim, ids, INVALID),
                              "amax", include_self=True)
        placed = torch.gather(table, 1, p) == ids
        need = need & ~placed
    return table


def first_occurrence_mask(ids: torch.Tensor, valid: torch.Tensor
                          ) -> torch.Tensor:
    """(B, C) bool: is position j the first occurrence of ``ids[b, j]``
    among the valid positions of lane b?  Masked positions get unique
    negative sentinels so they never alias each other or real ids."""
    C = ids.shape[1]
    sent = -(torch.arange(C, dtype=ids.dtype, device=ids.device) + 2)
    tagged = torch.where(valid, ids, sent[None, :])
    lower = torch.ones((C, C), dtype=torch.bool,
                       device=ids.device).tril(-1)    # j' < j
    dup = ((tagged[:, :, None] == tagged[:, None, :]) & lower).any(dim=2)
    return ~dup


def default_size(beam_width: int, degree: int) -> int:
    """Table-size heuristic (a load-factor target, not a capacity)."""
    return pow2_bucket(max(512, beam_width * max(degree, 1)))
