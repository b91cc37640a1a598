"""Dispatch for the fused L2 + top-k kernel (``csrc/l2_topk.cu``), the
brute-force scan behind ``core/baselines/brute_force.py``.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``ref.py``; ``impl="ref"`` takes the plain version on any device (tests and
``chip_smoke.py``).  ``launches`` counts calls that launch the kernel: a
scan, and a merge of its splits where there are several (1-2 kernels a
call).

Replaces ``src/repro/kernels/l2_topk/l2_topk.py:93`` (``l2_topk_pallas``).
Inputs of any float type are cast to float32, as the JAX wrapper casts
them.  The JAX wrapper pads the base with rows of 1e19 and the dims to 128
lanes; the kernel masks its ragged edges instead, so nothing is padded and
no id >= N can come back.  The (B, N) distance matrix never reaches device
memory.  The kernel keeps each query's running top-k in shared memory, so
``k`` is capped at :data:`MAX_K` (the JAX kernel has no cap).

:func:`plan_splits` is the plan the kernel runs: the block shape (TQ
queries by TN base rows a tile) and the cut of the base's tiles into S
ranges, each scanned by its own blocks and merged after, so that
``ceil(B / TQ) * S`` blocks fill the card at any B.  It is plain Python,
so the CPU tests reach it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.l2_topk.ref import l2_topk_ref

launches = 0

#: the largest k whose running lists fit a block's shared memory
MAX_K = 2048
#: csrc/l2_topk.cu's block shapes (Wide, Mid, Narrow): TQ queries -> TN
#: base rows a tile, and the largest k and least B a shape takes (Narrow
#: takes the rest); chunks of 32 dims are staged two at a time
TILE_ROWS = {128: 128, 32: 128, 8: 256}
MAX_K_OF = {128: 32, 32: 256, 8: MAX_K}
MIN_B_OF = {128: 4096, 32: 32, 8: 1}
#: lists of k <= BULK_MAX_K merge a tile row's many candidates at once,
#: through a scratch row a warp
BULK_MAX_K = 256
#: the merge holds a query's S lists of k in shared memory: S * k entries
MERGE_ENTRIES = 4096
MAX_SPLITS = 256
#: H100 SXM: streaming multiprocessors, shared memory an SM holds, and
#: what each resident block reserves of it
H100_SMS = 132
SMEM_PER_SM, SMEM_RESERVED = 233_472, 1_024
#: blocks an SM can hold by registers (the kernels' __launch_bounds__)
REG_BLOCKS = {128: 1, 32: 2, 8: 2}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _P, _I, _LL, _I, _I, _I, _I, _I, _LL, _P, _P, _P, _P, _P]


@dataclass(frozen=True)
class SplitPlan:
    """``tq`` queries by ``tn`` base rows a block tile; the base's
    ``ceil(N / tn)`` tiles cut into ``splits`` ranges of ``split_tiles``
    tiles (the last may be shorter, none is empty)."""
    tq: int
    tn: int
    splits: int
    split_tiles: int

    def ranges(self, N: int) -> list[tuple[int, int]]:
        """The row range [start, end) of each split."""
        w = self.split_tiles * self.tn
        return [(s * w, min(N, (s + 1) * w)) for s in range(self.splits)]


def smem_bytes(tq: int, k: int) -> int:
    """Dynamic shared memory of a scan block (``Shape::smem_bytes``)."""
    tn = TILE_ROWS[tq]
    return (4 * (2 * (tq + tn) * 36 + tq * tn + tn + tq)
            + tq * k * 8 + 12 * tq + (64 * tn if k <= BULK_MAX_K else 0))


def blocks_per_sm(tq: int, k: int) -> int:
    return max(1, min(REG_BLOCKS[tq],
                      SMEM_PER_SM // (smem_bytes(tq, k) + SMEM_RESERVED)))


def plan_splits(B: int, N: int, k: int, sms: int,
                splits: int | None = None) -> SplitPlan:
    """The block shape and split of the scan for B queries over N rows on
    a card of ``sms`` SMs.  The block shape is the widest that takes
    (B, k): Wide (128 queries by 128 rows, an 8 x 8 register tile a thread)
    for k <= 32 and B >= 4096, Mid (32 by 128, 4 x 4) for k <= 256 and
    B >= 32, Narrow (8 by 256, 8 x 1) for the rest; wider tiles read the
    base fewer times, narrower ones merge fewer lists a warp.  S minimises the scan's time in
    tiles, ceil(blocks / resident blocks) waves of ceil(tiles / S) + 1
    tiles (the 1 is a split's fill of its lists), fewer splits on a tie;
    S * k <= MERGE_ENTRIES and S <= MAX_SPLITS.  ``splits`` forces S (the
    kernel's output is bit-identical for every S).  S is then rounded so
    that every split holds ``split_tiles`` tiles but the last."""
    if B < 1 or N < 1 or not 1 <= k <= min(N, MAX_K):
        raise ValueError(f"no scan plan for B={B} N={N} k={k}")
    tq = next(t for t in TILE_ROWS if k <= MAX_K_OF[t] and B >= MIN_B_OF[t])
    tn = TILE_ROWS[tq]
    n_tiles = -(-N // tn)
    s_max = max(1, min(n_tiles, MAX_SPLITS, MERGE_ENTRIES // k))
    if splits is None:
        slots = sms * blocks_per_sm(tq, k)
        q_tiles = -(-B // tq)
        S = min(range(1, s_max + 1), key=lambda s: (
            -(-q_tiles * s // slots) * (-(-n_tiles // s) + 1), s))
    elif 1 <= splits <= s_max:
        S = splits
    else:
        raise ValueError(f"splits={splits} outside [1, {s_max}] for "
                         f"B={B} N={N} k={k}")
    st = -(-n_tiles // S)
    return SplitPlan(tq, tn, -(-n_tiles // st), st)


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device; an H100's for any other
    (a plan made on the CPU is the one the card would run)."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def l2_topk(queries: torch.Tensor, base: torch.Tensor, k: int, *,
            squared: bool = False, impl: str = "kernel",
            splits: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest rows of ``base`` for each query: queries (B, m), base
    (N, m) -> (dists (B, k) float32 ascending, ids (B, k) int32), ties to
    the lower id.  Raises ``ValueError`` for ``k > N``.  ``splits`` forces
    the kernel's number of base splits (see :func:`plan_splits`); the plain
    version does not split."""
    global launches
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    if (queries.dim() != 2 or base.dim() != 2
            or queries.shape[1] != base.shape[1]):
        raise ValueError(f"bad operands: queries {tuple(queries.shape)}, "
                         f"base {tuple(base.shape)}")
    if not (queries.is_floating_point() and base.is_floating_point()):
        raise TypeError(f"l2_topk takes float rows, not {queries.dtype} "
                        f"queries and {base.dtype} rows")
    B, m = queries.shape
    N = base.shape[0]
    if k > N:
        raise ValueError(f"k={k} > N={N}")
    if k < 0:
        raise ValueError(f"k={k} < 0")
    if splits is not None and B and k:
        plan_splits(B, N, k, H100_SMS, splits)       # refuses a bad S
    queries = queries.to(torch.float32)
    base = base.to(torch.float32)
    if impl == "ref" or base.device.type == "cpu":
        return l2_topk_ref(queries, base, k, squared=squared)
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the kernel's {MAX_K}")
    if N >= 2 ** 31:
        raise ValueError(f"N={N} rows do not fit int32 ids")
    if not (base.is_cuda and queries.device == base.device):
        raise ValueError("l2_topk: both operands must be on one CUDA device")
    queries, base = queries.contiguous(), base.contiguous()
    out_d = torch.empty((B, k), dtype=torch.float32, device=base.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=base.device)
    if B == 0 or k == 0:
        return out_d, out_i
    if m == 0:
        raise ValueError("l2_topk: rows of width 0")
    plan = plan_splits(B, N, k, sm_count(base.device), splits)
    part_d = part_i = None
    if plan.splits > 1:
        part_d = torch.empty((B, plan.splits, k), dtype=torch.float32,
                             device=base.device)
        part_i = torch.empty((B, plan.splits, k), dtype=torch.int32,
                             device=base.device)
    fn = _build.function("l2_topk", "l2_topk_f32", _ARGS)
    stream = torch.cuda.current_stream(base.device).cuda_stream
    rc = fn(queries.data_ptr(), base.data_ptr(), B, N, m, k, int(squared),
            plan.tq, plan.splits, plan.split_tiles,
            None if part_d is None else part_d.data_ptr(),
            None if part_i is None else part_i.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), stream)
    _build.check("l2_topk", rc)
    launches += 1
    return out_d, out_i
