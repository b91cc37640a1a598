"""Dispatch for the fused L2 + top-k kernel (``csrc/l2_topk.cu``), the
brute-force scan behind ``core/baselines/brute_force.py``.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``ref.py``; ``impl="ref"`` takes the plain version on any device (tests and
``chip_smoke.py``).  ``launches`` counts kernel launches.

Replaces ``src/repro/kernels/l2_topk/l2_topk.py:93`` (``l2_topk_pallas``).
Inputs of any float type are cast to float32, as the JAX wrapper casts
them.  The JAX wrapper pads the base with rows of 1e19 and the dims to 128
lanes; the kernel masks its ragged edges instead, so nothing is padded and
no id >= N can come back.  The (B, N) distance matrix never reaches device
memory.  The kernel keeps each query's running top-k in shared memory, so
``k`` is capped at :data:`MAX_K` (the JAX kernel has no cap).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.l2_topk.ref import l2_topk_ref

launches = 0

#: the largest k whose running lists fit a block's shared memory
MAX_K = 2048

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _P, _I, _LL, _I, _I, _I, _P, _P, _P]


def l2_topk(queries: torch.Tensor, base: torch.Tensor, k: int, *,
            squared: bool = False, impl: str = "kernel"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest rows of ``base`` for each query: queries (B, m), base
    (N, m) -> (dists (B, k) float32 ascending, ids (B, k) int32), ties to
    the lower id.  Raises ``ValueError`` for ``k > N``."""
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
    fn = _build.function("l2_topk", "l2_topk_f32", _ARGS)
    stream = torch.cuda.current_stream(base.device).cuda_stream
    rc = fn(queries.data_ptr(), base.data_ptr(), B, N, m, k, int(squared),
            out_d.data_ptr(), out_i.data_ptr(), stream)
    _build.check("l2_topk", rc)
    launches += 1
    return out_d, out_i
