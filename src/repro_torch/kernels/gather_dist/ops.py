"""Dispatch for the gather + distance kernel (``csrc/gather_dist.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``ref.py``; ``impl="ref"`` takes the plain version on any device (tests and
``chip_smoke.py``).  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_dist.ref import gather_dist_ref

launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _LL, _I, _P, _P, _P, _I, _I, _I, _P]


def gather_dist(vectors: torch.Tensor, ids: torch.Tensor,
                queries: torch.Tensor, *, squared: bool = False,
                impl: str = "kernel") -> torch.Tensor:
    """vectors (N, m) float32, ids (B, d) int32, queries (B, m) float32 ->
    (B, d) float32 distances to the rows ``clip(ids, 0, N-1)``."""
    global launches
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    N, m = vectors.shape
    B, d = ids.shape
    if vectors.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("gather_dist takes float32 rows and queries; "
                        "half-width rows come with ROADMAP queue A6")
    if ids.dtype != torch.int32 or tuple(queries.shape) != (B, m):
        raise ValueError(f"bad operands: ids {ids.dtype} {tuple(ids.shape)}, "
                         f"queries {tuple(queries.shape)}, rows {(N, m)}")
    if impl == "ref" or vectors.device.type == "cpu":
        return gather_dist_ref(vectors, ids, queries, squared=squared)
    if not (vectors.is_cuda and ids.device == vectors.device
            and queries.device == vectors.device):
        raise ValueError("gather_dist: all operands must be on one CUDA device")
    vectors, ids, queries = (vectors.contiguous(), ids.contiguous(),
                             queries.contiguous())
    out = torch.empty((B, d), dtype=torch.float32, device=vectors.device)
    fn = _build.function("gather_dist", "gather_dist_f32", _ARGS)
    stream = torch.cuda.current_stream(vectors.device).cuda_stream
    rc = fn(vectors.data_ptr(), N, m, ids.data_ptr(), queries.data_ptr(),
            out.data_ptr(), B, d, int(squared), stream)
    _build.check("gather_dist", rc)
    launches += 1
    return out
