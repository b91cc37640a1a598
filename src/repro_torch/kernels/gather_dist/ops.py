"""Dispatch for the gather + distance kernel (``csrc/gather_dist.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``ref.py``; ``impl="ref"`` takes the plain version on any device (tests and
``chip_smoke.py``).  ``launches`` counts kernel launches; ``launches_f16``
counts the launches on fp16 rows among them.

Rows may be float32, float16 or bfloat16: half rows stay half width in
device memory and are upcast in the kernel.  Queries are float32; for
bfloat16 rows they are first rounded to bfloat16, as the JAX package casts
them to the store's type.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_dist.ref import gather_dist_ref

launches = 0
launches_f16 = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _LL, _I, _P, _P, _P, _I, _I, _I, _P]
_SYMBOL = {torch.float32: "gather_dist_f32", torch.float16: "gather_dist_f16",
           torch.bfloat16: "gather_dist_bf16"}


def gather_dist(vectors: torch.Tensor, ids: torch.Tensor,
                queries: torch.Tensor, *, squared: bool = False,
                impl: str = "kernel") -> torch.Tensor:
    """vectors (N, m) float32 / float16 / bfloat16, ids (B, d) int32,
    queries (B, m) float32 -> (B, d) float32 distances to the rows
    ``clip(ids, 0, N-1)``."""
    global launches, launches_f16
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    N, m = vectors.shape
    B, d = ids.shape
    if vectors.dtype not in _SYMBOL or queries.dtype != torch.float32:
        raise TypeError(f"gather_dist takes float32, float16 or bfloat16 "
                        f"rows and float32 queries, not {vectors.dtype} rows "
                        f"and {queries.dtype} queries")
    if ids.dtype != torch.int32 or tuple(queries.shape) != (B, m):
        raise ValueError(f"bad operands: ids {ids.dtype} {tuple(ids.shape)}, "
                         f"queries {tuple(queries.shape)}, rows {(N, m)}")
    if vectors.dtype == torch.bfloat16:
        queries = queries.to(torch.bfloat16).to(torch.float32)
    if impl == "ref" or vectors.device.type == "cpu":
        return gather_dist_ref(vectors, ids, queries, squared=squared)
    if not (vectors.is_cuda and ids.device == vectors.device
            and queries.device == vectors.device):
        raise ValueError("gather_dist: all operands must be on one CUDA device")
    vectors, ids, queries = (vectors.contiguous(), ids.contiguous(),
                             queries.contiguous())
    out = torch.empty((B, d), dtype=torch.float32, device=vectors.device)
    fn = _build.function("gather_dist", _SYMBOL[vectors.dtype], _ARGS)
    stream = torch.cuda.current_stream(vectors.device).cuda_stream
    rc = fn(vectors.data_ptr(), N, m, ids.data_ptr(), queries.data_ptr(),
            out.data_ptr(), B, d, int(squared), stream)
    _build.check("gather_dist", rc)
    launches += 1
    launches_f16 += vectors.dtype == torch.float16
    return out
