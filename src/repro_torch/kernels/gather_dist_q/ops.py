"""Dispatch for the gather + dequantize + distance kernel
(``csrc/gather_dist_q.cu``) of the sq8 store.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``ref.py``; ``impl="ref"`` takes the plain version on any device (tests and
``chip_smoke.py``).  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_dist_q.ref import gather_dist_q_ref

launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _LL, _I, _P, _P, _P, _P, _I, _I, _I, _P]


def gather_dist_q(codes: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor,
                  queries: torch.Tensor, *, squared: bool = False,
                  impl: str = "kernel") -> torch.Tensor:
    """codes (N, m) int8, scale (m,) float32, ids (B, d) int32, queries
    (B, m) float32 -> (B, d) float32 distances to the dequantized rows
    ``clip(ids, 0, N-1)``."""
    global launches
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    N, m = codes.shape
    B, d = ids.shape
    if (codes.dtype != torch.int8 or scale.dtype != torch.float32
            or queries.dtype != torch.float32):
        raise TypeError(f"gather_dist_q takes int8 codes, a float32 scale and "
                        f"float32 queries, not {codes.dtype}, {scale.dtype}, "
                        f"{queries.dtype}")
    if (ids.dtype != torch.int32 or tuple(scale.shape) != (m,)
            or tuple(queries.shape) != (B, m)):
        raise ValueError(f"bad operands: ids {ids.dtype} {tuple(ids.shape)}, "
                         f"scale {tuple(scale.shape)}, queries "
                         f"{tuple(queries.shape)}, codes {(N, m)}")
    if impl == "ref" or codes.device.type == "cpu":
        return gather_dist_q_ref(codes, scale, ids, queries, squared=squared)
    if not (codes.is_cuda and all(t.device == codes.device
                                  for t in (scale, ids, queries))):
        raise ValueError("gather_dist_q: all operands must be on one CUDA "
                         "device")
    codes, scale, ids, queries = (codes.contiguous(), scale.contiguous(),
                                  ids.contiguous(), queries.contiguous())
    out = torch.empty((B, d), dtype=torch.float32, device=codes.device)
    fn = _build.function("gather_dist_q", "gather_dist_q_i8", _ARGS)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    rc = fn(codes.data_ptr(), N, m, scale.data_ptr(), ids.data_ptr(),
            queries.data_ptr(), out.data_ptr(), B, d, int(squared), stream)
    _build.check("gather_dist_q", rc)
    launches += 1
    return out
