"""Dispatch for the PQ gather + LUT-ADC distance kernel
(``csrc/pq_adc.cu``) of the pq store.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``ref.py``; ``impl="ref"`` takes the plain version on any device (tests and
``chip_smoke.py``).  ``launches`` counts kernel launches.  The kernel
rebuilds each query's table on every call, as the JAX kernel does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pq_adc.ref import pq_adc_ref
from repro_torch.quant.pq import PQ_K

launches = 0

#: the most subspaces the JAX kernel's 128 subspace lanes take
MAX_SUBSPACES = 128

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _LL, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P]


def check_store(codes: torch.Tensor, codebooks: torch.Tensor) -> int:
    """The pq store as the kernels take it (``pq_adc`` and
    ``beam_search``): (N, m_sub) uint8 codes and (m_sub, 256, dsub)
    float32 codebooks, at most MAX_SUBSPACES subspaces.  Returns dsub."""
    m_sub = codes.shape[1]
    if codes.dtype != torch.uint8 or codebooks.dtype != torch.float32:
        raise TypeError(f"the pq store takes uint8 codes and float32 "
                        f"codebooks, not {codes.dtype} and {codebooks.dtype}")
    if codebooks.dim() != 3 or tuple(codebooks.shape[:2]) != (m_sub, PQ_K):
        raise ValueError(f"codes/codebooks disagree: codes m_sub={m_sub}, "
                         f"codebooks {tuple(codebooks.shape)}")
    if m_sub > MAX_SUBSPACES:
        raise ValueError(f"m_sub={m_sub} exceeds the kernel's "
                         f"{MAX_SUBSPACES} subspaces")
    return codebooks.shape[2]


def pq_adc(codes: torch.Tensor, codebooks: torch.Tensor, ids: torch.Tensor,
           queries: torch.Tensor, *, squared: bool = False,
           impl: str = "kernel") -> torch.Tensor:
    """codes (N, m_sub) uint8, codebooks (m_sub, 256, dsub) float32, ids
    (B, d) int32, queries (B, m_sub * dsub) float32 -> (B, d) float32 ADC
    distances to the rows ``clip(ids, 0, N-1)``."""
    global launches
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    N, m_sub = codes.shape
    B, d = ids.shape
    dsub = check_store(codes, codebooks)
    if queries.dtype != torch.float32:
        raise TypeError(f"pq_adc takes float32 queries, not {queries.dtype}")
    if ids.dtype != torch.int32 or tuple(queries.shape) != (B, m_sub * dsub):
        raise ValueError(f"bad operands: ids {ids.dtype} {tuple(ids.shape)}, "
                         f"queries {tuple(queries.shape)}, dim "
                         f"{m_sub * dsub}")
    if impl == "ref" or codes.device.type == "cpu":
        return pq_adc_ref(codes, codebooks, ids, queries, squared=squared)
    if not (codes.is_cuda and all(t.device == codes.device
                                  for t in (codebooks, ids, queries))):
        raise ValueError("pq_adc: all operands must be on one CUDA device")
    codes, codebooks, ids, queries = (codes.contiguous(),
                                      codebooks.contiguous(),
                                      ids.contiguous(), queries.contiguous())
    out = torch.empty((B, d), dtype=torch.float32, device=codes.device)
    fn = _build.function("pq_adc", "pq_adc_u8", _ARGS)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    rc = fn(codes.data_ptr(), N, m_sub, codebooks.data_ptr(), dsub,
            ids.data_ptr(), queries.data_ptr(), out.data_ptr(), B, d,
            int(squared), stream)
    _build.check("pq_adc", rc)
    launches += 1
    return out
