"""Dispatch for the fused multi-expansion hop kernel (``csrc/fused_hop.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``ref.py``; ``impl="ref"`` takes the plain version on any device (tests and
``chip_smoke.py``).  ``launches`` counts kernel launches.  The wrapper
clips the selection ids to ``[0, N)`` and passes the INVALID slots as
explicit activity flags, as ``src/repro/kernels/fused_hop/ops.py`` does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.graph import INVALID
from repro_torch.core.visited import DEFAULT_PROBES
from repro_torch.kernels import _build
from repro_torch.kernels.fused_hop.ref import fused_hop_ref

launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _I, _P, _LL, _I, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I,
         _P, _P, _P, _P, _I, _P]
# nid + dist + flag per position in (default, <= 48 KiB) shared memory,
# beside the kernel's static per-warp counters
_MAX_POSITIONS = (48 * 1024 - 256) // 9


def fused_hop(adjacency, vectors, sel_ids, queries, dmax, visited=None, *,
              n_valid: int, squared: bool = False, impl: str = "kernel"):
    """One multi-expansion hop for B lanes; see ``ref.fused_hop_ref`` for
    the argument and return contract."""
    global launches
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    N, d = adjacency.shape
    B, E = sel_ids.shape
    m = vectors.shape[1]
    if (adjacency.dtype != torch.int32 or sel_ids.dtype != torch.int32
            or vectors.dtype != torch.float32
            or queries.dtype != torch.float32 or dmax.dtype != torch.float32
            or tuple(queries.shape) != (B, m) or tuple(dmax.shape) != (B,)
            or (visited is not None and (visited.dtype != torch.int32
                                         or visited.shape[0] != B))):
        raise ValueError("fused_hop: bad operand types or shapes")
    if impl == "ref" or adjacency.device.type == "cpu":
        return fused_hop_ref(adjacency, vectors, sel_ids, queries, dmax,
                             visited, n_valid=n_valid, squared=squared)
    dev = adjacency.device
    ins = [adjacency, vectors, sel_ids, queries, dmax, visited]
    if dev.type != "cuda" or any(x is not None and x.device != dev
                                 for x in ins):
        raise ValueError("fused_hop: all operands must be on one CUDA device")
    V = 0 if visited is None else visited.shape[1]
    if V & (V - 1):
        raise ValueError(f"fused_hop: visited size {V} is not a power of two")
    if E * d > _MAX_POSITIONS:
        raise ValueError(f"fused_hop: E*d = {E * d} > {_MAX_POSITIONS}")
    act = (sel_ids != INVALID).to(torch.uint8)
    safe_sel = sel_ids.clamp(0, N - 1).contiguous()
    adjacency, vectors = adjacency.contiguous(), vectors.contiguous()
    queries, dmax = queries.contiguous(), dmax.contiguous()
    vis = None if visited is None else visited.contiguous()
    cand_ids = torch.empty((B, E * d), dtype=torch.int32, device=dev)
    cand_d = torch.empty((B, E * d), dtype=torch.float32, device=dev)
    nbr_ids = torch.empty((B, E * d), dtype=torch.int32, device=dev)
    evals = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _build.function("fused_hop", "fused_hop_f32", _ARGS)
    rc = fn(adjacency.data_ptr(), d, vectors.data_ptr(), vectors.shape[0], m,
            safe_sel.data_ptr(), act.data_ptr(), B, E, queries.data_ptr(),
            dmax.data_ptr(), None if vis is None else vis.data_ptr(), V,
            DEFAULT_PROBES, int(n_valid), cand_ids.data_ptr(),
            cand_d.data_ptr(), nbr_ids.data_ptr(), evals.data_ptr(),
            int(squared), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("fused_hop", rc)
    launches += 1
    return cand_ids, cand_d, nbr_ids, evals
