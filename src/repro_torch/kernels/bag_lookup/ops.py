"""Dispatch for the embedding-bag kernel (``csrc/bag_lookup.cu``), the
weighted gather-sum behind ``models/embedding_bag.py::embedding_bag_fixed``.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``ref.py``; ``impl="ref"`` takes the plain version on any device (tests and
``chip_smoke.py``).  ``launches`` counts kernel launches.

Replaces ``src/repro/kernels/bag_lookup/bag_lookup.py:38``
(``bag_lookup_pallas``) and keeps its wrapper's contract: weights default
to ones, an id < 0 gets weight 0, ids are clipped to [0, V-1], and a table
of another float type is cast to float32.  The JAX wrapper pads E to 128
lanes and slices the output back; the kernel takes any E, so nothing is
padded.  The kernel applies the mask and the clip itself and never reads
the row of an id < 0; the plain version multiplies that row by 0, which is
the same sum for a finite table.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bag_lookup.ref import bag_lookup_ref

launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _LL, _I, _P, _P, _P, _LL, _I, _P]


def bag_lookup(table: torch.Tensor, ids: torch.Tensor,
               weights: torch.Tensor | None = None, *,
               impl: str = "kernel") -> torch.Tensor:
    """table (V, E), ids (B, F) int32, weights (B, F) or None -> (B, E)
    float32 ``sum_f w[b, f] * table[clip(ids[b, f], 0, V-1)]`` with
    ``w = 0`` where ``ids < 0``."""
    global launches
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    if table.dim() != 2 or ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(f"bad operands: table {tuple(table.shape)}, ids "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if not table.is_floating_point():
        raise TypeError(f"bag_lookup takes a float table, not {table.dtype}")
    V, E = table.shape
    B, F = ids.shape
    if weights is not None and tuple(weights.shape) != (B, F):
        raise ValueError(f"weights {tuple(weights.shape)} for ids {(B, F)}")
    if V == 0 and B * F > 0:
        raise ValueError("bag_lookup over an empty table")
    table = table.to(torch.float32)
    if weights is not None:
        weights = weights.to(torch.float32)
    if B == 0 or F == 0 or E == 0:
        return torch.zeros((B, E), dtype=torch.float32, device=table.device)
    if impl == "ref" or table.device.type == "cpu":
        w = torch.ones((B, F), dtype=torch.float32, device=ids.device) \
            if weights is None else weights
        w = torch.where(ids < 0, 0.0, w)
        return bag_lookup_ref(table, ids.clamp(0, V - 1), w)
    if not (table.is_cuda and ids.device == table.device
            and (weights is None or weights.device == table.device)):
        raise ValueError("bag_lookup: all operands must be on one CUDA device")
    table, ids = table.contiguous(), ids.contiguous()
    if weights is not None:
        weights = weights.contiguous()
    out = torch.empty((B, E), dtype=torch.float32, device=table.device)
    fn = _build.function("bag_lookup", "bag_lookup_f32", _ARGS)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = fn(table.data_ptr(), V, E, ids.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            B, F, stream)
    _build.check("bag_lookup", rc)
    launches += 1
    return out
