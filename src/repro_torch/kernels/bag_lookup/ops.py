"""Dispatch for the embedding-bag kernel (``csrc/bag_lookup.cu``), the
weighted gather-sum behind ``models/embedding_bag.py::embedding_bag_fixed``,
and for its gradient (``csrc/bag_lookup_bwd.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``ref.py``; ``impl="ref"`` takes the plain version on any device (tests and
``chip_smoke.py``).  ``launches`` counts the forward kernel's launches and
``launches_bwd`` the backward's (one a call: its four passes are one C
entry point).

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
from repro_torch.kernels.bag_lookup.ref import (bag_lookup_bwd_ref,
                                                 bag_lookup_ref)

launches = 0
launches_bwd = 0
#: sorted entries a warp of the backward's chunk pass sums
CHUNK = 1024

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _LL, _I, _P, _P, _P, _LL, _I, _P]
_BWD_ARGS = [_P, _LL, _I, _P, _P, _P, _LL, _I, _P, _P, _P, _P, _I, _P, _P,
             _P]


def _operands(table, ids, weights, impl: str):
    """Check what both kernels take (a float (V, E) table, (B, F) int32
    ids, (B, F) weights or None) and return the table and the weights as
    float32, as the JAX wrapper casts them."""
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    if table.dim() != 2 or ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(f"bad operands: table {tuple(table.shape)}, ids "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if not table.is_floating_point():
        raise TypeError(f"bag_lookup takes a float table, not {table.dtype}")
    if weights is not None and weights.shape != ids.shape:
        raise ValueError(f"weights {tuple(weights.shape)} for ids "
                         f"{tuple(ids.shape)}")
    if table.shape[0] == 0 and ids.numel() > 0:
        raise ValueError("bag_lookup over an empty table")
    return (table.to(torch.float32),
            None if weights is None else weights.to(torch.float32))


def _on_one_card(name: str, *tensors) -> None:
    dev = tensors[0].device
    if not (dev.type == "cuda" and all(t is None or t.device == dev
                                       for t in tensors)):
        raise ValueError(f"{name}: all operands must be on one CUDA device")


def bag_lookup(table: torch.Tensor, ids: torch.Tensor,
               weights: torch.Tensor | None = None, *,
               impl: str = "kernel") -> torch.Tensor:
    """table (V, E), ids (B, F) int32, weights (B, F) or None -> (B, E)
    float32 ``sum_f w[b, f] * table[clip(ids[b, f], 0, V-1)]`` with
    ``w = 0`` where ``ids < 0``."""
    global launches
    table, weights = _operands(table, ids, weights, impl)
    V, E = table.shape
    B, F = ids.shape
    if B == 0 or F == 0 or E == 0:
        return torch.zeros((B, E), dtype=torch.float32, device=table.device)
    if impl == "ref" or table.device.type == "cpu":
        w = torch.ones((B, F), dtype=torch.float32, device=ids.device) \
            if weights is None else weights
        w = torch.where(ids < 0, 0.0, w)
        return bag_lookup_ref(table, ids.clamp(0, V - 1), w)
    _on_one_card("bag_lookup", table, ids, weights)
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


def bwd_order(ids: torch.Tensor, n_rows: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward's index preparation: the keys ``clip(ids, 0, V-1)``
    (``V`` for an invalid id, so those sort last) of the B*F entries,
    sorted stably, as int32, and ``perm`` (int64), each sorted entry's
    position ``b * F + f``.  Depends on the ids only."""
    key = torch.where(ids >= 0, ids.clamp(max=n_rows - 1), n_rows)
    keys, perm = torch.sort(key.reshape(-1).to(torch.int32), stable=True)
    return keys, perm


def bag_lookup_bwd(table: torch.Tensor, ids: torch.Tensor,
                   weights: torch.Tensor | None, g: torch.Tensor, *,
                   need_w: bool = True, need_table: bool = True,
                   order: tuple | None = None, impl: str = "kernel"
                   ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The gradient of :func:`bag_lookup` at (table, ids, weights) given
    ``g`` = dL/dout (B, E): ``(grad_w (B, F), grad_table (V, E))``, both
    float32, or None where ``need_w`` / ``need_table`` is False.
    ``grad_w[b, f] = dot(table[clip(id)], g[b])`` (0 at an invalid id);
    ``grad_table`` is dense, zero on rows no valid id names.  ``order`` is
    :func:`bwd_order` of the ids, if the caller already has it; else the
    kernel path sorts here.  The kernel path is deterministic: the same
    inputs give the same bits."""
    global launches_bwd
    table, weights = _operands(table, ids, weights, impl)
    V, E = table.shape
    B, F = ids.shape
    if tuple(g.shape) != (B, E):
        raise ValueError(f"g {tuple(g.shape)} for {B} bags of width {E}")
    g = g.to(torch.float32)
    if impl == "ref" or table.device.type == "cpu":
        grad_w, grad_table = bag_lookup_bwd_ref(table, ids, weights, g)
        return (grad_w if need_w else None,
                grad_table if need_table else None)
    _on_one_card("bag_lookup_bwd", table, ids, weights, g)
    if B * F >= 2**31:
        raise ValueError(f"{B * F} entries: the row starts are int32")
    dev = table.device
    grad_w = torch.empty((B, F), dtype=torch.float32, device=dev) \
        if need_w else None
    grad_table = torch.empty((V, E), dtype=torch.float32, device=dev) \
        if need_table else None
    if grad_w is None and grad_table is None:
        return None, None
    if B == 0 or F == 0 or E == 0:
        for t in (grad_w, grad_table):
            if t is not None:
                t.zero_()
        return grad_w, grad_table
    table, ids, g = table.contiguous(), ids.contiguous(), g.contiguous()
    if weights is not None:
        weights = weights.contiguous()
    keys = perm = row_start = partial = None
    if need_table:
        keys, perm = order if order is not None else bwd_order(ids, V)
        if keys.numel() != B * F or keys.dtype != torch.int32 \
                or perm.dtype != torch.int64:
            raise ValueError("order is not bwd_order(ids, V)")
        row_start = torch.empty(V + 1, dtype=torch.int32, device=dev)
        partial = torch.empty(2 * (-(-B * F // CHUNK)) * E,
                              dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _build.function("bag_lookup_bwd", "bag_lookup_bwd_f32", _BWD_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(table.data_ptr(), V, E, ids.data_ptr(), ptr(weights),
            g.data_ptr(), B, F, ptr(keys), ptr(perm), ptr(row_start),
            ptr(partial), CHUNK, ptr(grad_w), ptr(grad_table), stream)
    _build.check("bag_lookup_bwd", rc)
    launches_bwd += 1
    return grad_w, grad_table
