"""Dispatch for the embedding-bag kernel (``csrc/bag_lookup.cu``), the
weighted gather-sum behind ``models/embedding_bag.py::embedding_bag_fixed``,
and for the two kernels of its gradient, which are also the gradient of
DIN's history gather (``models/embedding_bag.py::HistoryRows``):
``csrc/bag_bwd_order.cu`` (:func:`bwd_order`: ``grad_w`` and the valid
entries sorted by row, the index preparation) and ``csrc/bag_lookup_bwd.cu``
(:func:`table_grad`: the table's gradient from that order).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``ref.py``; ``impl="ref"`` takes the plain version on any device (tests and
``chip_smoke.py``).  ``launches`` counts the forward kernel's launches,
``launches_order`` the order's and ``launches_bwd`` the table gradient's
(one a call each: a kernel's passes are one C entry point).

Replaces ``src/repro/kernels/bag_lookup/bag_lookup.py:38``
(``bag_lookup_pallas``) and keeps its wrapper's contract: weights default
to ones, an id < 0 gets weight 0, ids are clipped to [0, V-1], and a table
of another float type is cast to float32.  The JAX wrapper pads E to 128
lanes and slices the output back; the kernel takes any E, so nothing is
padded.  The kernel applies the mask and the clip itself and never reads
the row of an id < 0; the plain version multiplies that row by 0, which is
the same sum for a finite table.  The gradient's kernels replace no TPU
kernel: they take the role of JAX's autodiff of DIN's history
(``src/repro/models/recsys.py:212-220``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bag_lookup.ref import (bag_lookup_bwd_ref,
                                                 bag_lookup_ref,
                                                 bwd_order_ref, grad_w_ref,
                                                 table_grad_ref)

launches = 0
launches_order = 0
launches_bwd = 0
#: entries a block of bag_bwd_order ranks (its kTile) and the key bits a
#: pass of its counting sort takes (its kBits)
ORDER_TILE, ORDER_BITS = 2048, 9
#: sorted entries a warp of bag_lookup_bwd's chunk pass sums
CHUNK = 256

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _LL, _I, _P, _P, _P, _LL, _I, _P]
_ORDER_ARGS = [_P, _LL, _LL, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P,
               _P, _P, _P]
_BWD_ARGS = [_P, _P, _P, _P, _LL, _P, _P, _I, _LL, _I, _I, _P, _P, _P, _P,
             _P, _P, _P]


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


class Order(NamedTuple):
    """The valid entries of (B, F) ids sorted by row, stably: the first
    ``count`` of ``keys`` (``clip(id, max=V-1)``) and ``pos`` (``b * F +
    f``), int32, and of ``w``, their weights in that order (None where the
    bag has none); ``count`` (1,) int32 on the ids' device.  The kernel's
    arrays hold B * F slots, the plain version's ``count``."""
    keys: torch.Tensor
    pos: torch.Tensor
    w: torch.Tensor | None
    count: torch.Tensor


def order_passes(n_rows: int) -> int:
    """The counting sort's passes over keys in [0, n_rows)."""
    bits = max(1, (n_rows - 1).bit_length())
    return -(-bits // ORDER_BITS)


def _check_g(g, B, E):
    if g is not None and tuple(g.shape) != (B, E):
        raise ValueError(f"g {tuple(g.shape)} for {B} bags of width {E}")


def bwd_order(table: torch.Tensor, ids: torch.Tensor,
              weights: torch.Tensor | None = None,
              g: torch.Tensor | None = None, *, need_w: bool = False,
              need_order: bool = True, impl: str = "kernel"
              ) -> tuple[Order | None, torch.Tensor | None]:
    """The first pass of the bag's backward: ``(order, grad_w)``.  The
    :class:`Order` of the ids (None unless ``need_order``), carrying the
    weights where given; ``grad_w`` (B, F) float32, ``dot(table[clip(id)],
    g[b])`` and 0 at an invalid id (None unless ``need_w``, which needs
    ``g`` = dL/dout (B, E)).  Deterministic on the card."""
    global launches_order
    table, weights = _operands(table, ids, weights, impl)
    V, E = table.shape
    B, F = ids.shape
    if need_w and g is None:
        raise ValueError("grad_w needs g")
    _check_g(g, B, E)
    if impl == "ref" or table.device.type == "cpu":
        return (Order(*bwd_order_ref(ids, V, weights)) if need_order else None,
                grad_w_ref(table, ids, g.to(torch.float32)) if need_w
                else None)
    _on_one_card("bwd_order", table, ids, weights, g)
    n = B * F
    if n >= 2**31:
        raise ValueError(f"{n} entries: the positions are int32")
    dev = table.device
    grad_w = torch.empty((B, F), dtype=torch.float32, device=dev) \
        if need_w else None
    order = None
    if need_order:
        slots = max(n, 1)
        order = Order(
            torch.empty((2, slots), dtype=torch.int32, device=dev),
            torch.empty((2, slots), dtype=torch.int32, device=dev),
            None if weights is None else
            torch.empty((2, slots), dtype=torch.float32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    if n == 0 or not (need_w or need_order):
        return order and _final(order, 1), grad_w
    ids = ids.contiguous()
    if weights is not None:
        weights = weights.contiguous()
    if need_w:
        table, g = table.contiguous(), g.to(torch.float32).contiguous()
    n_tiles = -(-n // ORDER_TILE)
    counts = torch.empty((1 << ORDER_BITS) * n_tiles, dtype=torch.int32,
                         device=dev)
    totals = torch.empty(1 << ORDER_BITS, dtype=torch.int32, device=dev)
    passes = order_passes(V)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _build.function("bag_bwd_order", "bag_bwd_order_f32", _ORDER_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(ids.data_ptr(), n, V, passes, ptr(weights),
            ptr(table) if need_w else None, E, ptr(g) if need_w else None, F,
            ptr(grad_w), *(ptr(t) for t in (order or (None,) * 4)),
            counts.data_ptr(), totals.data_ptr(), stream)
    _build.check("bag_bwd_order", rc)
    launches_order += 1
    return order and _final(order, passes), grad_w


def _final(order: Order, passes: int) -> Order:
    """The row of the sort's two buffers that its last pass wrote."""
    r = (passes - 1) % 2
    return Order(order.keys[r], order.pos[r],
                 None if order.w is None else order.w[r], order.count)


def table_grad(order: Order | None, table: torch.Tensor, ids: torch.Tensor,
               weights: torch.Tensor | None, g: torch.Tensor | None,
               G: torch.Tensor | None, *, impl: str = "kernel"
               ) -> torch.Tensor:
    """The table's gradient (V, E) float32 of a gather of (B, F) ids with
    cotangent ``G`` (B, F, E) and of a bag over the same ids with weights
    ``weights`` and cotangent ``g`` (B, E): ``grad_table[r] = sum over
    valid entries on row r of G[b, f] + w[b, f] * g[b]`` (a term left out
    where ``G`` or ``g`` is None; w = 1 where ``weights`` is None), zero on
    a row no valid id names.  The kernel reads ``order``
    (:func:`bwd_order` of the ids, with the weights where ``g`` and
    ``weights`` are given), the plain version the ids and weights.
    Deterministic on the card: the same inputs give the same bits."""
    global launches_bwd
    table, weights = _operands(table, ids, weights, impl)
    V, E = table.shape
    B, F = ids.shape
    _check_g(g, B, E)
    if G is not None and tuple(G.shape) != (B, F, E):
        raise ValueError(f"G {tuple(G.shape)} for ids {(B, F)} of width {E}")
    if impl == "ref" or table.device.type == "cpu":
        return table_grad_ref(table, ids, weights, g, G)
    _on_one_card("table_grad", table, ids, g, G)
    if order is None:
        raise ValueError("the kernel needs the ids' order")
    if g is not None and weights is not None and order.w is None:
        raise ValueError("the order carries no weights for the bag's term")
    dev = table.device
    n = B * F
    grad_table = torch.empty((V, E), dtype=torch.float32, device=dev)
    if E == 0:
        return grad_table
    if G is not None:
        G = G.to(torch.float32).contiguous()
    if g is not None:
        g = g.to(torch.float32).contiguous()
    n_chunks = max(1, -(-n // CHUNK))
    partial = torch.empty(2 * n_chunks * E, dtype=torch.float32, device=dev)
    # the owners' and the big owners' counts, then their lists
    owners = torch.empty(2 + 2 * n_chunks, dtype=torch.int32, device=dev)
    last = torch.empty(V, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _build.function("bag_lookup_bwd", "bag_lookup_bwd_f32", _BWD_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(order.keys.data_ptr(), order.pos.data_ptr(),
            ptr(order.w) if g is not None and weights is not None else None,
            order.count.data_ptr(), n, ptr(G), ptr(g), F, V, E, CHUNK,
            partial.data_ptr(), owners[2:2 + n_chunks].data_ptr(),
            owners[2 + n_chunks:].data_ptr(), owners.data_ptr(),
            last.data_ptr(), grad_table.data_ptr(), stream)
    _build.check("bag_lookup_bwd", rc)
    launches_bwd += 1
    return grad_table


def bag_lookup_bwd(table: torch.Tensor, ids: torch.Tensor,
                   weights: torch.Tensor | None, g: torch.Tensor, *,
                   G: torch.Tensor | None = None, need_w: bool = True,
                   need_table: bool = True, impl: str = "kernel"
                   ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The gradient of :func:`bag_lookup` at (table, ids, weights) given
    ``g`` = dL/dout (B, E), and, with ``G`` (B, F, E), of the gather of the
    same ids whose cotangent ``G`` is: ``(grad_w (B, F), grad_table (V,
    E))``, both float32, or None where ``need_w`` / ``need_table`` is
    False.  On the card :func:`bwd_order`, then :func:`table_grad`."""
    if impl == "ref" or table.device.type == "cpu":
        table, weights = _operands(table, ids, weights, impl)
        _check_g(g, ids.shape[0], table.shape[1])
        grad_w, grad_table = bag_lookup_bwd_ref(table, ids, weights,
                                                g.to(torch.float32), G)
        return (grad_w if need_w else None,
                grad_table if need_table else None)
    order, grad_w = bwd_order(table, ids, weights, g, need_w=need_w,
                              need_order=need_table, impl=impl)
    grad_table = table_grad(order, table, ids, weights, g, G, impl=impl) \
        if need_table else None
    return grad_w, grad_table
