"""Dispatch for the whole-search kernel (``csrc/beam_search.cu``): the range
search of the beam engine with the composed hop, from an initialised beam
to the final one, in one launch, over float32 or fp16 rows, the sq8
store's int8 code rows (with ``scale``) or the pq store's uint8 code rows
(with ``codebooks``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``ref.py``; ``impl="ref"`` takes the plain version on any device (tests and
``chip_smoke.py``).  ``launches`` counts kernel launches.  Operand types,
shapes and the kernel's shared memory are checked before either runs, so
the CPU reaches every check.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.visited import DEFAULT_PROBES
from repro_torch.kernels import _build
from repro_torch.kernels.beam_search.ref import beam_search_ref
from repro_torch.kernels.pq_adc.ops import check_store
from repro_torch.quant.pq import PQ_K

launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
_ARGS = ([_P, _LL, _I, _P, _LL, _I, _P, _P, _I, _I, _P, _P, _I] + [_P] * 15
         + [_I] * 9 + [_F, _LL, _P])
_SYMBOL = {torch.float32: "beam_search_f32", torch.float16: "beam_search_f16",
           torch.bfloat16: "beam_search_bf16",
           torch.int8: "beam_search_sq8", torch.uint8: "beam_search_pq"}
#: the most shared memory a block may use on the H100 (227 KB)
MAX_SMEM = 232_448
#: floats a row of the pq table takes: 256 centroids and one of padding
#: (``kPqStride`` in ``csrc/common.cuh``)
LUT_STRIDE = PQ_K + 1


def smem_bytes(m: int, L: int, C: int, X: int, V: int, E: int,
               m_sub: int = 0, sq8: bool = False) -> int:
    """Shared memory of one lane's block, the sum of ``make_layout`` in
    ``csrc/beam_search.cu``: the beam twice, the query of width m, the sq8
    store's scale of width m (``sq8``), the pq store's table of ``m_sub``
    subspaces (none for other rows), the C = E * d candidates, the exclude
    list, the visited table and the selections, each section rounded up to
    16 bytes."""
    T = L + C
    return sum((n + 15) // 16 * 16 for n in (
        16, 4 * m, 4 * m * sq8, 4 * m_sub * LUT_STRIDE, 4 * T, 4 * T, 4 * L,
        4 * L, 4 * C, 4 * X, 4 * V, 4 * E, 4 * E, L, L, L, L, C, E))


def _check(name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"beam_search: {name} must be {dtype} of shape "
                         f"{tuple(shape)}, got {x.dtype} {tuple(x.shape)}")


def beam_search(adjacency, rows, queries, exclude, ids, dists, checked,
                excluded, hops, evals, visited=None, *, n_valid: int, k: int,
                eps1: float, expand_width: int, max_hops: int,
                squared: bool = False,
                hop_budget: Optional[torch.Tensor] = None,
                scale: Optional[torch.Tensor] = None,
                codebooks: Optional[torch.Tensor] = None,
                impl: str = "kernel"):
    """Run every lane's range search to its end.

    adjacency : (N_adj, d) int32; rows (N, m) float32, float16 or
    bfloat16 (the exact store, over half rows too, or the fp16 store),
    (N, m) int8 codes of the sq8 store with its (m,) float32 ``scale``,
    or (N, m_sub) uint8 codes of the pq store with its (m_sub, 256, dsub)
    float32 ``codebooks``, m = m_sub * dsub;
    queries (B, m) float32, over bfloat16 rows first rounded to bfloat16
    as ``gather_dist`` rounds them; exclude (B, X) int32.
    The beam state as ``core/beam.py::init`` returns it: ids (B, L) int32,
    dists (B, L) float32, checked / excluded (B, L) bool, hops / evals
    (B,) int32, visited (B, V) int32 (V a power of two) or None for the
    beam-broadcast dedup.  ``eps1`` is float32(1 + eps); ``squared``
    selects squared l2; ``hop_budget`` (B,) int32 caps each lane's
    expansions.  Returns the final (ids, dists, checked, excluded, hops,
    evals, visited)."""
    global launches
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    if ids.ndim != 2 or adjacency.ndim != 2 or rows.ndim != 2:
        raise ValueError("beam_search: ids, adjacency and rows must be 2-D")
    B, L = ids.shape
    d, m, m_sub = adjacency.shape[1], rows.shape[1], 0
    E = expand_width
    sq8 = rows.dtype == torch.int8
    if scale is not None and codebooks is not None:
        raise ValueError("beam_search: a scale (sq8 codes) and codebooks "
                         "(pq codes) exclude each other")
    if sq8 != (scale is not None):
        raise ValueError("beam_search: int8 rows (the sq8 store) need their "
                         "scale, and only they take one; got "
                         f"{rows.dtype} rows and "
                         f"{'a' if scale is not None else 'no'} scale")
    if sq8:
        _check("scale", scale, torch.float32, (m,))
    elif codebooks is None:
        if rows.dtype not in (torch.float32, torch.float16,
                              torch.bfloat16):
            raise ValueError(f"beam_search: rows must be bfloat16, float32 "
                             f"or float16 (int8 codes with a scale, uint8 "
                             f"codes with codebooks), got {rows.dtype}")
    else:
        m_sub = m
        m = m_sub * check_store(rows, codebooks)
    _check("adjacency", adjacency, torch.int32, adjacency.shape)
    _check("queries", queries, torch.float32, (B, m))
    if exclude.ndim != 2:
        raise ValueError("beam_search: exclude must be 2-D")
    _check("exclude", exclude, torch.int32, (B, exclude.shape[1]))
    for name, x, dt in (("ids", ids, torch.int32),
                        ("dists", dists, torch.float32),
                        ("checked", checked, torch.bool),
                        ("excluded", excluded, torch.bool)):
        _check(name, x, dt, (B, L))
    _check("hops", hops, torch.int32, (B,))
    _check("evals", evals, torch.int32, (B,))
    V = 0
    if visited is not None:
        V = visited.shape[-1]
        _check("visited", visited, torch.int32, (B, V))
        if V < 1 or V & (V - 1):
            raise ValueError(f"beam_search: visited size {V} is not a power "
                             "of two")
    if hop_budget is not None:
        _check("hop_budget", hop_budget, torch.int32, (B,))
    if k < 1 or not 1 <= E <= L or max_hops < 0:
        raise ValueError(f"beam_search: need k >= 1, 1 <= E <= L and "
                         f"max_hops >= 0, got k={k} E={E} L={L} "
                         f"max_hops={max_hops}")
    smem = smem_bytes(m, L, E * d, exclude.shape[1], V, E, m_sub, sq8)
    if smem > MAX_SMEM:
        raise ValueError(f"beam_search: a lane needs {smem} bytes of shared "
                         f"memory, more than the {MAX_SMEM} a block may use")
    state = (ids, dists, checked, excluded, hops, evals, visited)
    if B == 0:
        return state
    if rows.dtype == torch.bfloat16:
        queries = queries.to(torch.bfloat16).to(torch.float32)
    if impl == "ref" or ids.device.type == "cpu":
        return beam_search_ref(adjacency, rows, queries, exclude, *state,
                               n_valid=n_valid, k=k, eps1=eps1,
                               expand_width=E, max_hops=max_hops,
                               squared=squared, hop_budget=hop_budget,
                               scale=scale, codebooks=codebooks)
    dev = ids.device
    ins = [adjacency, rows, queries, exclude, *state, hop_budget, scale,
           codebooks]
    if dev.type != "cuda" or any(x is not None and x.device != dev
                                 for x in ins):
        raise ValueError("beam_search: all operands must be on one CUDA "
                         "device")
    (adjacency, rows, queries, exclude, ids, dists, checked, excluded, hops,
     evals, visited, hop_budget, scale, codebooks) = [
        None if x is None else x.contiguous() for x in ins]
    outs = [torch.empty_like(x) for x in (ids, dists, checked, excluded,
                                          hops, evals)]
    outs.append(None if visited is None else torch.empty_like(visited))

    def ptr(x):
        return None if x is None else x.data_ptr()

    fn = _build.function("beam_search", _SYMBOL[rows.dtype], _ARGS)
    rc = fn(adjacency.data_ptr(), adjacency.shape[0], d, rows.data_ptr(),
            rows.shape[0], m, ptr(scale), ptr(codebooks), m_sub,
            0 if codebooks is None else codebooks.shape[2],
            queries.data_ptr(), exclude.data_ptr(),
            exclude.shape[1], dists.data_ptr(), ids.data_ptr(),
            checked.data_ptr(), excluded.data_ptr(), hops.data_ptr(),
            evals.data_ptr(), ptr(visited), ptr(hop_budget),
            outs[1].data_ptr(), outs[0].data_ptr(), outs[2].data_ptr(),
            outs[3].data_ptr(), outs[4].data_ptr(), outs[5].data_ptr(),
            ptr(outs[6]), B, L, E, k, V, DEFAULT_PROBES, int(n_valid),
            max_hops, int(squared), eps1, smem,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check("beam_search", rc)
    launches += 1
    return tuple(outs)
