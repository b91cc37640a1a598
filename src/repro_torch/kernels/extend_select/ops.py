"""Dispatch for the Alg. 3 selection-pass kernel (``csrc/extend_select.cu``):
the neighbor gather, the lune test and the ``d/2`` selection steps of an
extend block in one launch, one cluster of CTAs a lane.

A CUDA tensor launches the kernel (l2 and squared l2, d <= ``MAX_DEGREE``
and a lane that fits a block's shared memory, else it raises:
``core/extend.py::extend_wave_device`` asks :func:`kernel_takes` first);
a CPU tensor takes the plain version in ``ref.py``; ``impl="ref"`` takes
the plain version on any device (tests and ``chip_smoke.py``).
``launches`` counts kernel launches.  Operand types and shapes are checked
before either runs, so the CPU reaches every check.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.extend_select.ref import SCHEMES, extend_select_ref

launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = ([_P, _P, _LL, _I, _P, _LL, _I] + [_P] * 7
         + [_I] * 6 + [_LL, _P])
#: the kernel keeps each candidate's neighbors as bits of a 64-bit mask
MAX_DEGREE = 64
#: CTAs a lane: the portable cluster size of the H100
MAX_CLUSTER = 8
#: the most shared memory a block may use on the H100 (227 KB)
MAX_SMEM = 232_448


def smem_bytes(m: int, K: int, D: int) -> int:
    """Shared memory of every CTA, the sum of ``make_layout`` in
    ``csrc/extend_select.cu``: the query of width m, the K candidates'
    ids and distances, the K x D gathered neighbors (id, distance, weight,
    occlusion flag), three 64-bit masks and two flags a candidate, and the
    D selections with their distances, each section rounded up to 16
    bytes."""
    return sum((n + 15) // 16 * 16 for n in (
        4 * m, 4 * K, 4 * K, 4 * K * D, 4 * K * D, 4 * K * D, K * D, 8 * K,
        8 * K, 8 * K, K, K, 4 * D, 4 * D))


def kernel_takes(device, metric: str, K: int, D: int, m: int) -> bool:
    """Does :func:`extend_select` launch the kernel for these shapes?  On
    a CUDA device under l2 or sqeuclidean, for 1 <= d <= MAX_DEGREE and a
    layout within MAX_SMEM; the caller runs the two-step path otherwise."""
    return (torch.device(device).type == "cuda"
            and metric in ("l2", "sqeuclidean") and K >= 1
            and 1 <= D <= MAX_DEGREE and smem_bytes(m, K, D) <= MAX_SMEM)


def cluster_size(K: int) -> int:
    """CTAs a lane: one a candidate, at most MAX_CLUSTER."""
    return max(1, min(MAX_CLUSTER, K))


def _check(name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"extend_select: {name} must be {dtype} of shape "
                         f"{tuple(shape)}, got {x.dtype} {tuple(x.shape)}")


def extend_select(adjacency, weights, vectors, cand_ids, cand_dists, queries,
                  v_ids, *, scheme: str = "C", rng_checks: bool = True,
                  metric: str = "l2", impl: str = "kernel"):
    """-> (sel_ids (W, d) int32, sel_dists (W, d) float32, ok (W,) bool);
    see ``ref.extend_select_ref`` for the operands."""
    global launches
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    if scheme not in SCHEMES:
        raise ValueError(f"unknown selection scheme {scheme!r}")
    if cand_ids.ndim != 2 or adjacency.ndim != 2 or vectors.ndim != 2:
        raise ValueError("extend_select: cand_ids, adjacency and vectors "
                         "must be 2-D")
    W, K = cand_ids.shape
    n_adj, D = adjacency.shape
    m = vectors.shape[1]
    _check("adjacency", adjacency, torch.int32, (n_adj, D))
    _check("weights", weights, torch.float32, (n_adj, D))
    _check("vectors", vectors, torch.float32, vectors.shape)
    _check("cand_ids", cand_ids, torch.int32, (W, K))
    _check("cand_dists", cand_dists, torch.float32, (W, K))
    _check("queries", queries, torch.float32, (W, m))
    _check("v_ids", v_ids, torch.int32, (W,))
    if impl == "ref" or cand_ids.device.type == "cpu":
        return extend_select_ref(adjacency, weights, vectors, cand_ids,
                                 cand_dists, queries, v_ids, scheme=scheme,
                                 rng_checks=rng_checks, metric=metric)
    if not kernel_takes(cand_ids.device, metric, K, D, m):
        raise ValueError(f"extend_select: the kernel takes l2 or "
                         f"sqeuclidean, K >= 1, 1 <= d <= {MAX_DEGREE} and "
                         f"{MAX_SMEM} bytes of shared memory; got {metric}, "
                         f"K={K}, d={D}, {smem_bytes(m, K, D)} bytes")
    dev = cand_ids.device
    ins = (adjacency, weights, vectors, cand_ids, cand_dists, queries, v_ids)
    if any(x.device != dev for x in ins):
        raise ValueError("extend_select: all operands must be on one CUDA "
                         "device")
    (adjacency, weights, vectors, cand_ids, cand_dists, queries,
     v_ids) = (x.contiguous() for x in ins)
    sel_ids = torch.empty((W, D), dtype=torch.int32, device=dev)
    sel_d = torch.empty((W, D), dtype=torch.float32, device=dev)
    ok = torch.empty((W,), dtype=torch.bool, device=dev)
    fn = _build.function("extend_select", "extend_select_f32", _ARGS)
    rc = fn(adjacency.data_ptr(), weights.data_ptr(), n_adj, D,
            vectors.data_ptr(), vectors.shape[0], m, cand_ids.data_ptr(),
            cand_dists.data_ptr(), queries.data_ptr(), v_ids.data_ptr(),
            sel_ids.data_ptr(), sel_d.data_ptr(), ok.data_ptr(), W, K,
            SCHEMES.index(scheme), int(rng_checks),
            int(metric == "sqeuclidean"), cluster_size(K),
            smem_bytes(m, K, D), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("extend_select", rc)
    launches += 1
    return sel_ids, sel_d, ok
