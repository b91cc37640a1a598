"""Dispatch for the gather + distance + MRNG-occlusion kernel
(``csrc/mrng_occlusion.cu``).

A CUDA tensor launches the kernel for the l2 and squared-l2 metrics; a CPU
tensor, and the inner-product and cosine metrics on any device, take the
plain version in ``ref.py``, as ``src/repro/kernels/mrng_occlusion/ops.py``
dispatches.  ``impl="ref"`` takes the plain version on any device (tests
and ``chip_smoke.py``).  ``launches`` counts kernel launches.  Neighbor ids
are clipped to ``[0, N)`` in the kernel: callers mask INVALID slots after
the call.  The TPU wrapper's 128-lane feature padding is not carried over.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mrng_occlusion.ref import mrng_occlusion_ref

launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _LL, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_MAX_M = 48 * 1024 // 4


def mrng_occlusion(vectors: torch.Tensor, nbr_ids: torch.Tensor,
                   queries: torch.Tensor, cand_dists: torch.Tensor,
                   nbr_weights: torch.Tensor, *, metric: str = "l2",
                   impl: str = "kernel"):
    """-> (nbr_dist (B, K, d) float32, occl (B, K, d) bool).  ``occl[b, i,
    j]`` answers: does neighbor j of candidate i occlude the candidate edge
    (the lune test of Alg. 2)?  See ``ref.mrng_occlusion_ref``."""
    global launches
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    N, m = vectors.shape
    B, K, d = nbr_ids.shape
    if (nbr_ids.dtype != torch.int32 or tuple(queries.shape) != (B, m)
            or tuple(cand_dists.shape) != (B, K)
            or tuple(nbr_weights.shape) != (B, K, d)):
        raise ValueError(
            f"bad operands: nbr_ids {nbr_ids.dtype} {tuple(nbr_ids.shape)}, "
            f"queries {tuple(queries.shape)}, cand_dists "
            f"{tuple(cand_dists.shape)}, nbr_weights "
            f"{tuple(nbr_weights.shape)}, rows {(N, m)}")
    if (impl == "ref" or vectors.device.type == "cpu"
            or metric not in ("l2", "sqeuclidean")):
        return mrng_occlusion_ref(vectors, nbr_ids, queries, cand_dists,
                                  nbr_weights, metric=metric)
    if any(t.dtype != torch.float32
           for t in (vectors, queries, cand_dists, nbr_weights)):
        raise TypeError("mrng_occlusion takes float32 rows, queries, "
                        "candidate distances and weights")
    if m > _MAX_M:
        raise ValueError(f"mrng_occlusion stages the query row in 48 KiB of "
                         f"shared memory: m={m} > {_MAX_M}")
    dev = vectors.device
    if not (vectors.is_cuda and all(t.device == dev for t in
                                    (nbr_ids, queries, cand_dists,
                                     nbr_weights))):
        raise ValueError("mrng_occlusion: all operands must be on one CUDA "
                         "device")
    vectors, nbr_ids, queries, cand_dists, nbr_weights = (
        t.contiguous() for t in (vectors, nbr_ids, queries, cand_dists,
                                 nbr_weights))
    nd = torch.empty((B, K, d), dtype=torch.float32, device=dev)
    occ = torch.empty((B, K, d), dtype=torch.bool, device=dev)
    fn = _build.function("mrng_occlusion", "mrng_occlusion_f32", _ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(vectors.data_ptr(), N, m, nbr_ids.data_ptr(), queries.data_ptr(),
            cand_dists.data_ptr(), nbr_weights.data_ptr(), nd.data_ptr(),
            occ.data_ptr(), B, K, d, int(metric == "sqeuclidean"), stream)
    _build.check("mrng_occlusion", rc)
    launches += 1
    return nd, occ
