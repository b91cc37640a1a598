"""Dispatch for the beam merge kernel (``csrc/beam_merge.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``ref.py``; ``impl="ref"`` takes the plain version on any device (tests and
``chip_smoke.py``).  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.beam_merge.ref import beam_merge_ref

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 12 + [_I, _I, _I, _P]
# the kernel keeps the L + d keys in (default, <= 48 KiB) shared memory
_MAX_ENTRIES = 48 * 1024 // 4


def beam_merge(beam_dists, beam_ids, beam_chk, beam_exc,
               cand_dists, cand_ids, cand_exc, *, cand_chk=None,
               impl: str = "kernel"):
    """Merge ``d`` candidates into the sorted width-``L`` beam.

    beam_* : (B, L) — dists float32 ascending (stable order), ids int32,
             checked / excluded bool.
    cand_* : (B, d) — masked lanes carry dist=+inf / id=INVALID.
    ``cand_chk`` defaults to all-False (fresh candidates are unexpanded).
    Returns (dists, ids, checked, excluded), each (B, L): the first L
    entries of the stable sort of ``[beam | candidates]``."""
    global launches
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    B, L = beam_dists.shape
    d = cand_dists.shape[1]
    for name, x, dt, w in (("beam_dists", beam_dists, torch.float32, L),
                           ("beam_ids", beam_ids, torch.int32, L),
                           ("beam_chk", beam_chk, torch.bool, L),
                           ("beam_exc", beam_exc, torch.bool, L),
                           ("cand_dists", cand_dists, torch.float32, d),
                           ("cand_ids", cand_ids, torch.int32, d),
                           ("cand_exc", cand_exc, torch.bool, d),
                           ("cand_chk", cand_chk, torch.bool, d)):
        if x is not None and (x.dtype != dt or tuple(x.shape) != (B, w)):
            raise ValueError(f"beam_merge: {name} must be {dt} of shape "
                             f"{(B, w)}, got {x.dtype} {tuple(x.shape)}")
    if impl == "ref" or beam_dists.device.type == "cpu":
        if cand_chk is None:
            cand_chk = torch.zeros_like(cand_exc)
        return beam_merge_ref(beam_dists, beam_ids, beam_chk, beam_exc,
                              cand_dists, cand_ids, cand_chk, cand_exc)
    dev = beam_dists.device
    ins = [beam_dists, beam_ids, beam_chk, beam_exc,
           cand_dists, cand_ids, cand_chk, cand_exc]
    if not dev.type == "cuda" or any(x is not None and x.device != dev
                                     for x in ins):
        raise ValueError("beam_merge: all operands must be on one CUDA device")
    if L + d > _MAX_ENTRIES:
        raise ValueError(f"beam_merge: L + d = {L + d} > {_MAX_ENTRIES}")
    ins = [None if x is None else x.contiguous() for x in ins]
    outs = [torch.empty((B, L), dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32, torch.bool, torch.bool)]
    fn = _build.function("beam_merge", "beam_merge_f32", _ARGS)
    rc = fn(*[None if x is None else x.data_ptr() for x in ins],
            *[x.data_ptr() for x in outs], B, L, d,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check("beam_merge", rc)
    launches += 1
    return tuple(outs)
