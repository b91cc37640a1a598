"""Request validation at the admission boundary.

A NaN/Inf query must never reach a device batch: the lock-step beam
co-batches lanes, and while per-lane state is independent, a poisoned
lane still burns hops and produces garbage that callers may mistake for
results.  Validation turns that into a typed, synchronous rejection at
``submit`` — the request is never enqueued, never dispatched, and never
counted as served.
"""
from __future__ import annotations

import numpy as np

from .errors import RequestValidationError


def validate_query(query, dim: int) -> np.ndarray:
    """Coerce ``query`` to a finite float32 vector of length ``dim``.

    Raises :class:`RequestValidationError` on wrong dtype (complex /
    object / non-numeric), wrong shape (anything that doesn't squeeze to
    ``(dim,)``), or non-finite values — including Inf introduced by the
    float32 downcast itself.
    """
    try:
        arr = np.asarray(query)
    except Exception as e:                  # ragged lists etc.
        raise RequestValidationError(f"query is not array-like: {e}") from e
    if arr.dtype == object or np.issubdtype(arr.dtype, np.complexfloating) \
            or not np.issubdtype(arr.dtype, np.number):
        raise RequestValidationError(
            f"query dtype {arr.dtype} is not real-numeric")
    arr = np.squeeze(arr)
    if arr.shape != (dim,):
        raise RequestValidationError(
            f"query shape {np.asarray(query).shape} does not match "
            f"index dim ({dim},)")
    with np.errstate(over="ignore"):        # overflow -> Inf, caught below
        arr = np.ascontiguousarray(arr, dtype=np.float32)
    if not np.isfinite(arr).all():
        raise RequestValidationError(
            "query contains NaN/Inf after float32 cast")
    return arr
