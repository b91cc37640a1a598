"""Post-training vector codecs for the store the beam engine traverses.

The search's roofline is the random gather of neighbor rows, and at
serving scale the float32 store, not compute, caps how many vertices a
shard can hold.  The codecs (calibrated after the build from the indexed
rows, never retrained):

* ``float32`` — the identity codec (the exact store);
* ``fp16`` — IEEE half precision, 2x, no calibration state;
* ``sq8`` — per-dimension symmetric int8: the scale of dimension ``j`` is
  ``max_i |x[i, j]| / 127`` over the live rows, so every indexed value
  round-trips within ``scale / 2``;
* ``pq`` — product quantization (:mod:`repro_torch.quant.pq`): one uint8
  code per subspace plus shared codebooks.  It is stateful, so its encode
  and decode live in ``pq.py`` and :class:`~repro_torch.quant.store.VectorStore`;
  here it has its registry entry and its byte accounting.

``torch.round`` rounds half to even as ``jnp.round`` does, so sq8 scales
and codes equal the JAX package's bit for bit.
"""
from __future__ import annotations

import torch

#: codec name -> (storage dtype, bytes per element); pq's "element" is one
#: subspace code byte, not one dimension (see :func:`bytes_per_row`)
CODECS = {
    "float32": (torch.float32, 4),
    "fp16": (torch.float16, 2),
    "sq8": (torch.int8, 1),
    "pq": (torch.uint8, 1),
}


def _unknown(codec: str) -> ValueError:
    return ValueError(f"unknown codec {codec!r} (have {sorted(CODECS)})")


def calibrate_sq8_scale(vectors: torch.Tensor, n=None) -> torch.Tensor:
    """Per-dimension symmetric scale from the first ``n`` rows (the live
    vertices; all rows when ``n`` is None): (capacity, m) -> (m,)."""
    x = vectors if n is None else vectors[:n]
    amax = torch.amax(torch.abs(x.to(torch.float32)), dim=0)
    return torch.clamp_min(amax, 1e-12) / 127.0


def sq8_encode(vectors: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest symmetric int8: q = clip(round(x / scale), +-127)."""
    q = torch.round(vectors.to(torch.float32) / scale[None, :])
    return torch.clamp(q, -127, 127).to(torch.int8)


def sq8_decode(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def encode(codec: str, vectors: torch.Tensor,
           scale: torch.Tensor) -> torch.Tensor:
    if codec == "float32":
        return vectors.to(torch.float32)
    if codec == "fp16":
        return vectors.to(torch.float16)
    if codec == "sq8":
        return sq8_encode(vectors, scale)
    if codec == "pq":
        raise ValueError("pq is codebook-stateful; encode via "
                         "repro_torch.quant.store.make_store or quant.pq")
    raise _unknown(codec)


def decode(codec: str, data: torch.Tensor,
           scale: torch.Tensor) -> torch.Tensor:
    """Decoded rows in float32 (the identity for float32)."""
    if codec in ("float32", "fp16"):
        return data.to(torch.float32)
    if codec == "sq8":
        return sq8_decode(data, scale)
    if codec == "pq":
        raise ValueError("pq is codebook-stateful; decode via "
                         "VectorStore.decode or quant.pq")
    raise _unknown(codec)


def bytes_per_row(codec: str, dim: int) -> int:
    """Bytes of one stored row (sq8's scale and pq's codebooks are charged
    to the store, not the row)."""
    if codec not in CODECS:
        raise _unknown(codec)
    if codec == "pq":
        from . import pq

        return pq.n_subspaces(dim)          # one uint8 code per subspace
    return CODECS[codec][1] * dim


def store_bytes(codec: str, n_rows: int, dim: int) -> int:
    """Store bytes of ``n_rows`` rows plus the codec's calibration state:
    sq8's (dim,) float32 scale, pq's (m_sub, 256, dsub) float32 codebooks
    (``256 * dim * 4`` bytes)."""
    total = n_rows * bytes_per_row(codec, dim)
    if codec == "sq8":
        total += dim * 4
    if codec == "pq":
        from . import pq

        total += pq.PQ_K * dim * 4
    return total
