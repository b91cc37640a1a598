"""Plain PyTorch version of the PQ gather + LUT-ADC distance kernel.

It builds each query's (m_sub, 256) table of squared sub-distances with
``quant.pq.adc_lut``, elementwise and with no matrix product (so no TF32
can enter), and sums the ``m_sub`` entries each gathered code row picks
(:func:`pq_lut_sum_ref`, which the plain whole search calls with a table
it builds once a search).
"""
from __future__ import annotations

import torch

from repro_torch.quant.pq import PQ_K, adc_lut


def pq_adc_ref(codes: torch.Tensor, codebooks: torch.Tensor,
               ids: torch.Tensor, queries: torch.Tensor,
               squared: bool = False) -> torch.Tensor:
    """codes (N, m_sub) uint8, codebooks (m_sub, 256, dsub) float32, ids
    (B, d) clipped to [0, N), queries (B, dim) float32 -> (B, d) float32
    ``sum_s lut[b, s, code_s]``, or its square root."""
    return pq_lut_sum_ref(codes, adc_lut(queries, codebooks), ids,
                          squared=squared)


def pq_lut_sum_ref(codes: torch.Tensor, lut: torch.Tensor, ids: torch.Tensor,
                   squared: bool = False) -> torch.Tensor:
    """codes (N, m_sub) uint8, lut (B, m_sub, 256) tables of
    ``quant.pq.adc_lut``, ids (B, d) clipped to [0, N) -> (B, d) float32
    ``sum_s lut[b, s, code_s]``, or its square root."""
    B, d = ids.shape
    m_sub = codes.shape[1]
    lut = lut.reshape(B, m_sub * PQ_K)
    safe = ids.clamp(0, codes.shape[0] - 1).to(torch.int64)
    g = codes[safe].to(torch.int64)                          # (B, d, m_sub)
    col = g + PQ_K * torch.arange(m_sub, device=g.device)
    vals = torch.gather(lut, 1, col.reshape(B, d * m_sub))
    d2 = torch.clamp_min(vals.reshape(B, d, m_sub).sum(dim=-1), 0.0)
    return d2 if squared else torch.sqrt(d2)
