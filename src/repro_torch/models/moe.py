"""Mixture-of-Experts FFN with sort-free scatter dispatch, ported from
``src/repro/models/moe.py``.

* **Dispatch** is linear-cost: top-k routing -> position-in-expert via a
  cumsum over one-hot assignments -> scatter into a static ``(E, C, D)``
  buffer (capacity ``C = ceil(T*k*cf/E)`` rounded up to 8, overflow
  assignments *dropped* like GShard/Switch) -> 3 batched expert products
  -> gather-combine weighted by the (renormalised) router probabilities.
* Dropped assignments write to a dump row ``E`` of the buffer, where
  their indices may meet, and that row is thrown away: no
  device-to-host read of how many were kept.
* A token's K contributions are added in k order in the compute dtype,
  each sum rounded as the JAX ``segment_sum`` rounds it, with no atomics.
* Aux load-balance loss (Switch-style): ``E * sum_e f_e * p_e``.

``MoEConfig.shard_hidden`` only constrains a sharded layout in the JAX
package; on one device it does nothing, here as there.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .layers import abs_p, dense_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    shard_hidden: bool = False


def _capacity(T: int, moe: MoEConfig) -> int:
    c = int(T * moe.top_k * moe.capacity_factor / moe.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8


def _moe_shapes(L: int, d_model: int, moe: MoEConfig) -> dict:
    E, F_ = moe.n_experts, moe.d_ff_expert
    return {"router": (L, d_model, E), "we_gate": (L, E, d_model, F_),
            "we_up": (L, E, d_model, F_), "we_down": (L, E, F_, d_model)}


def abs_moe_layer(L: int, d_model: int, moe: MoEConfig) -> dict:
    return {k: abs_p(*s) for k, s in _moe_shapes(L, d_model, moe).items()}


def init_moe_layer(generator: torch.Generator, L: int, d_model: int,
                   moe: MoEConfig, device="cuda") -> dict:
    return {k: dense_init(generator, s, device=device)
            for k, s in _moe_shapes(L, d_model, moe).items()}


def top_k_desc(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of each row, ties to
    the lower index (``lax.top_k``'s order; ``torch.topk`` does not fix
    the order of ties)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def moe_ffn(x: torch.Tensor, lp: dict,
            moe: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, D) -> (y (T, D), aux_loss scalar float32)."""
    T, D = x.shape
    E, K = moe.n_experts, moe.top_k
    dt = x.dtype
    C = _capacity(T, moe)
    dev = x.device

    logits = (x @ lp["router"].to(dt)).to(torch.float32)          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = top_k_desc(probs, K)                          # (T, K)
    top_w = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    flat_e = top_ids.reshape(-1)                                   # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_w = top_w.reshape(-1)

    # position of each assignment inside its expert's buffer
    oh = F.one_hot(flat_e, E).to(torch.int32)                      # (T*K, E)
    pos_all = torch.cumsum(oh, dim=0, dtype=torch.int32) - 1
    my_pos = pos_all.gather(1, flat_e[:, None])[:, 0]
    keep = my_pos < C
    safe_e = torch.where(keep, flat_e, E)                     # E: dump row
    safe_p = torch.where(keep, my_pos, 0).to(torch.int64)

    buf = torch.zeros((E + 1, C, D), dtype=dt, device=dev)
    buf[safe_e, safe_p] = x[flat_t]
    xb = buf[:E]                                                   # (E, C, D)
    g = F.silu(torch.bmm(xb, lp["we_gate"].to(dt)))
    u = torch.bmm(xb, lp["we_up"].to(dt))
    yb = torch.bmm(g * u, lp["we_down"].to(dt))                    # (E, C, D)

    yb = torch.cat([yb, torch.zeros((1, C, D), dtype=dt, device=dev)])
    contrib = yb[safe_e, safe_p] * (flat_w * keep)[:, None].to(dt)
    contrib = contrib.view(T, K, D)
    y = contrib[:, 0]
    for j in range(1, K):
        y = y + contrib[:, j]

    # Switch-style load-balance loss
    hit = (top_ids[..., None] == torch.arange(E, device=dev)).any(dim=1)
    frac_tokens = torch.mean(hit.to(torch.float32), dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = E * torch.sum(frac_tokens * mean_prob)
    return y.to(dt), aux
