"""Shared neural layers, ported from ``src/repro/models/layers.py``:
initialisers, norms, rotary embeddings, grouped-query attention, the
gated MLPs and the recsys towers, as plain functions on tensors.

Conventions, as in the JAX package: parameters are float32 tensors drawn
from an explicit ``torch.Generator`` on the given device; compute casts
them to the activations' dtype (bfloat16 for the LMs) at each use, with
float32 logits, softmax and norm statistics.  :func:`abs_p` is the twin
of the JAX ``abs_p``: a tensor on the ``meta`` device, a shape without
memory.  :class:`ParamTree` holds a model's parameters under the JAX
dict's names.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

_LO, _HI = -2.0, 2.0                    # jax.random.truncated_normal bounds


def _normal_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def dense_init(generator: torch.Generator, shape, scale: Optional[float] = None,
               device="cuda") -> torch.Tensor:
    """``scale`` (default ``1/sqrt(shape[-2])``, or ``shape[-1]`` for a
    vector) times a normal truncated to [-2, 2], by inverse-CDF sampling
    in place, so a table of gigabytes needs no second buffer."""
    shape = tuple(int(s) for s in shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(2 * _normal_cdf(_LO) - 1, 2 * _normal_cdf(_HI) - 1,
               generator=generator)
    return t.erfinv_().mul_(math.sqrt(2.0)).clamp_(_LO, _HI).mul_(scale)


def abs_p(*shape, dtype=torch.float32) -> torch.Tensor:
    """A tensor of ``shape`` on the ``meta`` device: shape and dtype, no
    memory (the JAX package's ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


class ParamTree(nn.Module):
    """A model's parameters under the JAX dict's names: tensors as frozen
    parameters, sub-dicts as ``nn.ParameterDict``s.  ``params()`` gives
    them back as the JAX package's nested dict (the same tensors: an
    in-place update of a leaf updates the model), which is what the
    optimizers and the checkpoints of ``repro_torch.train`` walk."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        for name, value in params.items():
            if isinstance(value, dict):
                value = nn.ParameterDict({k: param(v)
                                          for k, v in value.items()})
            else:
                value = param(value)
            setattr(self, name, value)

    def params(self) -> dict:
        return {name: (dict(m.items()) if isinstance(m, nn.ParameterDict)
                       else m)
                for name, m in {**self._parameters, **self._modules}.items()}


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, scaled by ``1 + scale``, in ``x``'s dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 over the population variance."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope_frequencies(d_head: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, Dh), positions (..., S) -> x rotated by split halves
    (the first Dh/2 features pair with the last Dh/2, not interleaved)."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)        # (Dh/2,)
    ang = positions[..., :, None].to(torch.float32) * inv   # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]                      # (.., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA + causal + optional sliding window + query chunking)
# --------------------------------------------------------------------------
_NEG = -1e30   # large finite mask value: softmax of an all-masked row is
               # uniform, never NaN


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Optional[int],
               k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive float32 bias (Sq, Sk): 0 where attendable, -1e30 otherwise.
    Positions are 1-D, shared by every batch lane; ``window`` is an int
    (``1 << 30`` stands for no window) or None."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    if k_valid is not None:
        ok &= k_valid[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, _NEG)


def f32_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, as a float32 product of ``a`` and ``b``'s values:
    the JAX ``einsum(..., preferred_element_type=float32)``, whose
    products are exact and whose sums are float32.  On a card, bfloat16
    or float16 operands with no gradient to take go through
    ``torch.bmm(..., out_dtype=float32)`` (the tensor cores, float32
    accumulation); anywhere else the operands are upcast to float32,
    whose products of 8-bit mantissas are exact (TF32 off)."""
    if (a.is_cuda and a.dtype in (torch.bfloat16, torch.float16)
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or b.requires_grad))):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                  window: Optional[int] = None,
                  k_valid: Optional[torch.Tensor] = None,
                  q_chunk: Optional[int] = None,
                  softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, Hq, Dh), k/v (B, Sk, Hkv, Dh) -> (B, Sq, Hq, Dh).

    ``q_pos`` (Sq,) / ``k_pos`` (Sk,) are 1-D position ids shared by every
    batch lane; ``k_valid`` (Sk,) masks cache slots (decode).  Query head
    ``h`` reads KV head ``h // (Hq / Hkv)``, as the JAX package's
    broadcast of the KV heads gives it; here the query heads of a group
    share one product with their KV head instead of a copy of it.  The
    scores and the P.V product are float32 sums of the operands' exact
    products (:func:`f32_bmm`), the softmax is float32, and its
    probabilities are cast to q's dtype before P.V.

    ``q_chunk`` bounds the score tile to (B, Hq, q_chunk, Sk) float32: the
    chunks run one after another.  The JAX package pads the last chunk
    with queries at position -1 and drops their rows; a row depends on
    its own query alone, so the port runs the last chunk short instead.
    """
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads over {Hkv} KV heads")
    rep = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(Dh)
    # (B * Hkv, Dh, Sk) and (B * Hkv, Sk, Dh)
    kt = k.permute(0, 2, 3, 1).reshape(B * Hkv, Dh, Sk)
    vt = v.permute(0, 2, 1, 3).reshape(B * Hkv, Sk, Dh)

    def attend(qc: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
        Sc = qc.shape[1]
        # (B, Sc, Hkv, rep, Dh) -> (B * Hkv, rep * Sc, Dh)
        qg = qc.reshape(B, Sc, Hkv, rep, Dh).permute(0, 2, 3, 1, 4) \
            .reshape(B * Hkv, rep * Sc, Dh)
        logits = f32_bmm(qg, kt).mul_(scale).view(B, Hq, Sc, Sk)
        logits += _mask_bias(qp, k_pos, window, k_valid)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        del logits
        out = f32_bmm(probs.view(B * Hkv, rep * Sc, Sk), vt)
        # (B * Hkv, rep * Sc, Dh) -> (B, Sc, Hq, Dh)
        return out.view(B, Hkv, rep, Sc, Dh).permute(0, 3, 1, 2, 4) \
            .reshape(B, Sc, Hq, Dh).to(q.dtype)

    if q_chunk is None or q_chunk >= Sq:
        return attend(q, q_pos)
    return torch.cat([attend(q[:, s:s + q_chunk], q_pos[s:s + q_chunk])
                      for s in range(0, Sq, q_chunk)], dim=1)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = F.silu(x @ w_gate.to(dt))
    u = x @ w_up.to(dt)
    return (g * u) @ w_down.to(dt)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form (torch's default is erf)."""
    dt = x.dtype
    h = F.gelu(x @ w_up.to(dt) + b_up.to(dt), approximate="tanh")
    return h @ w_down.to(dt) + b_down.to(dt)


def mlp_tower(generator: torch.Generator, sizes: list[int],
              device="cuda") -> dict:
    """Plain MLP parameter stack: sizes [in, h1, ..., out] -> ``w{i}``
    (sizes[i], sizes[i+1]) and zero biases ``b{i}``."""
    n = len(sizes) - 1
    p = {f"w{i}": dense_init(generator, (sizes[i], sizes[i + 1]),
                             device=device) for i in range(n)}
    return p | {f"b{i}": torch.zeros(sizes[i + 1], device=device)
                for i in range(n)}


def abs_mlp_tower(sizes: list[int], dtype=torch.float32) -> dict:
    """:func:`mlp_tower`'s shapes as ``meta`` tensors."""
    n = len(sizes) - 1
    return {f"w{i}": abs_p(sizes[i], sizes[i + 1], dtype=dtype)
            for i in range(n)} | {f"b{i}": abs_p(sizes[i + 1], dtype=dtype)
                                  for i in range(n)}


def apply_mlp_tower(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                    act: Callable = torch.relu,
                    final_act: Optional[Callable] = None) -> torch.Tensor:
    n = len([k for k in params if k.startswith("w")])
    dt = x.dtype
    for i in range(n):
        x = x @ params[f"w{i}"].to(dt) + params[f"b{i}"].to(dt)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x
