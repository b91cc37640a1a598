"""Decoder-only transformer covering the five LM architectures, ported from
``src/repro/models/transformer.py``.

One parameterized implementation: RMSNorm + RoPE + GQA + SwiGLU, optional
sliding-window layers (Mixtral: all layers; Gemma-3: 5 local : 1 global)
and optional MoE FFN (Qwen3-MoE, Mixtral).  The model is a
:class:`TransformerModel` whose parameter names are the JAX parameter
dict's leaves (``embed``, ``final_norm``, ``layers.wq``, ...), float32,
with the per-layer weights stacked along a leading ``L`` dim;
``params()`` gives the JAX layout, so interop is a straight copy.

The training forward is a Python loop over the stacked layers (the JAX
package scans them), each layer under ``torch.utils.checkpoint`` when
``cfg.remat`` is set and a gradient is being taken.  The serving path
(prefill + decode) runs under ``torch.inference_mode()`` and keeps a cache
per layer at its natural size: sliding-window layers hold a ring buffer
of ``window`` slots instead of the full context.  The cache's ``pos`` is a
host int, so neither the decode step's slot nor its past-the-end check
reads the device; decoding a global layer past ``max_len`` raises
``ValueError`` where the JAX ``dynamic_update_slice`` clamps into the last
slot and overwrites it.

The fields that only constrain a sharded layout in the JAX package
(``act_batch_axes``, ``act_seq_axis``, ``moe_shard_axes``) are kept so that
configs cross over one to one; on one device they do nothing.
``moe_groups`` does change results (capacity is counted per group), so
the port dispatches its groups one after another.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from .layers import (ParamTree, abs_p, apply_rope, dense_init, gqa_attention,
                     rms_norm, swiglu)
from .moe import MoEConfig, _moe_shapes, init_moe_layer, moe_ffn

_NO_WINDOW = 1 << 30           # a window no position difference reaches


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    rope_theta: float = 10000.0
    # sliding window: None = all layers full causal;
    # set + pattern None = every layer windowed (Mixtral SWA);
    # set + pattern p   = p local layers then 1 global, repeating (Gemma-3).
    sliding_window: Optional[int] = None
    local_global_pattern: Optional[int] = None
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    q_chunk: int = 1024          # query chunking for long prefill
    # MoE dispatch grouping: tokens are reshaped to (G, T/G) and each group
    # is dispatched with its own capacity
    moe_groups: int = 1
    # sharding constraints of the JAX package; nothing on one device
    moe_shard_axes: Optional[tuple] = None
    act_batch_axes: Optional[tuple] = None
    act_seq_axis: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def is_global_layer(self) -> np.ndarray:
        """(L,) bool — which layers attend globally."""
        L = self.n_layers
        if self.sliding_window is None:
            return np.ones(L, bool)
        p = self.local_global_pattern
        if p is None:
            return np.zeros(L, bool)
        return np.array([(i + 1) % (p + 1) == 0 for i in range(L)])

    def layer_window(self, i: int) -> Optional[int]:
        return None if self.is_global_layer()[i] else self.sliding_window

    @property
    def param_count(self) -> int:
        return sum(math.prod(s) for s in _leaf_shapes(self))

    @property
    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        total = self.param_count
        if self.moe is None:
            return total
        e, k = self.moe.n_experts, self.moe.top_k
        expert_p = 3 * self.d_model * self.moe.d_ff_expert * self.n_layers * e
        return total - expert_p + expert_p * k // e


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
def _layer_shapes(cfg: TransformerConfig) -> dict[str, tuple]:
    D, Dh, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    s = {
        "attn_norm": (L, D),
        "mlp_norm": (L, D),
        "wq": (L, D, cfg.n_heads * Dh),
        "wk": (L, D, cfg.n_kv_heads * Dh),
        "wv": (L, D, cfg.n_kv_heads * Dh),
        "wo": (L, cfg.n_heads * Dh, D),
    }
    if cfg.moe is None:
        s |= {"w_gate": (L, D, cfg.d_ff), "w_up": (L, D, cfg.d_ff),
              "w_down": (L, cfg.d_ff, D)}
    return s


def _param_shapes(cfg: TransformerConfig) -> dict:
    layers = _layer_shapes(cfg)
    if cfg.moe is not None:
        layers |= _moe_shapes(cfg.n_layers, cfg.d_model, cfg.moe)
    p = {"embed": (cfg.vocab, cfg.d_model), "final_norm": (cfg.d_model,),
         "layers": layers}
    if not cfg.tie_embeddings:
        p["head"] = (cfg.d_model, cfg.vocab)
    return p


def _leaf_shapes(cfg: TransformerConfig) -> list[tuple]:
    p = _param_shapes(cfg)
    return [s for v in p.values()
            for s in (v.values() if isinstance(v, dict) else [v])]


def abstract_params(cfg: TransformerConfig) -> dict:
    """The parameter tree as float32 tensors on the ``meta`` device."""
    return {k: ({n: abs_p(*s) for n, s in v.items()} if isinstance(v, dict)
                else abs_p(*v))
            for k, v in _param_shapes(cfg).items()}


class TransformerModel(ParamTree):
    """One LM's parameters under the JAX dict's names (``embed``,
    ``final_norm``, ``layers.<name>`` stacked over layers, ``head`` when
    untied), frozen; ``params()`` is the JAX layout.  The entry points are
    the module's functions, which take the model."""


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device="cuda") -> TransformerModel:
    """Random parameters drawn from ``generator`` (on ``device``), in the
    JAX package's shapes and scales: projections at ``1/sqrt(fan_in)``
    times a truncated normal, the embeddings at 0.02, norms at zero (they
    scale by ``1 + scale``); frozen."""
    g = generator
    layers = {}
    for name, shape in _layer_shapes(cfg).items():
        if "norm" in name:
            layers[name] = torch.zeros(shape, device=device)
        else:
            layers[name] = dense_init(g, shape, device=device)
    if cfg.moe is not None:
        layers |= init_moe_layer(g, cfg.n_layers, cfg.d_model, cfg.moe,
                                 device)
    p = {"embed": dense_init(g, (cfg.vocab, cfg.d_model), scale=0.02,
                             device=device),
         "final_norm": torch.zeros(cfg.d_model, device=device),
         "layers": layers}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(g, (cfg.d_model, cfg.vocab), device=device)
    return TransformerModel(cfg, p)


def _params_cfg(model_or_params, cfg: Optional[TransformerConfig]):
    if isinstance(model_or_params, TransformerModel):
        return model_or_params.params(), model_or_params.cfg
    if cfg is None:
        raise ValueError("a parameter dict needs its TransformerConfig")
    return model_or_params, cfg


def _layer_params(p: dict, i: int) -> dict:
    return {k: v[i] for k, v in p["layers"].items()}


def _head(p: dict) -> torch.Tensor:
    """The untied head, or the embeddings' transpose (tied)."""
    return p["head"] if "head" in p else p["embed"].T


def _embed(p: dict, tokens: torch.Tensor, dt) -> torch.Tensor:
    # the JAX package casts the whole table and gathers; gathering first
    # gives the same values without a cast copy of the table
    return p["embed"][tokens.long()].to(dt)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
def _window(cfg: TransformerConfig, windowed: bool) -> Optional[int]:
    """The layer's effective window: ``sliding_window`` on a windowed layer,
    ``1 << 30`` (no restriction) on a global one, None without windows."""
    if cfg.sliding_window is None:
        return None
    return cfg.sliding_window if windowed else _NO_WINDOW


def _qkv(lp: dict, x: torch.Tensor, q_pos: torch.Tensor,
         cfg: TransformerConfig):
    B, S, _ = x.shape
    dt = x.dtype
    Dh, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ lp["wq"].to(dt)).reshape(B, S, Hq, Dh)
    k = (x @ lp["wk"].to(dt)).reshape(B, S, Hkv, Dh)
    v = (x @ lp["wv"].to(dt)).reshape(B, S, Hkv, Dh)
    return (apply_rope(q, q_pos, cfg.rope_theta),
            apply_rope(k, q_pos, cfg.rope_theta), v)


def _attend(lp: dict, q, k, v, q_pos, k_pos, cfg: TransformerConfig,
            windowed: bool, *, k_valid=None, q_chunk=None) -> torch.Tensor:
    B, S = q.shape[:2]
    out = gqa_attention(q, k, v, q_pos, k_pos, window=_window(cfg, windowed),
                        k_valid=k_valid, q_chunk=q_chunk)
    return out.reshape(B, S, -1) @ lp["wo"].to(q.dtype)


def _ffn_block(lp: dict, x: torch.Tensor, cfg: TransformerConfig):
    """Returns (out, aux_loss)."""
    if cfg.moe is None:
        return swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"]), 0.0
    B, S, D = x.shape
    T = B * S
    G = cfg.moe_groups if T % max(cfg.moe_groups, 1) == 0 else 1
    if G <= 1:
        y, aux = moe_ffn(x.reshape(T, D), lp, cfg.moe)
        return y.reshape(B, S, D), aux
    outs = [moe_ffn(xg, lp, cfg.moe) for xg in x.reshape(G, T // G, D)]
    y = torch.stack([o[0] for o in outs])
    return y.reshape(B, S, D), torch.mean(torch.stack([o[1] for o in outs]))


def _layer(lp: dict, x: torch.Tensor, q_pos: torch.Tensor,
           cfg: TransformerConfig, windowed: bool, q_chunk=None):
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = _qkv(lp, h, q_pos, cfg)
    x = x + _attend(lp, q, k, v, q_pos, q_pos, cfg, windowed,
                    q_chunk=q_chunk)
    h = rms_norm(x, lp["mlp_norm"])
    f, aux = _ffn_block(lp, h, cfg)
    return x + f, aux


def _layers(p: dict, x: torch.Tensor, cfg: TransformerConfig, q_chunk=None,
            remat: bool = False):
    """x through every layer; (x, the layers' aux losses summed)."""
    q_pos = torch.arange(x.shape[1], device=x.device)
    glob = cfg.is_global_layer()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        args = (_layer_params(p, i), x, q_pos, cfg, not glob[i], q_chunk)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(_layer, *args,
                                                     use_reentrant=False)
        else:
            x, a = _layer(*args)
        aux = aux + a
    return x, aux


# --------------------------------------------------------------------------
# training forward + loss
# --------------------------------------------------------------------------
def forward_train(model_or_params, tokens: torch.Tensor,
                  cfg: Optional[TransformerConfig] = None):
    """tokens (B, S) -> (logits (B, S, V) float32, aux_loss scalar), with
    autograd as the caller has it."""
    p, cfg = _params_cfg(model_or_params, cfg)
    S = tokens.shape[1]
    x = _embed(p, tokens, cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    x, aux = _layers(p, x, cfg, cfg.q_chunk if S > cfg.q_chunk else None,
                     remat)
    x = rms_norm(x, p["final_norm"])
    logits = (x @ _head(p).to(cfg.dtype)).to(torch.float32)
    return logits, aux


def loss_fn(model_or_params, batch: dict,
            cfg: Optional[TransformerConfig] = None):
    """Next-token cross entropy over the labels >= 0, plus 0.01 x aux.
    A label of -1 is masked: its index is clamped to 0 before the gather
    (JAX wraps it to the last column; the mask removes either)."""
    p, cfg = _params_cfg(model_or_params, cfg)
    logits, aux = forward_train(p, batch["tokens"], cfg)
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    true = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = torch.sum((lse - true) * mask) / torch.clamp_min(torch.sum(mask),
                                                            1.0)
    loss = nll + 0.01 * aux
    return loss, {"nll": nll, "aux": aux}


# --------------------------------------------------------------------------
# serving: per-layer KV caches (ring buffers on sliding-window layers)
# --------------------------------------------------------------------------
def _cache_len(cfg: TransformerConfig, i: int, max_len: int) -> int:
    w = cfg.layer_window(i)
    return max_len if w is None else min(w, max_len)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zero K and V caches, one (B, slots, Hkv, Dh) tensor a layer in
    ``cfg.dtype``, and ``pos`` 0 (a host int)."""
    ks, vs = [], []
    for i in range(cfg.n_layers):
        shape = (batch, _cache_len(cfg, i, max_len), cfg.n_kv_heads,
                 cfg.head_dim)
        ks.append(torch.zeros(shape, dtype=cfg.dtype, device=device))
        vs.append(torch.zeros(shape, dtype=cfg.dtype, device=device))
    return {"k": ks, "v": vs, "pos": 0}


def abstract_cache(cfg: TransformerConfig, batch: int, max_len: int) -> dict:
    """The cache's tensors on the ``meta`` device; ``pos`` an int32 one."""
    shapes = [(batch, _cache_len(cfg, i, max_len), cfg.n_kv_heads,
               cfg.head_dim) for i in range(cfg.n_layers)]
    return {"k": [abs_p(*s, dtype=cfg.dtype) for s in shapes],
            "v": [abs_p(*s, dtype=cfg.dtype) for s in shapes],
            "pos": abs_p(dtype=torch.int32)}


def _ring_slot_positions(cache_len: int, pos_next: int,
                         device=None) -> torch.Tensor:
    """Absolute token position stored in each ring slot once ``pos_next``
    tokens have been written; slots not yet written get -1.  The floored
    ``%`` of the JAX package: ``torch.remainder``."""
    j = torch.arange(cache_len, device=device)
    last = pos_next - 1
    p = last - torch.remainder(last - j, cache_len)
    return torch.where((p >= 0) & (p <= last), p, -1)


@torch.inference_mode()
def serve_prefill(model_or_params, tokens: torch.Tensor,
                  max_len: Optional[int] = None,
                  cfg: Optional[TransformerConfig] = None):
    """Full forward over the prompt; returns (last-token logits (B, V)
    float32, cache).  A global layer's cache holds positions
    ``[0, min(max_len, S))``; a windowed layer's ring holds the last
    ``min(slots, S)`` positions at slots ``pos % slots``."""
    p, cfg = _params_cfg(model_or_params, cfg)
    B, S = tokens.shape
    max_len = max_len or S
    dt = cfg.dtype
    x = _embed(p, tokens, dt)
    q_pos = torch.arange(S, device=x.device)
    cache = init_cache(cfg, B, max_len, x.device)
    q_chunk = cfg.q_chunk if S > cfg.q_chunk else None
    for i in range(cfg.n_layers):
        lp = _layer_params(p, i)
        w = cfg.layer_window(i)
        h = rms_norm(x, lp["attn_norm"])
        q, k, v = _qkv(lp, h, q_pos, cfg)
        cl = cache["k"][i].shape[1]
        if w is None:
            n = min(cl, S)
            cache["k"][i][:, :n] = k[:, :n]
            cache["v"][i][:, :n] = v[:, :n]
        else:
            take = min(cl, S)
            slots = torch.arange(S - take, S, device=x.device) % cl
            cache["k"][i][:, slots] = k[:, S - take:]
            cache["v"][i][:, slots] = v[:, S - take:]
        x = x + _attend(lp, q, k, v, q_pos, q_pos, cfg, w is not None,
                        q_chunk=q_chunk)
        del q, k, v
        h = rms_norm(x, lp["mlp_norm"])
        f, _ = _ffn_block(lp, h, cfg)
        x = x + f
    x = rms_norm(x[:, -1], p["final_norm"])
    logits = (x @ _head(p).to(dt)).to(torch.float32)
    cache["pos"] = S
    return logits, cache


@torch.inference_mode()
def serve_decode_step(model_or_params, cache: dict, token: torch.Tensor,
                      cfg: Optional[TransformerConfig] = None):
    """One decode step: token (B, 1) -> (logits (B, V) float32, cache).
    The cache's tensors are written in place and ``pos`` advanced; the
    same dict comes back.  Raises ``ValueError`` when a global layer's
    cache has no slot left for position ``pos``."""
    p, cfg = _params_cfg(model_or_params, cfg)
    B = token.shape[0]
    dt = cfg.dtype
    pos = int(cache["pos"])
    glob = cfg.is_global_layer()
    for i in range(cfg.n_layers):
        if glob[i] and pos >= cache["k"][i].shape[1]:
            raise ValueError(
                f"decode at position {pos} past the {cache['k'][i].shape[1]}"
                f"-slot cache of global layer {i} (max_len)")
    x = _embed(p, token, dt)                                  # (B, 1, D)
    dev = x.device
    q_pos = torch.full((1,), pos, device=dev)
    for i in range(cfg.n_layers):
        lp = _layer_params(p, i)
        w = cfg.layer_window(i)
        ck, cv = cache["k"][i], cache["v"][i]
        cl = ck.shape[1]
        h = rms_norm(x, lp["attn_norm"])
        q, k_new, v_new = _qkv(lp, h, q_pos, cfg)
        slot = pos % cl if w is not None else pos
        ck[:, slot] = k_new[:, 0]
        cv[:, slot] = v_new[:, 0]
        if w is None:
            k_pos = torch.arange(cl, device=dev)
            k_valid = k_pos <= pos
        else:
            k_pos = _ring_slot_positions(cl, pos + 1, dev)
            k_valid = k_pos >= 0
        x = x + _attend(lp, q, ck, cv, q_pos, k_pos, cfg, w is not None,
                        k_valid=k_valid)
        h = rms_norm(x, lp["mlp_norm"])
        f, _ = _ffn_block(lp, h, cfg)
        x = x + f
    x = rms_norm(x[:, 0], p["final_norm"])
    logits = (x @ _head(p).to(dt)).to(torch.float32)
    cache["pos"] = pos + 1
    return logits, cache


@torch.inference_mode()
def embed_sequences(model_or_params, tokens: torch.Tensor,
                    cfg: Optional[TransformerConfig] = None) -> torch.Tensor:
    """Mean-pooled final hidden states (B, D) float32 — the embedding DEG
    indexes (kNN-LM-style retrieval examples)."""
    p, cfg = _params_cfg(model_or_params, cfg)
    x, _ = _layers(p, _embed(p, tokens, cfg.dtype), cfg)
    x = rms_norm(x, p["final_norm"])
    return torch.mean(x.to(torch.float32), dim=1)
