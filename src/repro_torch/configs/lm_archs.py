"""The five assigned LM-family architectures (exact public configs), ported
from ``src/repro/configs/lm_archs.py``.

Sources are the assignment table entries; d_head is derived as
d_model // n_heads where the table does not pin it.
"""
from __future__ import annotations

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

from .base import ArchSpec, LM_SHAPES

_FULL_ATTN_SKIP = ("long_500k needs sub-quadratic attention; this arch is "
                   "pure full attention (assignment rule: skip + note)")


def _reduced_lm(moe: bool = False, window=None, pattern=None):
    return TransformerConfig(
        name="reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256,
        sliding_window=window, local_global_pattern=pattern,
        # capacity_factor 4.0: the smoke tests hold prefill/decode
        # consistency, which needs no capacity drops; full configs keep 1.25
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                      capacity_factor=4.0) if moe else None,
        remat=False, q_chunk=32)


PHI3_MINI = ArchSpec(
    name="phi3-mini-3.8b", family="lm",
    model=TransformerConfig(
        name="phi3-mini-3.8b", n_layers=32, d_model=3072, n_heads=32,
        n_kv_heads=32, d_ff=8192, vocab=32064, rope_theta=10000.0,
        tie_embeddings=False),
    shapes=LM_SHAPES,
    reduced=lambda: _reduced_lm(),
    skip={"long_500k": _FULL_ATTN_SKIP},
    notes="arXiv:2404.14219 — RoPE SwiGLU, MHA (GQA kv=32 == heads)")

GRANITE_3_2B = ArchSpec(
    name="granite-3-2b", family="lm",
    model=TransformerConfig(
        name="granite-3-2b", n_layers=40, d_model=2048, n_heads=32,
        n_kv_heads=8, d_ff=8192, vocab=49155, tie_embeddings=True),
    shapes=LM_SHAPES,
    reduced=lambda: _reduced_lm(),
    skip={"long_500k": _FULL_ATTN_SKIP},
    notes="hf:ibm-granite/granite-3.0-2b-base — GQA kv=8")

GEMMA3_12B = ArchSpec(
    name="gemma3-12b", family="lm",
    model=TransformerConfig(
        name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16,
        n_kv_heads=8, d_ff=15360, vocab=262144, sliding_window=1024,
        local_global_pattern=5, tie_embeddings=True),
    shapes=LM_SHAPES,
    reduced=lambda: _reduced_lm(window=8, pattern=1),
    notes=("hf:google/gemma-3 family — 5 local(window 1024):1 global; "
           "long_500k RUNS: 40/48 layers hold a 1024-slot ring cache, the 8 "
           "global layers hold the full 500k cache (sharded)"))

QWEN3_MOE = ArchSpec(
    name="qwen3-moe-30b-a3b", family="lm",
    model=TransformerConfig(
        name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=4, d_ff=768, vocab=151936,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
        tie_embeddings=True),
    shapes=LM_SHAPES,
    reduced=lambda: _reduced_lm(moe=True),
    skip={"long_500k": _FULL_ATTN_SKIP},
    notes="hf:Qwen/Qwen3-30B-A3B — 128 experts top-8, GQA kv=4")

MIXTRAL_8X22B = ArchSpec(
    name="mixtral-8x22b", family="lm",
    model=TransformerConfig(
        name="mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48,
        n_kv_heads=8, d_head=128, d_ff=16384, vocab=32768,
        sliding_window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
        tie_embeddings=False),
    shapes=LM_SHAPES,
    reduced=lambda: _reduced_lm(moe=True, window=8),
    notes=("arXiv:2401.04088 — 8 experts top-2, SWA window 4096 on all "
           "layers; long_500k RUNS with the 4096-slot ring cache"))

LM_ARCHS = (PHI3_MINI, GRANITE_3_2B, GEMMA3_12B, QWEN3_MOE, MIXTRAL_8X22B)

for _spec in LM_ARCHS:
    if _spec.model.n_heads % _spec.model.n_kv_heads:
        raise ValueError(f"{_spec.name}: heads do not group over KV heads")
