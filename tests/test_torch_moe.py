"""The port's MoE (``repro_torch.models.moe``) against the JAX package's on
the CPU: ``moe_ffn``'s output and aux loss with and without capacity
drops in float32 (rtol 1e-5 atol 1e-6) and bfloat16 (rtol and atol 2e-2,
the tolerance of ``tests/test_arch_smoke.py``: a token's output is a sum
of K expert outputs each rounded to bfloat16, and where they cancel the
error is an ulp of the summands, 0.0156 at a magnitude of 2), ``_capacity``
over a grid, the dense-mix twin of
``tests/test_arch_smoke.py::test_moe_dispatch_matches_dense_compute``, and
the transformer's ``_ffn_block`` over ``moe_groups=2``.  JAX weights come
across as numpy arrays."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from _torch_threads import _one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 2e-2)}


def _cfgs(cf, **kw):
    j = JM.MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                     capacity_factor=cf, **kw)
    t = TM.MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                     capacity_factor=cf, **kw)
    return j, t


def _layer(seed=0, d=16, cfg=None, skew=0.0):
    """One layer's JAX weights and the same as tensors; ``skew`` is added
    to expert 0's router column, so that tokens of a positive mean crowd
    it."""
    cfg = cfg or _cfgs(1.25)[0]
    lp = jax.tree.map(lambda a: a[0],
                      JM.init_moe_layer(jax.random.PRNGKey(seed), 1, d, cfg))
    lp["router"] = lp["router"].at[:, 0].add(skew)
    return lp, {k: torch.tensor(np.asarray(v)) for k, v in lp.items()}


def _x(T, d, dtype, seed=1, mean=0.0):
    jdt, tdt = DTYPES[dtype][:2]
    x = (np.random.default_rng(seed).normal(size=(T, d)) + mean
         ).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    return jx, torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)


def _drops(x: np.ndarray, lp: dict, cfg) -> int:
    """Assignments past their expert's capacity under JAX's routing."""
    probs = jax.nn.softmax(jnp.asarray(x) @ lp["router"], -1)
    ids = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]).reshape(-1)
    C = JM._capacity(x.shape[0], cfg)
    return int(sum(max(0, n - C) for n in np.bincount(ids, minlength=4)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cf,T", [(4.0, 24), (1.0, 64)],
                         ids=["no-drops", "drops"])
def test_moe_ffn_matches_jax(cf, T, dtype):
    jcfg, tcfg = _cfgs(cf)
    lp, tlp = _layer(cfg=jcfg, skew=1.0 if cf == 1.0 else 0.0)
    jx, tx = _x(T, 16, dtype, mean=1.0 if cf == 1.0 else 0.0)
    drops = _drops(np.asarray(jx.astype(jnp.float32)), lp, jcfg)
    assert (drops > 0) == (cf == 1.0)
    jy, jaux = JM.moe_ffn(jx, lp, jcfg)
    ty, taux = TM.moe_ffn(tx, tlp, tcfg)
    rtol, atol = DTYPES[dtype][2:]
    assert ty.dtype == tx.dtype and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.to(torch.float32).numpy(),
                               np.asarray(jy, np.float32), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_moe_ffn_drops_write_nothing_past_capacity():
    """With every token on one expert, only the first C assignments to it
    count: a dropped token's output is its other expert's share alone."""
    _, tcfg = _cfgs(1.0)
    _, tlp = _layer()
    tlp = dict(tlp)
    router = torch.zeros_like(tlp["router"])
    router[:, 0] = 1.0                                  # expert 0 first
    tlp["router"] = router
    x = torch.ones((40, 16))
    y, _ = TM.moe_ffn(x, tlp, tcfg)
    C = TM._capacity(40, tcfg)
    assert C < 40
    torch.testing.assert_close(y[C:], y[C:C + 1].expand(40 - C, 16))
    assert not torch.allclose(y[0], y[C])


@pytest.mark.parametrize("T,E,K,cf", list(itertools.product(
    (1, 7, 64, 1000, 16384), (4, 8, 128), (1, 2, 8), (1.0, 1.25, 4.0, 16.0))))
def test_capacity_matches_jax(T, E, K, cf):
    j = JM.MoEConfig(n_experts=E, top_k=K, d_ff_expert=8, capacity_factor=cf)
    t = TM.MoEConfig(n_experts=E, top_k=K, d_ff_expert=8, capacity_factor=cf)
    c = TM._capacity(T, t)
    assert c == JM._capacity(T, j)
    assert c % 8 == 0 and c >= 8


def test_capacity_at_qwen3_prefill():
    """4 x 4,096 tokens at 128 experts top-8, capacity factor 1.25."""
    moe = TM.MoEConfig(n_experts=128, top_k=8, d_ff_expert=768)
    assert TM._capacity(16_384, moe) == 1_288


def test_moe_dispatch_matches_dense_compute():
    """Scatter-dispatch MoE == explicit per-token dense expert mix (with
    generous capacity so nothing drops), the port's twin of the JAX test."""
    _, cfg = _cfgs(8.0)
    _, lp = _layer(0)
    x = torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                  (24, 16), jnp.float32)))
    y, aux = TM.moe_ffn(x, lp, cfg)
    probs = torch.softmax(x @ lp["router"], -1)
    top_p, top_ids = torch.topk(probs, 2)
    top_w = top_p / top_p.sum(-1, keepdim=True)
    ref = torch.zeros_like(x)
    for e in range(4):
        g = torch.nn.functional.silu(x @ lp["we_gate"][e])
        u = x @ lp["we_up"][e]
        fe = (g * u) @ lp["we_down"][e]
        w = torch.where(top_ids == e, top_w, 0.0).sum(-1)
        ref += fe * w[:, None]
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)
    assert float(aux) > 0


def test_top_k_breaks_ties_to_the_lower_index_as_lax_top_k():
    p = np.array([[0.2, 0.3, 0.2, 0.3], [0.25, 0.25, 0.25, 0.25]],
                 np.float32)
    v, i = TM.top_k_desc(torch.tensor(p), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(p), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_abs_and_init_moe_layer_shapes():
    _, cfg = _cfgs(1.25)
    a = TM.abs_moe_layer(3, 16, cfg)
    g = torch.Generator().manual_seed(0)
    p = TM.init_moe_layer(g, 3, 16, cfg, device="cpu")
    j = JM.abs_moe_layer(3, 16, _cfgs(1.25)[0])
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in j.items()}
    assert all(v.device.type == "meta" for v in a.values())
    # 1/sqrt(fan_in) times a normal truncated to [-2, 2]
    assert float(p["we_down"].abs().max()) <= 2 / np.sqrt(32) + 1e-6


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("groups", [1, 2, 3])
def test_ffn_block_over_moe_groups_matches_jax(groups, dtype):
    """moe_groups=2 dispatches each half of the tokens with its own
    capacity (capacity factor 1.0 and a router that crowds expert 0: one
    dispatch of the 32 tokens drops assignments the groups of 16 keep); 3
    groups do not divide the 2 x 16 tokens and fall back to one dispatch,
    as in JAX."""
    from repro.configs import get_arch as jget
    from repro_torch.configs import get_arch as tget

    jdt, tdt, rtol, atol = DTYPES[dtype]
    jmoe, tmoe = _cfgs(1.0)
    jcfg = dataclasses.replace(jget("qwen3-moe-30b-a3b").reduced(),
                               moe=jmoe, moe_groups=groups, dtype=jdt,
                               d_model=16)
    tcfg = dataclasses.replace(tget("qwen3-moe-30b-a3b").reduced(),
                               moe=tmoe, moe_groups=groups, dtype=tdt,
                               d_model=16)
    lp, tlp = _layer(3, cfg=jmoe, skew=2.0)
    x = (np.random.default_rng(4).normal(size=(2, 16, 16)) + 1.0
         ).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)
    jy, jaux = JT._ffn_block(lp, jx, jcfg)
    ty, taux = TT._ffn_block(tlp, tx, tcfg)
    np.testing.assert_allclose(ty.to(torch.float32).numpy(),
                               np.asarray(jy, np.float32), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    if groups == 2:
        one, _ = TT._ffn_block(tlp, tx, dataclasses.replace(tcfg,
                                                            moe_groups=1))
        assert not torch.allclose(one, ty)
