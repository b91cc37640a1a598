"""The port's transformer (``repro_torch.models.transformer``) against the
JAX package's on the CPU, for the five LM architectures' ``reduced()``
configs: the JAX weights (``init_params``) carried across by
``interop.lm_model_from_numpy``, the same tokens from a numpy seed, and
``forward_train`` (logits and aux), ``serve_prefill`` with its ``k`` /
``v`` / ``pos`` cache, decode steps and ``embed_sequences`` through both.
Tolerances: float32 rtol 1e-4 atol 1e-5; bfloat16 rtol and atol 2e-2
(``tests/test_arch_smoke.py``'s).

bfloat16 and the MoE archs: two packages that add float32 sums in other
orders round an activation to another bfloat16 neighbour now and then, and
a token whose K-th and (K+1)-th router logits lie within such a step of
each other can take another expert, which moves its output by far more
than 2e-2.  The tests record every dispatch's top-k ids in both packages
(a wrapper of each package's ``moe_ffn``, ``jax.debug.callback`` inside
JAX's scans), require every token routed otherwise to be such a near-tie
in the port (logit gap under ``TIE``), and compare every output that no
such token reaches: a token routed otherwise at position t of a sequence
can move every later position of it through attention, so those are left
out.  In float32 no token may route otherwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.models import transformer as TT
from repro_torch.models.moe import top_k_desc
from _torch_threads import _one_torch_thread  # noqa: F401

LM_ARCHS = ["phi3-mini-3.8b", "granite-3-2b", "gemma3-12b",
            "qwen3-moe-30b-a3b", "mixtral-8x22b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TIE = 1 / 32            # router logit gap within a few bfloat16 steps
# the published sizes, by the JAX package's param_count
PARAMS = {"phi3-mini-3.8b": (3_821_079_552, 3_821_079_552),
          "granite-3-2b": (2_533_531_648, 2_533_531_648),
          "gemma3-12b": (11_623_837_440, 11_623_837_440),
          "qwen3-moe-30b-a3b": (29_767_960_576, 2_588_870_656),
          "mixtral-8x22b": (140_630_071_296, 39_161_468_928)}


def configs(arch, dtype="bfloat16", **kw):
    jdt, tdt = DTYPES[dtype]
    j = dataclasses.replace(jconfigs.get_arch(arch).reduced(), dtype=jdt,
                            **kw)
    t = dataclasses.replace(tconfigs.get_arch(arch).reduced(), dtype=tdt,
                            **kw)
    return j, t


def models(arch, dtype="bfloat16", seed=0, **kw):
    jcfg, tcfg = configs(arch, dtype, **kw)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tm = interop.lm_model_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                     "cpu")
    return jp, jcfg, tm, tcfg


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


class Routes:
    """Every MoE dispatch's top-k ids, in call order, in both packages, and
    the port's router logit gap between the K-th and (K+1)-th expert."""

    def __init__(self, mp):
        self.jax, self.port, self.gap = [], [], []
        j_orig, t_orig = JT.moe_ffn, TT.moe_ffn

        def jwrap(x, lp, moe):
            lg = (x @ lp["router"].astype(x.dtype)).astype(jnp.float32)
            ids = jax.lax.top_k(jax.nn.softmax(lg, axis=-1), moe.top_k)[1]
            jax.debug.callback(lambda i: self.jax.append(np.asarray(i)),
                               ids, ordered=True)
            return j_orig(x, lp, moe)

        def twrap(x, lp, moe):
            lg = (x @ lp["router"].to(x.dtype)).to(torch.float32)
            _, ids = top_k_desc(torch.softmax(lg, -1), moe.top_k)
            top = torch.sort(lg, -1, descending=True).values
            self.port.append(ids.numpy())
            self.gap.append((top[:, moe.top_k - 1]
                             - top[:, moe.top_k]).numpy())
            return t_orig(x, lp, moe)

        mp.setattr(JT, "moe_ffn", jwrap)
        mp.setattr(TT, "moe_ffn", twrap)

    def take(self, B, S):
        """(tokens (B, S) routed otherwise at any layer of the calls since
        the last take, their largest port gap); resets."""
        jax.effects_barrier()
        assert len(self.jax) == len(self.port)
        other = np.zeros(B * S, bool)
        worst = 0.0
        for j, t, g in zip(self.jax, self.port, self.gap):
            diff = (np.sort(j, -1) != np.sort(t, -1)).any(-1)
            other |= diff
            if diff.any():
                worst = max(worst, float(g[diff].max()))
        self.jax, self.port, self.gap = [], [], []
        return other.reshape(B, S), worst


@pytest.fixture
def routes():
    with pytest.MonkeyPatch.context() as mp:
        yield Routes(mp)


def _jax_serving(dtype):
    """JAX's prefill and decode step.  bfloat16: op by op, as the JAX
    package's tests call them, so that every op rounds its output to
    bfloat16 as the port's ops do (under jit XLA keeps fused intermediates
    in float32, and a rope of two terms near 2 that cancel then parts by
    two bfloat16 steps of the terms).  float32: jitted afresh (one compile
    in place of one an op; a trace is taken under whatever ``moe_ffn`` the
    test has in place)."""
    if dtype == "bfloat16":
        return (lambda p, t, cfg, n: JT.serve_prefill(p, t, cfg, max_len=n),
                JT.serve_decode_step)
    return (jax.jit(JT.serve_prefill, static_argnums=(2, 3)),
            jax.jit(JT.serve_decode_step, static_argnums=(3,)))


def _reached(flips: np.ndarray) -> np.ndarray:
    """Positions a token routed otherwise can reach: itself and every later
    position of its sequence."""
    return np.cumsum(flips, axis=1) > 0


def _close(got, want, dtype, keep=None, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if keep is not None:
        got, want = got[keep], want[keep]
    np.testing.assert_allclose(got, want, err_msg=what, **TOL[dtype])


def _check_routes(other, worst, dtype):
    if dtype == "float32":
        assert not other.any(), "a float32 token routed otherwise"
    else:
        assert worst < TIE, f"a token routed otherwise at gap {worst}"


def _slot_positions(cfg, i, cl, pos):
    """The position each cache slot of layer i holds after ``pos`` tokens,
    -1 where none was written."""
    if cfg.layer_window(i) is None:
        return np.where(np.arange(cl) < pos, np.arange(cl), -1)
    return TT._ring_slot_positions(cl, pos).numpy()


# --------------------------------------------------------------------------
# parameters and configs
# --------------------------------------------------------------------------
def _shapes(tree):
    return {k: ({n: tuple(a.shape) for n, a in v.items()}
                if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_parameter_tree_equals_jax(arch):
    jcfg, tcfg = configs(arch)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tm = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = _shapes(jp)
    assert _shapes(tm.params()) == want
    assert _shapes(TT.abstract_params(tcfg)) == want
    names = {n for n, _ in tm.named_parameters()}
    assert names == {f"layers.{k}" for k in jp["layers"]} | \
        {k for k in jp if k != "layers"}
    assert all(not p.requires_grad and p.dtype == torch.float32
               for p in tm.parameters())
    assert all(a.device.type == "meta" for v in
               TT.abstract_params(tcfg)["layers"].values() for a in [v])
    # norms at zero, embeddings at 0.02 x a normal truncated to [-2, 2]
    p = tm.params()
    assert float(p["final_norm"].abs().max()) == 0.0
    assert 0.02 < float(p["embed"].abs().max()) <= 0.04


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_counts_of_the_published_configs(arch):
    t = tconfigs.get_arch(arch).model
    j = jconfigs.get_arch(arch).model
    assert (t.param_count, t.active_param_count) == PARAMS[arch]
    assert t.param_count == j.param_count
    assert t.active_param_count == j.active_param_count
    assert t.head_dim == j.head_dim
    assert (t.is_global_layer() == j.is_global_layer()).all()
    assert [t.layer_window(i) for i in range(t.n_layers)] == \
        [j.layer_window(i) for i in range(j.n_layers)]


def test_qwen3_cut_to_16_layers_holds_40_gb():
    cfg = dataclasses.replace(tconfigs.get_arch("qwen3-moe-30b-a3b").model,
                              n_layers=16)
    assert cfg.param_count == 10_130_098_176


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_cross_over_one_to_one(arch):
    j, t = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    for a, b in ((j.model, t.model), (j.reduced(), t.reduced())):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.pop("dtype") == jnp.bfloat16 and db.pop("dtype") == \
            torch.bfloat16
        assert da == db
    assert [c.name for c in t.shapes] == [c.name for c in j.shapes]
    assert [c.dims for c in t.shapes] == [c.dims for c in j.shapes]
    assert t.skip == j.skip and t.notes == j.notes and t.family == "lm"


def test_registry_and_cells():
    assert tconfigs.list_archs() == sorted(set(jconfigs.list_archs())
                                           - {"egnn"})
    assert tconfigs.all_cells() == [c for c in jconfigs.all_cells()
                                    if c[0] != "egnn"]
    assert len(tconfigs.all_cells()) == 36


def test_abstract_cache_equals_init_cache_shapes():
    _, tcfg = configs("gemma3-12b")
    a = TT.abstract_cache(tcfg, 2, 20)
    c = TT.init_cache(tcfg, 2, 20, "cpu")
    assert [t.shape for t in a["k"]] == [t.shape for t in c["k"]] == \
        [(2, 8, 2, 16), (2, 20, 2, 16)]
    assert a["pos"].dtype == torch.int32 and c["pos"] == 0
    assert all(t.device.type == "meta" for t in a["v"])


# --------------------------------------------------------------------------
# forward, prefill, decode, embeddings against JAX
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_train_matches_jax(arch, dtype, routes):
    jp, jcfg, tm, _ = models(arch, dtype)
    toks = tokens(jcfg, 2, 40)            # past q_chunk=32: two chunks
    jl, jaux = JT.forward_train(jp, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        tl, taux = TT.forward_train(tm, torch.tensor(toks))
    assert tl.dtype == torch.float32 and tl.shape == (2, 40, jcfg.vocab)
    other, worst = routes.take(2, 40)
    _check_routes(other, worst, dtype)
    keep = ~_reached(other)
    _close(tl, jl, dtype, keep, "logits")
    if not other.any():
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype, routes):
    """serve_prefill of 12 tokens into a cache of 20, then 4 decode steps:
    the logits, every layer's k and v (ring slots included) and pos."""
    jp, jcfg, tm, tcfg = models(arch, dtype, seed=1)
    toks = tokens(jcfg, 2, 16, seed=1)
    prefill, decode = _jax_serving(dtype)
    jl, jc = prefill(jp, jnp.asarray(toks[:, :12]), jcfg, 20)
    tl, tc = TT.serve_prefill(tm, torch.tensor(toks[:, :12]), max_len=20)
    assert tc["pos"] == 12 == int(jc["pos"])
    other, worst = routes.take(2, 12)
    flips = [other]
    _close(tl, jl, dtype, ~_reached(other)[:, -1], "prefill logits")
    for t in range(12, 16):
        jl, jc = decode(jp, jc, jnp.asarray(toks[:, t:t + 1]), jcfg)
        tl, tc = TT.serve_decode_step(tm, tc, torch.tensor(toks[:, t:t + 1]))
        other, w = routes.take(2, 1)
        worst = max(worst, w)
        flips.append(other)
        reach = _reached(np.concatenate(flips, axis=1))
        _close(tl, jl, dtype, ~reach[:, -1], f"decode logits at {t}")
    _check_routes(np.concatenate(flips, axis=1), worst, dtype)
    reach = _reached(np.concatenate(flips, axis=1))
    got = interop.lm_cache_to_numpy(tc)
    assert got["pos"] == jc["pos"] and got["pos"].dtype == np.int32
    for i in range(tcfg.n_layers):
        cl = got["k"][i].shape[1]
        assert cl == jc["k"][i].shape[1]
        pos = _slot_positions(tcfg, i, cl, 16)
        keep = ~reach[:, np.clip(pos, 0, None)] | (pos < 0)[None]
        for kv in ("k", "v"):
            _close(got[kv][i], jc[kv][i], dtype, keep, f"{kv}[{i}]")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_embed_sequences_matches_jax(arch, dtype, routes):
    jp, jcfg, tm, _ = models(arch, dtype, seed=2)
    toks = tokens(jcfg, 3, 10, seed=2)
    want = JT.embed_sequences(jp, jnp.asarray(toks), jcfg)
    got = TT.embed_sequences(tm, torch.tensor(toks))
    assert got.dtype == torch.float32 and got.shape == (3, jcfg.d_model)
    other, worst = routes.take(3, 10)
    _check_routes(other, worst, dtype)
    _close(got, want, dtype, ~other.any(1), "embeddings")


@pytest.mark.parametrize("arch", ["gemma3-12b", "mixtral-8x22b"])
def test_decode_from_a_jax_cache(arch):
    """interop: a JAX prefill's cache carried into the port, decoded there,
    equals JAX's decode (float32)."""
    jp, jcfg, tm, tcfg = models(arch, "float32", seed=3)
    toks = tokens(jcfg, 2, 14, seed=3)
    prefill, decode = _jax_serving("float32")
    _, jc = prefill(jp, jnp.asarray(toks[:, :11]), jcfg, 20)
    tc = interop.lm_cache_from_numpy(jax.tree.map(np.asarray, jc),
                                     tcfg.dtype, "cpu")
    assert tc["pos"] == 11 and isinstance(tc["pos"], int)
    for t in range(11, 14):
        jl, jc = decode(jp, jc, jnp.asarray(toks[:, t:t + 1]), jcfg)
        tl, tc = TT.serve_decode_step(tm, tc, torch.tensor(toks[:, t:t + 1]))
        _close(tl, jl, "float32")


def test_prefill_longer_than_max_len_keeps_the_first_positions():
    """A global layer keeps positions [0, max_len) of a longer prompt; a
    windowed one its last slots (JAX's dynamic_update_slice and ring)."""
    jp, jcfg, tm, _ = models("gemma3-12b", "float32", seed=4)
    toks = tokens(jcfg, 1, 12, seed=4)
    _, jc = JT.serve_prefill(jp, jnp.asarray(toks), jcfg, max_len=6)
    _, tc = TT.serve_prefill(tm, torch.tensor(toks), max_len=6)
    got = interop.lm_cache_to_numpy(tc)
    for i in range(2):
        _close(got["k"][i], jc["k"][i], "float32")
        _close(got["v"][i], jc["v"][i], "float32")


def test_lm_sliding_window_ring_cache():
    """Decode far beyond the window: the ring cache stays consistent with
    a full-cache run restricted by the window mask (the port's twin of the
    JAX test)."""
    spec = tconfigs.get_arch("mixtral-8x22b")
    cfg = spec.reduced()          # window 8
    assert cfg.sliding_window == 8
    model = TT.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    rng = np.random.default_rng(3)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (1, 20)).astype(np.int32))
    with torch.no_grad():
        ref_logits, _ = TT.forward_train(model, toks)
    _, cache = TT.serve_prefill(model, toks[:, :8], max_len=20)
    assert cache["k"][0].shape[1] == 8
    outs = []
    for t in range(8, 20):
        lg, cache = TT.serve_decode_step(model, cache, toks[:, t:t + 1])
        outs.append(lg)
    got = torch.stack(outs, dim=1)[0]
    torch.testing.assert_close(got, ref_logits[0, 8:], rtol=3e-2, atol=3e-2)


def test_ring_slot_positions_match_jax():
    for cl in (1, 4, 8):
        for nxt in (0, 1, 3, 8, 9, 21):
            np.testing.assert_array_equal(
                TT._ring_slot_positions(cl, nxt).numpy(),
                np.asarray(JT._ring_slot_positions(cl, jnp.int32(nxt))))


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "gemma3-12b"])
def test_decode_past_max_len_raises(arch):
    """Kept difference: JAX's dynamic_update_slice clamps the slot of a
    global layer past the cache into its last slot and overwrites it; the
    port raises before it writes anything."""
    _, _, tm, tcfg = models(arch, "float32")
    toks = torch.tensor(tokens(tcfg, 1, 6))
    _, cache = TT.serve_prefill(tm, toks[:, :4], max_len=5)
    _, cache = TT.serve_decode_step(tm, cache, toks[:, 4:5])
    before = [t.clone() for t in cache["k"]]
    with pytest.raises(ValueError, match="position 5 past the 5-slot"):
        TT.serve_decode_step(tm, cache, toks[:, 5:6])
    assert cache["pos"] == 5
    assert all(torch.equal(a, b) for a, b in zip(before, cache["k"]))


def test_windowed_only_config_decodes_past_max_len():
    """Mixtral's layers are all windowed: the ring wraps, nothing raises."""
    _, _, tm, _ = models("mixtral-8x22b", "float32")
    toks = torch.tensor(tokens(tm.cfg, 1, 10))
    _, cache = TT.serve_prefill(tm, toks[:, :4], max_len=5)
    for t in range(4, 10):
        lg, cache = TT.serve_decode_step(tm, cache, toks[:, t:t + 1])
    assert cache["pos"] == 10 and bool(torch.isfinite(lg).all())


def test_serving_runs_without_autograd():
    _, _, tm, _ = models("qwen3-moe-30b-a3b", "float32")
    toks = torch.tensor(tokens(tm.cfg, 1, 5))
    lg, cache = TT.serve_prefill(tm, toks)
    assert lg.is_inference() and cache["k"][0].is_inference()
    assert not TT.embed_sequences(tm, toks).requires_grad
