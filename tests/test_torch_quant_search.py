"""The port's two-stage search over compressed stores against the JAX
package.

The JAX package builds the 200-point corpus of
``tests/test_differential_recall.py`` (once per module); its graph, its
vectors and each codec's store are carried across with ``interop``, so
both packages search the same graph over the same codes.  Ids, hops and
evals must be equal and distances agree at rtol 1e-6 (the frameworks sum
the squares in different orders).  The port's plain kernel versions run
here; the JAX package runs its jnp route (decode, then the metric).  At
this corpus's dim 8, pq has one 8-dim subspace, so the table sum of the
port and the decoded distance of the JAX package add the same 8 squares
and the pq search matches exactly too.

The pinned snapshot (``tests/data/index_snapshot_golden.npz``) gives the
sq8 golden: the port's own encode must give its codes bit for bit, and
its search the pinned ids exactly and distances at rtol 1e-6 (the pinned
distances are 1 ulp off under the installed jax, ROADMAP C2).
"""
import dataclasses
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro.core.search import exact_rerank as j_exact_rerank
from repro_torch.core.build import DEGParams, build_deg
from repro_torch.core.distances import exact_knn
from repro_torch.core.metrics import recall_at_k
from repro_torch.core.search import exact_rerank, range_search, search_graph
from repro_torch.interop import (index_from_numpy, result_to_numpy,
                                  store_from_numpy, store_to_numpy)
from repro_torch.kernels.fused_hop import ops as fh_ops
from repro_torch.persist import read_snapshot
from repro_torch.quant.store import make_store

INVALID = -1
K = 10
CODECS = ["fp16", "sq8", "pq"]
#: recall@10 floors of tests/test_differential_recall.py
FLOORS = {"float32": 0.95, "fp16": 0.95, "sq8": 0.92, "pq": 0.95}
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "index_snapshot_golden.npz")
HOP = {"composed": "jnp", "fused": "pallas"}


@pytest.fixture(scope="module")
def corpus():
    """The differential corpus, built by the JAX package and carried
    across with each codec's store."""
    rng = np.random.default_rng(42)
    base = rng.normal(size=(200, 8)).astype(np.float32)
    queries = rng.normal(size=(16, 8)).astype(np.float32)
    jidx = j_build_deg(base, JDEGParams(degree=8, k_ext=16), wave_size=8,
                       refine_iterations=50)
    b = jidx.builder
    tidx = index_from_numpy(jidx.vectors[: jidx.n], b.adjacency, b.weights,
                            b.n, dataclasses.asdict(jidx.params),
                            device="cpu")
    for codec in CODECS:
        js = jidx.store_for(codec)
        tidx._stores[codec] = store_from_numpy(js.data, js.scale, codec,
                                               js.codebooks, device="cpu")
    _, gt = exact_knn(queries, base, K, device="cpu")
    return jidx, tidx, base, queries, gt.numpy()


def _assert_same(got, want):
    got = result_to_numpy(got)
    np.testing.assert_array_equal(got["ids"], np.asarray(want.ids))
    np.testing.assert_array_equal(got["hops"], np.asarray(want.hops))
    np.testing.assert_array_equal(got["evals"], np.asarray(want.evals))
    np.testing.assert_allclose(got["dists"], np.asarray(want.dists),
                               rtol=1e-6)
    return got


@pytest.mark.parametrize("codec,E,hop", list(itertools.product(
    CODECS, [1, 2], ["composed", "fused"])))
def test_two_stage_search_matches_jax(corpus, codec, E, hop):
    jidx, tidx, _, queries, _ = corpus
    kw = dict(k=K, eps=0.2, quantized=codec, expand_width=E)
    want = jidx.search(queries, hop_backend=HOP[hop], **kw)
    got = tidx.search(queries, hop_backend=hop, **kw)
    _assert_same(got, want)
    assert tidx.medoid() == jidx.medoid()


@pytest.mark.parametrize("codec,E", list(itertools.product(CODECS, [1, 2])))
def test_two_stage_search_with_exclude_matches_jax(corpus, codec, E):
    """Exploration-style lanes: graph seeds, an exclude list, rerank 15."""
    jidx, tidx, base, _, _ = corpus
    rng = np.random.default_rng(E)
    sv = rng.integers(0, 200, 8).astype(np.int32)
    excl = np.concatenate([sv[:, None], rng.integers(0, 200, (8, 3))], 1)
    excl[0, 1:] = INVALID
    kw = dict(k=6, eps=0.15, quantized=codec, rerank_k=15, expand_width=E)
    want = jidx.search_batch(base[sv], sv[:, None], excl.astype(np.int32),
                             **kw)
    got = _assert_same(tidx.search_batch(base[sv], sv[:, None],
                                         excl.astype(np.int32), **kw), want)
    for lane in range(8):
        assert not set(excl[lane]) & set(got["ids"][lane].tolist())


@pytest.mark.parametrize("codec", CODECS)
def test_multi_e4_fused_over_a_compressed_store_runs_the_composed_hop(
        corpus, codec, monkeypatch):
    """The fused hop reads float32 rows, so over a compressed store the
    engine runs the composed hop with the same visited filter: the fused
    kernel must not be reached, and the results are the JAX package's."""
    jidx, tidx, _, queries, _ = corpus

    def refuse(*a, **kw):
        raise AssertionError("fused_hop reached over a compressed store")

    monkeypatch.setattr(fh_ops, "fused_hop", refuse)
    kw = dict(k=K, eps=0.1, quantized=codec, expand_width=4)
    want = jidx.search(queries, hop_backend="pallas", **kw)
    got = tidx.search(queries, hop_backend="fused", **kw)
    got = _assert_same(got, want)
    assert got["visited_frac"] is not None


@pytest.mark.parametrize("codec", CODECS)
def test_port_encoded_store_searches_like_jax(corpus, codec):
    """The port's own encode of the corpus gives the JAX store's codes, so
    its search is the JAX package's too."""
    jidx, tidx, base, queries, _ = corpus
    mine = make_store(torch.from_numpy(base), codec, n=200)
    theirs = jidx.store_for(codec)
    np.testing.assert_array_equal(store_to_numpy(mine)["data"],
                                  np.asarray(theirs.data))
    seeds = np.full((16, 1), jidx.medoid(), np.int32)
    got = range_search(tidx.frozen(), mine, torch.from_numpy(queries),
                       torch.from_numpy(seeds), k=K, eps=0.2, rerank_k=30,
                       exact_vectors=tidx._dev_vectors)
    want = jidx.search_batch(queries, seeds, k=K, eps=0.2, quantized=codec,
                             rerank_k=30)
    _assert_same(got, want)


@pytest.mark.parametrize("codec,E,hop", list(itertools.product(
    ["float32"] + CODECS, [1, 2], ["composed", "fused"])))
def test_recall_floor(corpus, codec, E, hop):
    """The floors of test_differential_recall.py, against the port's
    exact k-NN, with stores the port encodes itself."""
    _, tidx, _, queries, gt = corpus
    saved = dict(tidx._stores)
    tidx._stores.clear()
    try:
        res = tidx.search(queries, k=K, eps=0.2,
                          quantized=None if codec == "float32" else codec,
                          expand_width=E, hop_backend=hop)
    finally:
        tidx._stores.update(saved)
    rec = recall_at_k(res.ids.numpy(), gt)
    assert rec >= FLOORS[codec], f"recall@{K} {rec:.4f} for {codec} E={E}"


def test_exact_rerank_matches_jax(corpus):
    _, _, base, queries, _ = corpus
    rng = np.random.default_rng(3)
    cand = rng.integers(0, 200, size=(16, 12)).astype(np.int32)
    cand[:, -3:] = INVALID
    cand[0, :] = INVALID                     # a lane with no candidate
    got_i, got_d = exact_rerank(torch.from_numpy(base),
                                torch.from_numpy(queries),
                                torch.from_numpy(cand), k=5)
    want_i, want_d = j_exact_rerank(jnp.asarray(base), jnp.asarray(queries),
                                    jnp.asarray(cand), k=5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)
    assert (got_i[0] == INVALID).all() and torch.isinf(got_d[0]).all()


def test_search_graph_rerank(corpus):
    jidx, tidx, _, queries, _ = corpus
    store = tidx.store_for("sq8")
    got = search_graph(tidx.frozen(), store, torch.from_numpy(queries), k=K,
                       eps=0.2, seed=tidx.medoid(), rerank_k=40,
                       exact_vectors=tidx._dev_vectors)
    want = jidx.search(queries, k=K, eps=0.2, quantized="sq8", rerank_k=40)
    _assert_same(got, want)


def test_memory_stats_match_jax(corpus):
    jidx, tidx, _, _, _ = corpus
    assert tidx.memory_stats() == jidx.memory_stats()


# ------------------------------------------------------------- contracts ---
@pytest.fixture()
def small_index():
    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(100, 8)).astype(np.float32)
    return build_deg(vecs, DEGParams(degree=4, k_ext=8), wave_size=8,
                     device="cpu"), rng


def test_store_invalidated_on_insert(small_index):
    idx, rng = small_index
    s1 = idx.store_for("sq8")
    assert idx.store_for("sq8") is s1                 # cached
    new = (5.0 + rng.normal(size=(1, 8))).astype(np.float32)   # outlier
    idx.add(new)
    s2 = idx.store_for("sq8")
    assert s2 is not s1
    back = s2.decode(torch.tensor([[idx.n - 1]], dtype=torch.int32))[0, 0]
    np.testing.assert_allclose(back.numpy(), new[0],
                               atol=float(s2.scale.max()))
    idx.grow(4 * idx.capacity)
    assert idx.store_for("sq8") is not s2


def test_rerank_k_smaller_than_k_rejected(small_index):
    idx, _ = small_index
    q = torch.zeros((2, 8))
    seeds = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="rerank_k"):
        range_search(idx.frozen(), idx.store_for("sq8"), q, seeds, k=10,
                     rerank_k=5, exact_vectors=idx._dev_vectors)
    with pytest.raises(ValueError, match="exact_vectors"):
        range_search(idx.frozen(), idx.store_for("sq8"), q, seeds, k=10,
                     rerank_k=20)


def test_search_rejects_unknown_codec(small_index):
    idx, _ = small_index
    with pytest.raises(ValueError, match="unknown codec"):
        idx.search(np.zeros((1, 8), np.float32), k=5, quantized="int4")


def test_make_store_without_n_raises(small_index):
    idx, _ = small_index
    with pytest.raises(TypeError):
        make_store(idx._dev_vectors, "pq")


# ---------------------------------------------------------------- golden ---
@pytest.fixture(scope="module")
def golden():
    payload, sec = read_snapshot(GOLDEN)
    vectors = sec["vectors"]["data"]
    g = sec["graph"]
    idx = index_from_numpy(vectors, g["adjacency"], g["weights"],
                           payload["n"], payload["params"], device="cpu")
    return payload, sec, idx


def test_golden_sq8_codes_bit_exact(golden):
    payload, sec, idx = golden
    st = store_to_numpy(make_store(torch.from_numpy(sec["vectors"]["data"]),
                                   "sq8", n=payload["n"]))
    np.testing.assert_array_equal(st["data"], sec["store_sq8"]["data"])
    np.testing.assert_array_equal(st["scale"].view(np.uint32),
                                  sec["store_sq8"]["scale"].view(np.uint32))
    np.testing.assert_array_equal(store_to_numpy(idx.store_for("sq8"))["data"],
                                  sec["store_sq8"]["data"])


def test_golden_sq8_search(golden):
    payload, sec, idx = golden
    exp = sec["expected"]
    assert idx.medoid() == payload["medoid"]
    res = result_to_numpy(idx.search_batch(exp["queries"], k=10, eps=0.1,
                                           quantized="sq8"))
    np.testing.assert_array_equal(res["ids"], exp["sq8_ids"])
    np.testing.assert_allclose(res["dists"], exp["sq8_dists"], rtol=1e-6)
    # the exact path of the same fixture, for contrast
    res = result_to_numpy(idx.search_batch(exp["queries"], k=10, eps=0.1))
    np.testing.assert_array_equal(res["ids"], exp["exact_ids"])
    np.testing.assert_allclose(res["dists"], exp["exact_dists"], rtol=1e-6)
