"""The port's brute-force scan, its ``l2_topk`` plain version and the
paper's baseline graphs (k-NN graph by NN-descent, NSW, random even-regular)
held against the JAX package on the same seeded inputs.  On the CPU the
``l2_topk`` wrapper takes its plain version; the JAX kernel runs in
interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.baselines import BruteForceIndex as JBruteForce
from repro.core.baselines import NSWIndex as JNSW
from repro.core.baselines import build_knng as j_build_knng
from repro.core.baselines import nn_descent as j_nn_descent
from repro.core.baselines import random_regular_graph as j_rr_graph
from repro.core.baselines import random_regular_index as j_rr_index
from repro.core.build import DEGParams as JDEGParams
from repro.core.search import search_graph as j_search_graph
from repro.kernels.l2_topk import l2_topk as j_l2_topk
from repro.kernels.l2_topk import l2_topk_ref as j_l2_topk_ref
from repro_torch.core.baselines import (BruteForceIndex, NSWIndex, build_knng,
                                        nn_descent, random_regular_graph,
                                        random_regular_index)
from repro_torch.core.build import DEGParams
from repro_torch.core.invariants import check_table1
from repro_torch.core.search import search_graph
from repro_torch.interop import graph_to_numpy, result_to_numpy
from repro_torch.kernels.l2_topk import l2_topk, l2_topk_ref
from _torch_threads import _one_torch_thread  # noqa: F401


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------- l2_topk --
@pytest.mark.parametrize("B,N,m,k", [
    (8, 512, 128, 10),
    (3, 1000, 33, 5),      # unaligned everything
    (16, 2048, 128, 100),  # paper-style k=100
    (1, 513, 960, 1),
])
def test_l2_topk_matches_jax(B, N, m, k):
    """The JAX kernel's own shapes and tolerances: distances at rtol and
    atol 1e-5; ids through their true distances at 1e-4 (an id may differ
    on a tie)."""
    rng = np.random.default_rng(B * 1000 + N)
    q, x = _rand(rng, (B, m)), _rand(rng, (N, m))
    d, i = l2_topk(_t(q), _t(x), k)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert tuple(d.shape) == tuple(i.shape) == (B, k)
    kd, _ = j_l2_topk(jnp.asarray(q), jnp.asarray(x), k, interpret=True)
    rd, _ = j_l2_topk_ref(jnp.asarray(q), jnp.asarray(x), k)
    for want in (kd, rd):
        np.testing.assert_allclose(d.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    full = np.linalg.norm(q[:, None] - x[None], axis=2)
    got = np.take_along_axis(full, i.numpy().astype(np.int64), axis=1)
    np.testing.assert_allclose(got, np.asarray(rd), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_topk_dtypes(dtype):
    """bf16 inputs are cast to float32 in both packages, so the port's
    distances meet the JAX kernel's at its bf16 tolerance (3e-2) and the
    JAX plain version's at 1e-5 (the same bf16 values go in)."""
    rng = np.random.default_rng(0)
    q, x = _rand(rng, (4, 64)), _rand(rng, (256, 64))
    jq = jnp.asarray(q, dtype=getattr(jnp, dtype))
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tq = _t(q).to(getattr(torch, dtype))
    tx = _t(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(tq.to(torch.float32).numpy(),
                                  np.asarray(jq.astype(jnp.float32)))
    d, i = l2_topk(tq, tx, 8)
    kd, _ = j_l2_topk(jq, jx, 8, interpret=True)
    rd, ri = j_l2_topk_ref(jq, jx, 8)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(d.numpy(), np.asarray(kd), rtol=tol, atol=tol)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_l2_topk_squared_mode():
    rng = np.random.default_rng(1)
    q, x = _rand(rng, (4, 32)), _rand(rng, (128, 32))
    d2, i2 = l2_topk(_t(q), _t(x), 4, squared=True)
    d, i = l2_topk(_t(q), _t(x), 4)
    np.testing.assert_allclose(d2.numpy(), d.numpy() ** 2, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(i2.numpy(), i.numpy())
    jd2, _ = j_l2_topk(jnp.asarray(q), jnp.asarray(x), 4, squared=True,
                       interpret=True)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B", [2, 3])
def test_l2_topk_padding_never_leaks(B):
    """130 rows: the JAX wrapper pads them to 256 with rows of 1e19; no
    padded or out-of-range row may come back from either package."""
    rng = np.random.default_rng(2)
    q, x = _rand(rng, (B, 16)), _rand(rng, (130, 16))
    _, i = l2_topk(_t(q), _t(x), 50)
    _, ji = j_l2_topk(jnp.asarray(q), jnp.asarray(x), 50, interpret=True)
    for ids in (i.numpy(), np.asarray(ji)):
        assert (ids >= 0).all() and (ids < 130).all()
        assert all(len(set(row)) == 50 for row in ids.tolist())


def test_l2_topk_k_above_n_raises():
    x = np.zeros((5, 4), np.float32)
    with pytest.raises(ValueError):
        j_l2_topk(jnp.asarray(x[:1]), jnp.asarray(x), 6, interpret=True)
    with pytest.raises(ValueError):
        l2_topk(_t(x[:1]), _t(x), 6)
    with pytest.raises(ValueError):
        l2_topk(_t(x[:1]), _t(x), 2, impl="cuda")


def test_l2_topk_ties_go_to_the_lower_id():
    """Every base row three times over: each distance is a three-way tie,
    which ``lax.top_k`` and the port both break towards the lower id."""
    rng = np.random.default_rng(3)
    x = np.repeat(_rand(rng, (40, 8)), 3, axis=0)
    q = x[::7] + 0.01
    d, i = l2_topk(_t(q), _t(x), 9)
    rd, ri = j_l2_topk_ref(jnp.asarray(q), jnp.asarray(x), 9)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5)
    assert (np.diff(i.numpy().reshape(len(q), 3, 3), axis=2) == 1).all()


def test_l2_topk_ref_is_the_plain_version():
    rng = np.random.default_rng(4)
    q, x = _t(_rand(rng, (5, 12))), _t(_rand(rng, (60, 12)))
    for a, b in zip(l2_topk(q, x, 7), l2_topk_ref(q, x, 7)):
        assert torch.equal(a, b)
    for a, b in zip(l2_topk(q, x, 7, impl="ref"), l2_topk_ref(q, x, 7)):
        assert torch.equal(a, b)


# --------------------------------------------------------- brute force --
@pytest.mark.parametrize("metric", ["l2", "sqeuclidean", "ip", "cos"])
@pytest.mark.parametrize("tile", [8192, 64])
@pytest.mark.parametrize("backend", [("jnp", "torch"), ("pallas", "kernel")])
def test_brute_force_matches_jax(metric, tile, backend):
    """``backend="pallas"|"kernel"`` is the fused kernel for l2 and the
    plain path for any other metric, in both packages.  ``tile=64``
    takes the tiled path of ``exact_knn_batched``."""
    rng = np.random.default_rng(5)
    base, q = _rand(rng, (300, 12)), _rand(rng, (17, 12))
    jb, tb = backend
    want_d, want_i = JBruteForce(base, metric).search(q, 10, tile=tile,
                                                      backend=jb)
    got_d, got_i = BruteForceIndex(base, metric, device="cpu").search(
        q, 10, tile=tile, backend=tb)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_d, np.asarray(want_d), rtol=1e-5,
                               atol=1e-5)
    assert BruteForceIndex(base, metric, device="cpu").n == 300


def test_brute_force_unknown_backend_raises():
    bf = BruteForceIndex(np.zeros((4, 2), np.float32), device="cpu")
    with pytest.raises(ValueError):
        bf.search(np.zeros((1, 2), np.float32), 1, backend="pallas")


# ------------------------------------------------------ random regular --
@pytest.mark.parametrize("n,degree", [(40, 4), (120, 8), (300, 12)])
def test_random_regular_graph_matches_jax(n, degree):
    rng = np.random.default_rng(6)
    vecs = _rand(rng, (n, 8))
    want = j_rr_graph(n, degree, np.random.default_rng(n), vecs)
    got = random_regular_graph(n, degree, np.random.default_rng(n), vecs,
                               device="cpu")
    assert got.n == want.n == n
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-6)
    assert all(check_table1(got).values())


def test_random_regular_graph_without_vectors_and_bad_degree():
    got = random_regular_graph(30, 6, np.random.default_rng(0), device="cpu")
    want = j_rr_graph(30, 6, np.random.default_rng(0))
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    assert (got.weights == 0).all()
    for n, d in ((30, 5), (30, 2), (7, 6)):
        with pytest.raises(ValueError):
            random_regular_graph(n, d, np.random.default_rng(0), device="cpu")


def test_random_regular_index_matches_jax():
    rng = np.random.default_rng(7)
    vecs = _rand(rng, (200, 8))
    kw = dict(degree=8, k_ext=16)
    want = j_rr_index(vecs, JDEGParams(**kw), seed=3)
    got = random_regular_index(vecs, DEGParams(**kw), seed=3, device="cpu")
    assert got.n == want.n == 200
    np.testing.assert_array_equal(got.builder.adjacency,
                                  want.builder.adjacency)
    np.testing.assert_allclose(got.builder.weights, want.builder.weights,
                               rtol=1e-6)
    np.testing.assert_array_equal(got.vectors, want.vectors)
    q = vecs[:12] + 0.05
    r_want = want.search(q, k=5, eps=0.1)
    r_got = result_to_numpy(got.search(q, k=5, eps=0.1))
    np.testing.assert_array_equal(r_got["ids"], np.asarray(r_want.ids))
    np.testing.assert_array_equal(r_got["hops"], np.asarray(r_want.hops))


# ---------------------------------------------------------- NN-descent --
@pytest.mark.parametrize("n,K,iterations", [(300, 10, 4), (150, 6, 8)])
def test_nn_descent_matches_jax(n, K, iterations):
    """Same seed, same host loops: the same lists.  The candidate distances
    come from each package's ``pair`` form; on these inputs no ulp between
    them reorders a near-tie, so ids compare exactly."""
    rng = np.random.default_rng(8)
    vecs = _rand(rng, (n, 8))
    want_i, want_d = j_nn_descent(vecs, K, iterations, seed=1)
    got_i, got_d = nn_descent(vecs, K, iterations, seed=1, device="cpu")
    assert got_i.dtype == np.int32 and got_i.shape == (n, K)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-6)


def test_build_knng_searches_like_jax():
    rng = np.random.default_rng(9)
    vecs = _rand(rng, (300, 8))
    q = _rand(rng, (20, 8))
    want = j_build_knng(vecs, K=10, iterations=4, seed=0)
    got = build_knng(vecs, K=10, iterations=4, seed=0, device="cpu")
    g = graph_to_numpy(got)
    assert g["n"] == int(want.n) == 300
    np.testing.assert_array_equal(g["adjacency"], np.asarray(want.adjacency))
    np.testing.assert_allclose(g["weights"], np.asarray(want.weights),
                               rtol=1e-6)
    r_want = j_search_graph(want, jnp.asarray(vecs), jnp.asarray(q), k=5,
                            eps=0.1, seed=0)
    r_got = result_to_numpy(search_graph(got, _t(vecs), _t(q), k=5, eps=0.1,
                                         seed=0))
    for key in ("ids", "hops", "evals"):
        np.testing.assert_array_equal(r_got[key], np.asarray(getattr(r_want,
                                                                     key)))
    np.testing.assert_allclose(r_got["dists"], np.asarray(r_want.dists),
                               rtol=1e-5)


# ------------------------------------------------------------------ NSW --
@pytest.fixture(scope="module")
def nsw_pair():
    rng = np.random.default_rng(10)
    vecs = _rand(rng, (150, 8))
    kw = dict(f=5, max_degree=16, capacity=160)
    want = JNSW(8, **kw)
    want.add(vecs)
    got = NSWIndex(8, device="cpu", **kw)
    got.add(vecs)
    return want, got, vecs


def test_nsw_matches_jax(nsw_pair):
    want, got, _ = nsw_pair
    assert got.n == want.n == 150
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-6)
    np.testing.assert_array_equal(got.vectors, want.vectors)
    # not regular: free slots stay INVALID, and some vertex is full
    degs = (got.adjacency[:150] != -1).sum(axis=1)
    assert degs.min() < degs.max() == 16


@pytest.mark.parametrize("eps", [0.0, 0.1, 0.3])
def test_nsw_search_matches_jax(nsw_pair, eps):
    want, got, vecs = nsw_pair
    q = vecs[::10] + 0.05 * _rand(np.random.default_rng(11), (15, 8))
    r_want = want.search(q, k=5, eps=eps)
    r_got = result_to_numpy(got.search(q, k=5, eps=eps))
    for key in ("ids", "hops", "evals"):
        np.testing.assert_array_equal(r_got[key], np.asarray(getattr(r_want,
                                                                     key)))
    np.testing.assert_allclose(r_got["dists"], np.asarray(r_want.dists),
                               rtol=1e-5)
    g = graph_to_numpy(got.frozen())
    assert g["n"] == 150 and g["adjacency"].shape == (160, 16)


def test_nsw_capacity_exhausted():
    nsw = NSWIndex(4, f=2, max_degree=4, capacity=3, device="cpu")
    with pytest.raises(RuntimeError):
        nsw.add(np.zeros((4, 4), np.float32))
