"""The port's device construction path against the JAX package: the
mrng_occlusion kernel's plain version, the block-batched Alg. 3 selection,
the Alg. 5 conformity and swap scans, the edge-swap apply, and whole builds
with ``device_extend=True``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro.core.extend import extend_wave_device as j_extend_wave_device
from repro.core.extend import mrng_conform_batch as j_mrng_conform_batch
from repro.core.extend import propose_swaps as j_propose_swaps
from repro.kernels.mrng_occlusion import mrng_occlusion_ref as j_occlusion_ref
from repro_torch.core.build import DEGParams, build_deg
from repro_torch.core.extend import (extend_wave_device, mrng_conform_batch,
                                     propose_swaps)
from repro_torch.core.graph import INVALID, complete_graph
from repro_torch.core.invariants import check_table1
from repro_torch.core.mrng import mrng_conform_mask
from repro_torch.interop import graph_to_numpy, index_from_numpy
from repro_torch.kernels.mrng_occlusion import ops as occ_ops
from _torch_threads import _one_torch_thread  # noqa: F401

N, DIM, DEGREE = 400, 16, 8


def _t(x):
    return torch.tensor(np.asarray(x))


# ------------------------------------------------------ mrng_occlusion ------
def _occlusion_inputs(N, m, B, K, d, metric, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(N, m)).astype(np.float32)
    q = rng.normal(size=(B, m)).astype(np.float32)
    ids = rng.integers(0, N, size=(B, K, d)).astype(np.int32)
    # the typical distance between two rows, so about half the flags set
    scale = 2.0 * m if metric == "sqeuclidean" else np.sqrt(2.0 * m)
    cd = rng.uniform(0.5, 1.5, size=(B, K)).astype(np.float32) * scale
    w = rng.uniform(0.5, 1.5, size=(B, K, d)).astype(np.float32) * scale
    return v, ids, q, cd, w


@pytest.mark.parametrize("metric", ["l2", "sqeuclidean"])
@pytest.mark.parametrize("N,m,B,K,d", [
    (128, 128, 4, 8, 6),
    (100, 33, 2, 5, 4),      # unaligned feature dim
    (256, 48, 3, 16, 30),    # DEG degree 30
    (500, 192, 16, 40, 20),  # the audio build's extension block
])
def test_mrng_occlusion_matches_jax_ref(N, m, B, K, d, metric):
    v, ids, q, cd, w = _occlusion_inputs(N, m, B, K, d, metric, N + m)
    want_d, want_o = j_occlusion_ref(jnp.asarray(v), jnp.asarray(ids),
                                     jnp.asarray(q), jnp.asarray(cd),
                                     jnp.asarray(w), metric=metric)
    got_d, got_o = occ_ops.mrng_occlusion(_t(v), _t(ids), _t(q), _t(cd),
                                          _t(w), metric=metric)
    assert got_d.dtype == torch.float32 and got_o.dtype == torch.bool
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    assert 0 < int(got_o.sum()) < got_o.numel()


def test_mrng_occlusion_clamps_invalid_ids():
    """-1 (INVALID) and past-the-end ids read the clipped rows, as the JAX
    wrapper clips them before its kernel."""
    v, ids, q, cd, w = _occlusion_inputs(64, 24, 3, 5, 6, "l2", 3)
    ids[0, 0, :3] = [INVALID, 64, 70]
    ids[2, 4, :] = INVALID
    got_d, got_o = occ_ops.mrng_occlusion(_t(v), _t(ids), _t(q), _t(cd),
                                          _t(w))
    want_d, want_o = j_occlusion_ref(
        jnp.asarray(v), jnp.asarray(np.clip(ids, 0, 63)), jnp.asarray(q),
        jnp.asarray(cd), jnp.asarray(w))
    assert np.isfinite(got_d.numpy()).all()
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    ref_d, _ = occ_ops.mrng_occlusion(_t(v), _t(ids), _t(q), _t(cd), _t(w),
                                      impl="ref")
    assert torch.equal(ref_d, got_d)


# ----------------------------------------------------- shared JAX graph -----
@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    base = rng.normal(size=(N, DIM)).astype(np.float32)
    return base


@pytest.fixture(scope="module")
def jax_index(data):
    """A JAX device-extend build (400 x 16, degree 8, waves of 64)."""
    p = JDEGParams(degree=DEGREE, k_ext=16, eps_ext=0.2, k_opt=8)
    return j_build_deg(data, p, wave_size=64)


def _carry(jidx):
    b = jidx.builder
    return index_from_numpy(jidx.vectors[: jidx.n], b.adjacency, b.weights,
                            b.n, dataclasses.asdict(jidx.params),
                            device="cpu")


@pytest.fixture(scope="module")
def wave_operands(jax_index):
    """Snapshot operands of one extension block: 16 lanes that pretend to
    be vertices 300..315 with their candidate searches on the built graph;
    lane 3 has only 3 candidates and must fail."""
    jidx = jax_index
    W, start = 16, 300
    pts = jidx.vectors[start : start + W]
    res = jidx.search_batch(pts, np.full((W, 1), 5, np.int32), k=16, eps=0.2)
    ids = np.array(res.ids)
    dists = np.array(res.dists)
    ids[3, 3:] = INVALID
    dists[3, 3:] = np.inf
    g = jidx.builder.device_graph()
    return dict(adjacency=np.asarray(g.adjacency), weights=np.asarray(g.weights),
                vectors=np.asarray(jidx._dev_vectors), cand_ids=ids,
                cand_dists=dists, queries=pts,
                v_ids=np.arange(start, start + W, dtype=np.int32))


@pytest.mark.parametrize("rng_checks", [True, False])
@pytest.mark.parametrize("scheme", ["A", "B", "C", "D"])
def test_extend_wave_device_matches_jax(wave_operands, scheme, rng_checks):
    op = wave_operands
    names = ("adjacency", "weights", "vectors", "cand_ids", "cand_dists",
             "queries", "v_ids")
    want = j_extend_wave_device(*(jnp.asarray(op[k]) for k in names),
                                scheme=scheme, rng_checks=rng_checks)
    got = extend_wave_device(*(_t(op[k]) for k in names), scheme=scheme,
                             rng_checks=rng_checks)
    sel_ids, sel_d, ok = (x.numpy() for x in got)
    np.testing.assert_array_equal(sel_ids, np.asarray(want[0]))
    np.testing.assert_array_equal(ok, np.asarray(want[2]))
    np.testing.assert_allclose(sel_d, np.asarray(want[1]), rtol=1e-6)
    assert not ok[3] and ok.sum() == len(ok) - 1
    # every selected candidate b lies below its lane's vertex
    assert (sel_ids[ok][:, 0::2] < op["v_ids"][ok, None]).all()


def test_mrng_conform_batch_matches_jax(jax_index):
    tidx = _carry(jax_index)
    g = jax_index.builder.device_graph()
    vs = np.arange(0, N, 9, dtype=np.int32)
    want = np.asarray(j_mrng_conform_batch(g.adjacency, g.weights,
                                           jax_index._dev_vectors,
                                           jnp.asarray(vs)))
    tg = tidx.frozen()
    got = mrng_conform_batch(tg.adjacency, tg.weights, tidx._dev_vectors,
                             _t(vs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got.all()
    for i, v in enumerate(vs):
        np.testing.assert_array_equal(got[i], mrng_conform_mask(tidx.builder,
                                                                int(v)))


def test_propose_swaps_matches_jax(jax_index):
    tidx = _carry(jax_index)
    b = tidx.builder
    rng = np.random.default_rng(0)
    v1s = rng.integers(0, N, 24).astype(np.int32)
    v2s = np.asarray([b.neighbors(int(v))[int(rng.integers(0, DEGREE))]
                      for v in v1s], np.int32)
    gains = np.asarray([b.edge_weight(int(a), int(c))
                        for a, c in zip(v1s, v2s)], np.float32)
    ids, dists = tidx._search_from_batch(tidx.vectors[v2s], v1s[:, None],
                                         8, 0.001)
    g = jax_index.builder.device_graph()
    want = [np.asarray(x) for x in j_propose_swaps(
        g.adjacency, g.weights, jnp.asarray(ids), jnp.asarray(dists),
        jnp.asarray(v1s), jnp.asarray(v2s), jnp.asarray(gains))]
    tg = tidx.frozen()
    got = [x.numpy() for x in propose_swaps(
        tg.adjacency, tg.weights, _t(ids), _t(dists), _t(v1s), _t(v2s),
        _t(gains))]
    for name, gx, wx in zip(("s", "n", "ds", "best", "found"), got, want):
        np.testing.assert_array_equal(gx, wx, err_msg=name)
    assert 0 < got[4].sum() < len(v1s)


def test_replace_edges_skips_stale_claim():
    vecs = np.random.default_rng(2).normal(size=(6, 4)).astype(np.float32)
    b = complete_graph(vecs, 4, capacity=16, device="cpu")
    v = b.add_vertex()
    b.remove_edge(2, 3)          # makes the second claim stale
    ok = b.replace_edges(np.array([v, v]), np.array([0, 2]),
                         np.array([0, 2]), np.array([1, 3]),
                         np.array([0.5, 0.6], np.float32),
                         np.array([0.7, 0.8], np.float32))
    assert list(ok) == [True, False]
    assert b.has_edge(v, 0) and b.has_edge(v, 1) and not b.has_edge(0, 1)
    assert not b.has_edge(v, 2) and not b.has_edge(v, 3)
    assert b.edge_weight(v, 0) == pytest.approx(0.5)
    assert b.edge_weight(0, v) == pytest.approx(0.5)
    assert b.edge_weight(v, 1) == pytest.approx(0.7)
    assert list(b.neighbors(v)) == [0, 1] and b.vertex_degree(v) == 2
    np.testing.assert_allclose(b.neighbor_weights(v), [0.5, 0.7])
    g = b.device_graph()
    np.testing.assert_array_equal(g.adjacency.numpy(), b.adjacency)


# ------------------------------------------------------- whole builds -------
@pytest.mark.parametrize("extend_block", [16, 5])
def test_device_build_replays_jax(data, jax_index, extend_block):
    """A device-extend build (400 x 16, degree 8, waves of 64) replays the
    JAX build edge for edge."""
    kw = dict(degree=DEGREE, k_ext=16, eps_ext=0.2, k_opt=8,
              extend_block=extend_block)
    jidx = (jax_index if extend_block == 16
            else j_build_deg(data, JDEGParams(**kw), wave_size=64))
    tidx = build_deg(data, DEGParams(**kw), wave_size=64, device="cpu")
    got = graph_to_numpy(tidx.frozen())
    want = jidx.frozen()
    assert got["n"] == int(want.n) == N
    np.testing.assert_array_equal(got["adjacency"], np.asarray(want.adjacency))
    np.testing.assert_allclose(got["weights"], np.asarray(want.weights),
                               rtol=1e-5, atol=1e-6)
    assert all(check_table1(tidx.builder).values())
    assert tidx.build_stats["vertices"] == N - DEGREE - 1


@pytest.mark.parametrize("scheme", ["A", "B", "C", "D"])
def test_device_extend_equals_host_extend_at_wave_size_1(data, scheme):
    kw = dict(degree=DEGREE, k_ext=16, eps_ext=0.2, scheme=scheme)
    host = build_deg(data[:80], DEGParams(device_extend=False, **kw),
                     device="cpu")
    dev = build_deg(data[:80], DEGParams(**kw), device="cpu")
    np.testing.assert_array_equal(dev.builder.adjacency, host.builder.adjacency)
    np.testing.assert_allclose(dev.builder.weights, host.builder.weights,
                               rtol=1e-5, atol=1e-6)
    assert all(check_table1(dev.builder).values())


def test_build_deg_default_params(data):
    """``build_deg(vectors)`` with the default DEGParams (degree 20, the
    device extension in blocks of 16) builds a valid DEG."""
    assert DEGParams().device_extend and DEGParams().extend_block == 16
    idx = build_deg(data[:120], wave_size=32, device="cpu")
    assert idx.n == 120 and idx.builder.degree == 20
    assert all(check_table1(idx.builder).values())
