"""The paper's graph quality (Eq. 3), the hop histogram and
``Metric.one_to_many`` in the port against the JAX package's, on a built
index and on the two-cluster case of ``tests/test_core_metrics.py``
(paper Fig. 1: a beneficial swap that GQ does not see)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro.core.distances import get_metric as j_get_metric
from repro.core.graph import GraphBuilder as JGraphBuilder
from repro.core.metrics import graph_quality as j_graph_quality
from repro.core.metrics import hop_histogram as j_hop_histogram
from repro_torch.core.distances import get_metric
from repro_torch.core.graph import GraphBuilder
from repro_torch.core.metrics import (average_neighbor_distance,
                                      graph_quality, hop_histogram)
from repro_torch.interop import index_from_numpy
from _torch_threads import _one_torch_thread  # noqa: F401

PTS = np.array([[0, 0], [0, 1], [1, 0], [1, 1],          # cluster A
                [10, 0], [10, 1], [11, 0], [11, 1]],     # cluster B
               dtype=np.float32)
INNER = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
         (0, 3), (4, 7)]


@pytest.fixture(scope="module")
def built():
    """A JAX-built index and the port's copy of it (same graph)."""
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(300, 8)).astype(np.float32)
    jidx = j_build_deg(vecs, JDEGParams(degree=8, k_ext=16), wave_size=8)
    idx = index_from_numpy(vecs, jidx.builder.adjacency, jidx.builder.weights,
                           jidx.n, {"degree": 8, "k_ext": 16}, device="cpu")
    return jidx, idx, vecs


@pytest.mark.parametrize("metric", ["l2", "sqeuclidean", "ip", "cos"])
def test_graph_quality_equals_jax_on_a_built_index(built, metric):
    jidx, idx, vecs = built
    got = graph_quality(idx.builder, vecs, metric)
    assert 0.0 < got <= 1.0
    assert got == pytest.approx(j_graph_quality(jidx.builder, vecs, metric),
                                rel=1e-12)


def _fig1(cls, **kw):
    """The crossed two-cluster graph of Fig. 1, then the swap to parallel
    long edges; GQ and Eq. 4 before and after."""
    b = cls(8, 4, **kw)
    for _ in range(8):
        b.add_vertex()

    def dist(u, v):
        return float(np.linalg.norm(PTS[u] - PTS[v]))

    for u, v in INNER + [(1, 6), (2, 5)]:
        b.add_edge(u, v, dist(u, v))
    before = graph_quality if cls is GraphBuilder else j_graph_quality
    gq0 = before(b, PTS)
    nd0 = b.average_neighbor_distance()
    b.remove_edge(1, 6)
    b.remove_edge(2, 5)
    b.add_edge(1, 5, dist(1, 5))
    b.add_edge(2, 6, dist(2, 6))
    return gq0, nd0, before(b, PTS), b.average_neighbor_distance(), b


def test_gq_insensitive_to_swap_but_and_sensitive():
    gq0, nd0, gq1, nd1, b = _fig1(GraphBuilder, device="cpu")
    assert nd1 < nd0                     # Eq. (4) detects the improvement
    assert gq1 == pytest.approx(gq0)     # GQ does not
    assert average_neighbor_distance(b) == pytest.approx(nd1)
    want = _fig1(JGraphBuilder)
    assert (gq0, gq1) == pytest.approx(want[0:3:2], rel=1e-12)
    assert (nd0, nd1) == pytest.approx(want[1:4:2], rel=1e-6)


def test_hop_histogram_equals_jax(built):
    _, idx, vecs = built
    q = np.random.default_rng(6).normal(size=(40, 8)).astype(np.float32)
    hops = idx.search(q, k=5).hops
    counts, edges = hop_histogram(hops, bins=8)
    want_counts, want_edges = j_hop_histogram(hops.numpy(), bins=8)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(edges, want_edges)
    assert counts.sum() == 40


@pytest.mark.parametrize("metric", ["l2", "sqeuclidean", "ip", "cos"])
def test_one_to_many_equals_jax(metric):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(12,)).astype(np.float32)
    xs = rng.normal(size=(50, 12)).astype(np.float32)
    got = get_metric(metric).one_to_many(torch.tensor(q), torch.tensor(xs))
    assert got.shape == (50,)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_get_metric(metric).one_to_many(q, xs)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        got.numpy(), get_metric(metric).pair(torch.tensor(q)[None, :],
                                             torch.tensor(xs)).numpy())
