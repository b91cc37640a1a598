"""The port's edge optimization (Alg. 4) and continuous refinement (Alg. 5)
replay the JAX package's on the same graphs."""
import dataclasses

import numpy as np
import pytest

from repro.core.baselines import random_regular_index
from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro.core.metrics import average_neighbor_distance as j_avg_nd
from repro.core.mrng import mrng_conform_mask as j_conform_mask
from repro.core.optimize import dynamic_edge_optimization as j_dyn_opt
from repro.core.optimize import optimize_edge as j_optimize_edge
from repro.core.optimize import refine_sweep as j_refine_sweep
from repro_torch.core.build import DEGParams, build_deg
from repro_torch.core.invariants import check_table1
from repro_torch.core.metrics import average_neighbor_distance
from repro_torch.core.mrng import mrng_conform_mask
from repro_torch.core.optimize import (dynamic_edge_optimization,
                                       optimize_edge, refine_sweep)
from repro_torch.interop import index_from_numpy
from _torch_threads import _one_torch_thread  # noqa: F401

N, DIM, DEGREE = 200, 16, 8


@pytest.fixture(scope="module")
def base():
    return np.random.default_rng(13).normal(size=(N, DIM)).astype(np.float32)


def _params():
    return JDEGParams(degree=DEGREE, k_ext=16, eps_ext=0.3, k_opt=8,
                      i_opt=3)


def _pair(base):
    """A fresh JAX random-regular index and its twin in the port."""
    jidx = random_regular_index(base, _params(), seed=2)
    b = jidx.builder
    tidx = index_from_numpy(base, b.adjacency, b.weights, b.n,
                            dataclasses.asdict(jidx.params), device="cpu")
    return jidx, tidx


def _assert_same_graph(jidx, tidx):
    np.testing.assert_array_equal(tidx.builder.adjacency,
                                  jidx.builder.adjacency)
    np.testing.assert_allclose(tidx.builder.weights, jidx.builder.weights,
                               rtol=1e-5, atol=1e-6)
    assert all(check_table1(tidx.builder).values())


@pytest.mark.parametrize("chunk", [16, 5])
def test_refine_sweep_replays_jax(base, chunk):
    jidx, tidx = _pair(base)
    nd0 = average_neighbor_distance(tidx.builder)
    assert nd0 == pytest.approx(j_avg_nd(jidx.builder), rel=1e-6)
    verts = list(range(40))
    want = j_refine_sweep(jidx, verts, i_opt=3, k_opt=8, eps_opt=0.001,
                          chunk=chunk)
    got = refine_sweep(tidx, verts, i_opt=3, k_opt=8, eps_opt=0.001,
                       chunk=chunk)
    assert got == want >= 1
    _assert_same_graph(jidx, tidx)
    nd1 = average_neighbor_distance(tidx.builder)
    assert nd1 < nd0
    assert nd1 == pytest.approx(j_avg_nd(jidx.builder), rel=1e-6)
    assert average_neighbor_distance(tidx.frozen()) == pytest.approx(nd1)


@pytest.mark.parametrize("seed", [0, 1])
def test_index_refine_replays_jax(base, seed):
    jidx, tidx = _pair(base)
    nd0 = average_neighbor_distance(tidx.builder)
    want = jidx.refine(24, seed=seed)
    got = tidx.refine(24, seed=seed)
    assert got == want >= 1
    _assert_same_graph(jidx, tidx)
    assert average_neighbor_distance(tidx.builder) < nd0


@pytest.mark.parametrize("vertex", [0, 17, 123])
def test_dynamic_edge_optimization_replays_jax(base, vertex):
    jidx, tidx = _pair(base)
    # the serial path reads the conformity of the vertex's edges on the host
    np.testing.assert_array_equal(mrng_conform_mask(tidx.builder, vertex),
                                  j_conform_mask(jidx.builder, vertex))
    want = j_dyn_opt(jidx, np.random.default_rng(0), i_opt=3, k_opt=8,
                     vertex=vertex)
    got = dynamic_edge_optimization(tidx, np.random.default_rng(0), i_opt=3,
                                    k_opt=8, vertex=vertex)
    assert got == want
    _assert_same_graph(jidx, tidx)


def test_optimize_edge_keeps_or_reverts_like_jax(base):
    """Alg. 4 on single edges: an improving attempt is kept, a failed one
    leaves the graph exactly as it was, on both sides."""
    jidx, tidx = _pair(base)
    results = []
    for v1 in (3, 40, 99, 150):
        v2 = int(tidx.builder.neighbors(v1)[0])
        before = tidx.builder.adjacency.copy()
        want = j_optimize_edge(jidx, v1, v2, i_opt=3, k_opt=8)
        got = optimize_edge(tidx, v1, v2, i_opt=3, k_opt=8)
        assert got == want
        if not got:
            np.testing.assert_array_equal(tidx.builder.adjacency, before)
        results.append(got)
        _assert_same_graph(jidx, tidx)
    assert not optimize_edge(tidx, 0, 0)          # not an edge: no attempt
    assert any(results)


def test_build_with_optimize_new_replays_jax(base):
    """Same edge set and weights per vertex.  Slots may differ: step (4a)
    scores the pairs (s2, n2) and (n2, s2) with equal gains in exact
    arithmetic, and a 1-ulp difference between the two packages' search
    distances can take the other one, which adds the same two edges in
    the other order."""
    kw = dict(degree=DEGREE, k_ext=16, eps_ext=0.3, k_opt=8, i_opt=3,
              optimize_new=True)
    jidx = j_build_deg(base[:72], JDEGParams(**kw), wave_size=32)
    tidx = build_deg(base[:72], DEGParams(**kw), wave_size=32, device="cpu")
    ja, ta = jidx.builder.adjacency, tidx.builder.adjacency
    jo, to = np.argsort(ja, axis=1), np.argsort(ta, axis=1)
    np.testing.assert_array_equal(np.take_along_axis(ta, to, 1),
                                  np.take_along_axis(ja, jo, 1))
    np.testing.assert_allclose(
        np.take_along_axis(tidx.builder.weights, to, 1),
        np.take_along_axis(jidx.builder.weights, jo, 1), rtol=1e-5, atol=1e-6)
    assert all(check_table1(tidx.builder).values())


def test_build_deg_refine_iterations(base):
    kw = dict(degree=DEGREE, k_ext=16, eps_ext=0.3, k_opt=8, i_opt=3)
    plain = build_deg(base, DEGParams(**kw), wave_size=64, device="cpu")
    refined = build_deg(base, DEGParams(**kw), wave_size=64,
                        refine_iterations=64, device="cpu")
    assert all(check_table1(refined.builder).values())
    assert (average_neighbor_distance(refined.builder)
            <= average_neighbor_distance(plain.builder))
    assert refined.refine(0) == 0
