"""The port's range search against the golden fixture and against the JAX
engine on the same carried-across graph.

Golden cases a/b/c: ids, hops and evals exactly (hops and evals of b and c
asserted on their own, since the fixture's distances are 1 ulp off under
the installed jax, ROADMAP C2) and distances at rtol 1e-6.  Against the
JAX engine: ids, hops and evals exactly, distances at rtol 1e-6 (the two
frameworks sum the squares in different orders)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import DEGraph as JDEGraph
from repro.core.search import range_search as j_range_search
from repro_torch.core import beam
from repro_torch.core.search import range_search, search_graph
from repro_torch.interop import (beam_state_to_numpy, graph_from_numpy,
                                  result_to_numpy)
from _torch_threads import _one_torch_thread  # noqa: F401

INVALID = -1
_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                        "range_search_golden.npz")


@pytest.fixture(scope="module")
def golden():
    g = dict(np.load(_FIXTURE))
    graph = graph_from_numpy(g["adjacency"], g["weights"], g["n"], "cpu")
    jgraph = JDEGraph(adjacency=jnp.asarray(g["adjacency"]),
                      weights=jnp.asarray(g["weights"]),
                      n=jnp.asarray(g["n"]))
    return g, graph, jgraph


def _golden_case(g, tag):
    qs = g["queries"] if tag != "c" else g["vectors"][g["seeds_c"][:, 0]]
    kw = {"a": dict(k=10, eps=0.1),
          "b": dict(k=4, eps=0.0, beam_width=12),
          "c": dict(k=6, eps=0.2)}[tag]
    excl = g["exclude_c"] if tag == "c" else None
    return qs, g[f"seeds_{tag}"], excl, kw


@pytest.mark.parametrize("tag", ["a", "b", "c"])
def test_golden_ids_hops_evals(golden, tag):
    g, graph, _ = golden
    qs, seeds, excl, kw = _golden_case(g, tag)
    res = result_to_numpy(range_search(
        graph, torch.from_numpy(g["vectors"]), torch.from_numpy(qs),
        torch.from_numpy(seeds),
        exclude=None if excl is None else torch.from_numpy(excl), **kw))
    np.testing.assert_array_equal(res["ids"], g[f"{tag}_ids"])
    np.testing.assert_allclose(res["dists"], g[f"{tag}_dists"], rtol=1e-6)
    np.testing.assert_array_equal(res["hops"], g[f"{tag}_hops"])
    np.testing.assert_array_equal(res["evals"], g[f"{tag}_evals"])


@pytest.mark.parametrize("tag", ["b", "c"])
def test_golden_hops_and_evals_alone(golden, tag):
    g, graph, _ = golden
    qs, seeds, excl, kw = _golden_case(g, tag)
    res = range_search(
        graph, torch.from_numpy(g["vectors"]), torch.from_numpy(qs),
        torch.from_numpy(seeds),
        exclude=None if excl is None else torch.from_numpy(excl), **kw)
    np.testing.assert_array_equal(res.hops.numpy(), g[f"{tag}_hops"])
    np.testing.assert_array_equal(res.evals.numpy(), g[f"{tag}_evals"])


def _both(golden, *, E, visited_size, hop_backend="composed", budget=None,
          exclude=False, max_hops=0, k=6, eps=0.15, n_seeds=2):
    g, graph, jgraph = golden
    rng = np.random.default_rng(E * 7 + (visited_size or 0) + max_hops)
    qs = (g["vectors"][rng.integers(0, 300, 12)]
          + 0.1 * rng.normal(size=(12, 24))).astype(np.float32)
    seeds = rng.integers(0, 300, size=(12, n_seeds)).astype(np.int32)
    seeds[0, -1] = INVALID
    excl = None
    if exclude:
        excl = rng.integers(0, 300, size=(12, 4)).astype(np.int32)
        excl[:, -1] = INVALID
    hb = None if budget is None else np.full((12,), budget, np.int32)
    kw = dict(k=k, eps=eps, expand_width=E, visited_size=visited_size,
              max_hops=max_hops)
    want = j_range_search(
        jgraph, jnp.asarray(g["vectors"]), jnp.asarray(qs),
        jnp.asarray(seeds), exclude=None if excl is None else jnp.asarray(excl),
        hop_budget=None if hb is None else jnp.asarray(hb),
        hop_backend="jnp", **kw)
    got = range_search(
        graph, torch.from_numpy(g["vectors"]), torch.from_numpy(qs),
        torch.from_numpy(seeds),
        exclude=None if excl is None else torch.from_numpy(excl),
        hop_budget=None if hb is None else torch.from_numpy(hb),
        hop_backend=hop_backend, **kw)
    got = result_to_numpy(got)
    np.testing.assert_array_equal(got["ids"], np.asarray(want.ids))
    np.testing.assert_allclose(got["dists"], np.asarray(want.dists), rtol=1e-6)
    np.testing.assert_array_equal(got["hops"], np.asarray(want.hops))
    np.testing.assert_array_equal(got["evals"], np.asarray(want.evals))
    if visited_size:
        np.testing.assert_allclose(got["visited_frac"],
                                   np.asarray(want.visited_frac), rtol=1e-6)
    return got


@pytest.mark.parametrize("visited_size", [0, 256])
@pytest.mark.parametrize("E", [1, 2, 4])
def test_engine_matches_jax(golden, E, visited_size):
    _both(golden, E=E, visited_size=visited_size)


@pytest.mark.parametrize("E", [1, 2, 4])
def test_fused_hop_path_matches_jax_composed(golden, E):
    """The port's fused hop (plain version on the CPU) against the JAX
    composed hop with the visited filter: the same search, bit for bit."""
    _both(golden, E=E, visited_size=256, hop_backend="fused")


@pytest.mark.parametrize("E,visited_size", [(1, 0), (2, 256)])
def test_hop_budget_and_exclude_match_jax(golden, E, visited_size):
    got = _both(golden, E=E, visited_size=visited_size, budget=3,
                exclude=True)
    assert (got["hops"] <= 3 + E - 1).all()


def test_max_hops_reached_matches_jax(golden):
    got = _both(golden, E=1, visited_size=0, max_hops=5, k=10, eps=0.3)
    assert got["hops"].max() == 5


def test_saturated_visited_table_matches_jax(golden):
    """A 16-slot table drops most inserts, so evals depend on the exact
    table layout."""
    _both(golden, E=2, visited_size=16, k=10, eps=0.3)


def test_search_graph_and_dead_lanes_are_fixed_points(golden):
    g, graph, _ = golden
    vecs = torch.from_numpy(g["vectors"])
    qs = torch.from_numpy(g["queries"])
    res = search_graph(graph, vecs, qs, k=5)
    assert (res.ids != INVALID).all()
    seeds = torch.full((16, 1), 3, dtype=torch.int32)
    excl = torch.full((16, 1), INVALID, dtype=torch.int32)
    st = beam.init(vecs, qs, seeds, excl, graph.n, beam_width=20,
                   metric="l2")
    for _ in range(beam.default_max_hops(20)):
        st = beam.expand(st, graph.adjacency, graph.n, vecs, qs, excl, k=5,
                         eps=0.1, metric="l2")
    assert not beam.alive(st, k=5, eps=0.1).any()
    after = beam.expand(st, graph.adjacency, graph.n, vecs, qs, excl, k=5,
                        eps=0.1, metric="l2")
    before, after = beam_state_to_numpy(st), beam_state_to_numpy(after)
    assert before["visited"] is None
    for name in ("ids", "dists", "checked", "excluded", "hops", "evals"):
        np.testing.assert_array_equal(after[name], before[name], err_msg=name)
