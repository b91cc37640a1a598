"""The port's build (host Alg. 3 extension) replays the JAX package's, and a
JAX-built index carried across answers the same queries in both."""
import dataclasses

import numpy as np
import pytest

from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro_torch.core.build import DEGParams, build_deg
from repro_torch.core.invariants import check_table1
from repro_torch.interop import (graph_to_numpy, index_from_numpy,
                                  result_to_numpy)
from _torch_threads import _one_torch_thread  # noqa: F401

N, DIM, DEGREE, WAVE = 400, 16, 8, 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    base = rng.normal(size=(N, DIM)).astype(np.float32)
    queries = (base[rng.integers(0, N, 24)]
               + 0.1 * rng.normal(size=(24, DIM))).astype(np.float32)
    return base, queries


@pytest.fixture(scope="module")
def both(data):
    base, _ = data
    kw = dict(degree=DEGREE, k_ext=16, eps_ext=0.2, device_extend=False)
    jidx = j_build_deg(base, JDEGParams(**kw), wave_size=WAVE)
    tidx = build_deg(base, DEGParams(**kw), wave_size=WAVE, device="cpu")
    return jidx, tidx


def test_build_replays_jax(both):
    jidx, tidx = both
    assert tidx.n == jidx.n == N
    got = graph_to_numpy(tidx.frozen())
    want = jidx.frozen()
    assert got["n"] == int(want.n)
    np.testing.assert_array_equal(got["adjacency"], np.asarray(want.adjacency))
    np.testing.assert_allclose(got["weights"], np.asarray(want.weights),
                               rtol=1e-5, atol=1e-6)
    assert all(check_table1(tidx.builder).values())
    assert tidx.build_stats["vertices"] == N - DEGREE - 1


@pytest.mark.parametrize("preset", [dict(), dict(expand_width=2),
                                    dict(expand_width=4, hop_backend="fused")])
def test_built_index_searches_like_jax(both, data, preset):
    jidx, tidx = both
    _, queries = data
    jpreset = dict(preset)
    if jpreset.get("hop_backend") == "fused":
        # the JAX fused kernel does not trace (ROADMAP C1); its bit-identical
        # twin is the composed hop with the visited filter of the same size
        jpreset.update(hop_backend="jnp", visited_size=1024)
    want = jidx.search(queries, k=10, eps=0.1, **jpreset)
    got = result_to_numpy(tidx.search(queries, k=10, eps=0.1, **preset))
    assert tidx.medoid() == jidx.medoid()
    np.testing.assert_array_equal(got["ids"], np.asarray(want.ids))
    np.testing.assert_array_equal(got["hops"], np.asarray(want.hops))
    np.testing.assert_array_equal(got["evals"], np.asarray(want.evals))
    np.testing.assert_allclose(got["dists"], np.asarray(want.dists),
                               rtol=1e-5)


def test_carried_across_index_answers_like_jax(both, data):
    jidx, _ = both
    _, queries = data
    b = jidx.builder
    params = dataclasses.asdict(jidx.params)
    tidx = index_from_numpy(jidx.vectors[: jidx.n], b.adjacency, b.weights,
                            b.n, params, device="cpu")
    seeds = np.arange(24, dtype=np.int32)[:, None] * 5
    want = jidx.search_batch(queries, seeds, k=8, eps=0.1)
    got = tidx.search_batch(queries, seeds, k=8, eps=0.1)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    sv = [3, 50, 111, 250]
    seen = np.array([[7, -1], [8, 9], [-1, -1], [10, 11]], np.int32)
    want = jidx.explore(sv, k=5, exclude=seen)
    got = tidx.explore(sv, k=5, exclude=seen)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    ids = got.ids.numpy()
    for lane, v in enumerate(sv):
        assert v not in ids[lane] and not set(seen[lane]) & set(ids[lane])
