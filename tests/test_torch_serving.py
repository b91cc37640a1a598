"""The port's sync ``QueryEngine`` against the JAX package's.

Both engines serve the same index: the JAX package builds it and
``interop.index_from_numpy`` carries its graph, vectors, RNG stream and
compressed stores across.  Under the same calls every future's ids and
the hop and eval counters are equal, and distances agree at rtol 1e-6
(the frameworks sum the squares in different orders).  The bucket table
is the JAX package's case for case, a lane's result does not depend on
its batch, and the port's engine logs the deterministic fields of the
query-log golden record.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro.serving import buckets as j_buckets
from repro.serving.engine import QueryEngine as JQueryEngine
from repro_torch.core.graph import INVALID
from repro_torch.core.invariants import check_table1
from repro_torch.interop import index_from_numpy, store_from_numpy
from repro_torch.obs import QueryLogWriter, read_query_log
from repro_torch.serving import QueryEngine
from repro_torch.serving import buckets as _buckets
from repro_torch.serving.engine import to_host

DATA = os.path.join(os.path.dirname(__file__), "data")
N, DIM = 400, 8
COUNTERS = ("serving_requests_total", "serving_flushes_total",
            "serving_hops_total", "serving_evals_total")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(N, DIM)).astype(np.float32)
    queries = (vecs[rng.integers(0, N, 50)]
               + 0.05 * rng.normal(size=(50, DIM))).astype(np.float32)
    jidx = j_build_deg(vecs, JDEGParams(degree=8, k_ext=16), wave_size=8)
    for codec in ("sq8", "pq"):
        jidx.store_for(codec)
    return jidx, queries


def _pair(corpus):
    """A fresh copy of the JAX index in each package (mutating tests get
    their own)."""
    from repro.persist.snapshot import index_sections, restore_into
    from repro.core.build import DEGIndex as JDEGIndex

    src, _ = corpus
    sections, payload = index_sections(src)
    jidx = JDEGIndex(src.dim, src.params, capacity=src.capacity)
    restore_into(jidx, payload, sections)
    b = jidx.builder
    tidx = index_from_numpy(jidx.vectors[: jidx.n], b.adjacency, b.weights,
                            b.n, dataclasses.asdict(jidx.params),
                            device="cpu")
    tidx._rng.bit_generator.state = jidx._rng.bit_generator.state
    for codec, s in jidx._stores.items():
        tidx._stores[codec] = store_from_numpy(
            s.data, s.scale, codec, s.codebooks, device="cpu")
    return jidx, tidx


def _engines(corpus, **kw):
    jidx, tidx = _pair(corpus)
    return JQueryEngine(jidx, **kw), QueryEngine(tidx, **kw)


def _assert_results(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def _assert_counters(teng, jeng):
    for name in COUNTERS:
        assert (teng.metrics.counter(name).value
                == jeng.metrics.counter(name).value), name


@pytest.mark.parametrize("max_batch, floor, sizes", [
    (16, 8, (50,)),                    # 16, 16, 16 and a 2 padded to 8
    (64, 8, (1, 3, 17, 29)),           # buckets 8, 8, 32, 32
    (8, 2, (5, 1, 9)),                 # 5 -> 8; 1 -> 2; 8 + 1 -> 2
])
def test_search_matches_jax_at_every_flush_size(corpus, max_batch, floor,
                                                sizes):
    _, queries = corpus
    jeng, teng = _engines(corpus, k=5, eps=0.1, max_batch=max_batch,
                          bucket_floor=floor)
    lo = 0
    for n in sizes:
        q = queries[lo : lo + n]
        lo += n
        _assert_results(teng.search(q), jeng.search(q))
    _assert_counters(teng, jeng)
    assert teng.stats.flushes == jeng.stats.flushes
    assert teng.stats.queries == sum(sizes)
    flushes = {m.labels: m.count for m in teng.metrics.metrics()
               if m.name == "serving_flush_latency_ms"}
    want = {m.labels: m.count for m in jeng.metrics.metrics()
            if m.name == "serving_flush_latency_ms"}
    assert flushes == want and sum(flushes.values()) == teng.stats.flushes


@pytest.mark.parametrize("preset", ["classic", "multi-e2", "visited-e1"])
def test_presets_match_jax(corpus, preset):
    _, queries = corpus
    jeng, teng = _engines(corpus, k=5, max_batch=16, preset=preset)
    _assert_results(teng.search(queries[:20]), jeng.search(queries[:20]))
    _assert_counters(teng, jeng)


@pytest.mark.parametrize("codec, rerank_k", [("sq8", 20), ("pq", 40)])
def test_compressed_codecs_match_jax(corpus, codec, rerank_k):
    _, queries = corpus
    jeng, teng = _engines(corpus, k=5, max_batch=16, codec=codec,
                          rerank_k=rerank_k)
    _assert_results(teng.search(queries[:20]), jeng.search(queries[:20]))
    _assert_counters(teng, jeng)
    assert teng.memory_stats()["codec"] == codec


# ---------------------------------------------------------------------------
# the bucket table (tests/test_serving_buckets.py's cases)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_batch, floor, want", [
    (64, 8, (8, 16, 32, 64)), (48, 8, (8, 16, 32, 64)), (8, 8, (8,)),
    (1, 8, (1,)), (6, 2, (2, 4, 8)), (256, 8, (8, 16, 32, 64, 128, 256))])
def test_bucket_sizes(max_batch, floor, want):
    assert _buckets.bucket_sizes(max_batch, floor) == want
    assert j_buckets.bucket_sizes(max_batch, floor) == want


def test_bucket_sizes_refuses_zero():
    with pytest.raises(ValueError):
        _buckets.bucket_sizes(0)


def test_pad_batch_shapes():
    items = [_buckets.BatchItem(query=np.full(4, i, np.float32))
             for i in range(3)]
    qs, seeds, excl = _buckets.pad_batch(items, 8, medoid=5)
    assert qs.shape == (8, 4) and seeds.shape == (8, 1)
    assert excl is None                    # no exclusions -> no operand
    assert (seeds == 5).all()
    np.testing.assert_array_equal(qs[3:], np.broadcast_to(qs[0], (5, 4)))
    with pytest.raises(ValueError, match="does not fit"):
        _buckets.pad_batch(items, 2, medoid=5)


def test_pad_batch_exclude_bucketed_to_pow2():
    items = [_buckets.BatchItem(query=np.zeros(4, np.float32),
                                exclude=list(range(11)), seed_vertex=2),
             _buckets.BatchItem(query=np.ones(4, np.float32))]
    qs, seeds, excl = _buckets.pad_batch(items, 4, medoid=5,
                                         exclude_floor=8)
    assert seeds[0, 0] == 2 and seeds[1, 0] == 5
    assert excl.shape == (4, 16)           # 11 needed -> pow2 above floor
    assert (excl[0, :11] == np.arange(11)).all()
    assert (excl[1:] == INVALID).all()
    jitems = [j_buckets.BatchItem(query=it.query, exclude=it.exclude,
                                  seed_vertex=it.seed_vertex) for it in items]
    for got, want in zip((qs, seeds, excl),
                         j_buckets.pad_batch(jitems, 4, 5, 8)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("preset", ["classic", "multi-e2-l64",
                                    "multi-e2-visited", "multi-e4-fused"])
def test_program_config_from_preset(preset):
    got = _buckets.ProgramConfig.from_preset(preset, k=7, codec="sq8",
                                             rerank_k=30)
    want = j_buckets.ProgramConfig.from_preset(preset, k=7, codec="sq8",
                                               rerank_k=30)
    hop = {"jnp": "composed", "pallas": "fused"}
    assert dataclasses.asdict(got) == dict(
        dataclasses.asdict(want), hop_backend=hop[want.hop_backend])


def test_hop_budget_none_vs_unlimited_identical(corpus):
    _, tidx = _pair(corpus)
    _, queries = corpus
    cfg = _buckets.ProgramConfig(k=5, eps=0.1)
    items = [_buckets.BatchItem(query=q) for q in queries[:8]]
    qs, seeds, excl = _buckets.pad_batch(items, 8, tidx.medoid())
    plain = to_host(_buckets.dispatch(tidx, cfg, qs, seeds, excl))
    capped = to_host(_buckets.dispatch(
        tidx, cfg, qs, seeds, excl,
        hop_budget=np.full(8, _buckets.NO_BUDGET, np.int32)))
    for a, b in zip(plain[:4], capped[:4]):
        np.testing.assert_array_equal(a, b)


def test_hop_budget_caps_per_lane_like_jax(corpus):
    """A budgeted lane stops at its cap and still returns its best-so-far
    beam; the unbudgeted lanes of the batch are untouched.  Both packages
    give the same lanes."""
    jidx, tidx = _pair(corpus)
    _, queries = corpus
    items = [_buckets.BatchItem(query=q) for q in queries[:8]]
    qs, seeds, excl = _buckets.pad_batch(items, 8, tidx.medoid())
    budget = np.full(8, _buckets.NO_BUDGET, np.int32)
    budget[::2] = 2
    got = to_host(_buckets.dispatch(tidx, _buckets.ProgramConfig(k=5), qs,
                                    seeds, excl, hop_budget=budget))
    want = j_buckets.dispatch(jidx, j_buckets.ProgramConfig(k=5), qs, seeds,
                              excl, hop_budget=budget)
    assert (got[2][::2] <= 2).all() and (got[0][::2] >= 0).any(axis=1).all()
    np.testing.assert_array_equal(got[0], np.asarray(want.ids))
    np.testing.assert_array_equal(got[2], np.asarray(want.hops))
    np.testing.assert_allclose(got[1], np.asarray(want.dists), rtol=1e-6)


def test_warmup_runs_every_bucket(corpus):
    _, teng = _engines(corpus, k=5, max_batch=32, bucket_floor=4)
    times = teng.warmup(with_budget=True)
    assert set(times) == {(b, v) for b in (4, 8, 16, 32)
                          for v in ("plain", "budget")}
    assert all(t > 0 for t in times.values())
    assert teng.stats.flushes == 0         # throwaway flushes, not served


@pytest.mark.parametrize("visited_size", [None, 64])
def test_to_host_is_the_result(corpus, visited_size):
    """The one device-to-host copy gives every field of the result."""
    _, tidx = _pair(corpus)
    _, queries = corpus
    res = tidx.search_batch(queries[:6], k=5, eps=0.1,
                            visited_size=visited_size)
    ids, dists, hops, evals, vfrac = to_host(res)
    np.testing.assert_array_equal(ids, res.ids.numpy())
    np.testing.assert_array_equal(dists, res.dists.numpy())
    np.testing.assert_array_equal(hops, res.hops.numpy())
    np.testing.assert_array_equal(evals, res.evals.numpy())
    if visited_size is None:
        assert vfrac is None and res.visited_frac is None
    else:
        np.testing.assert_array_equal(vfrac, res.visited_frac.numpy())


def test_lane_result_independent_of_batch(corpus):
    """One query alone equals its row in a full bucket."""
    _, queries = corpus
    _, teng = _engines(corpus, k=5, max_batch=32)
    full_ids, full_d = teng.search(queries[:32])
    for i in (0, 13, 31):
        ids, d = teng.search(queries[i : i + 1])
        np.testing.assert_array_equal(ids[0], full_ids[i])
        np.testing.assert_array_equal(d[0], full_d[i])


# ---------------------------------------------------------------------------
# sessions, mutation, refinement
# ---------------------------------------------------------------------------
def test_exploration_sessions_match_jax(corpus):
    jeng, teng = _engines(corpus, k=5, max_batch=4)
    seen = set()
    v = 7
    for _ in range(5):
        fut, jfut = teng.explore(v, session="u1"), jeng.explore(v,
                                                               session="u1")
        teng.flush()
        jeng.flush()
        np.testing.assert_array_equal(fut["ids"], jfut["ids"])
        ids = [int(x) for x in fut["ids"] if x >= 0]
        assert v not in ids                  # the seed itself is hidden
        assert not (set(ids) & seen)         # no repeats in the session
        seen.update(ids)
        seen.add(v)
        v = ids[0]
    assert teng._sessions == jeng._sessions
    _assert_counters(teng, jeng)
    # another session is unaffected
    fut = teng.explore(7, session="u2")
    teng.flush()
    assert any(int(x) in seen for x in fut["ids"] if x >= 0)


def test_bare_seed_vertex_is_not_hidden(corpus):
    """A seeded request outside a session searches from its seed without
    hiding it (the query-log golden's contract); in a session the seed is
    hidden, as in the JAX sync engine."""
    jidx, tidx = _pair(corpus)
    teng = QueryEngine(tidx, k=5, max_batch=4)
    q = tidx.vectors[11]
    bare = teng.submit(q, seed_vertex=11)
    teng.flush()
    assert int(bare["ids"][0]) == 11
    sess = teng.submit(q, session="s", seed_vertex=11)
    teng.flush()
    assert 11 not in sess["ids"]
    jeng = JQueryEngine(jidx, k=5, max_batch=4)
    jsess = jeng.submit(q, session="s", seed_vertex=11)
    jeng.flush()
    np.testing.assert_array_equal(sess["ids"], jsess["ids"])


def test_online_insert_findable(corpus):
    jeng, teng = _engines(corpus, k=3, max_batch=4)
    new = (10.0 + np.random.default_rng(3).normal(size=(1, DIM))).astype(
        np.float32)                          # far from every vertex
    teng.insert(new)
    jeng.insert(new)
    new_id = teng.index.n - 1
    assert new_id == N
    ids, d = teng.search(new)
    assert int(ids[0, 0]) == new_id and d[0, 0] == 0.0
    _assert_results((ids, d), jeng.search(new))
    assert teng.stats.inserts == 1


def test_delete_remaps_sessions_like_jax(corpus):
    jeng, teng = _engines(corpus, k=5, max_batch=4)
    last = teng.index.n - 1
    for eng in (jeng, teng):
        eng.explore(last, session="a")      # the vertex that will move
        eng.explore(10, session="b")
        eng.explore(3, session="c")
        eng.flush()
    assert teng._sessions == jeng._sessions
    target = teng.index.vectors[10].copy()
    assert teng.delete(10) and jeng.delete(10)
    assert teng._sessions == jeng._sessions
    assert 10 in teng._sessions["a"]        # the last vertex's new id
    assert last not in set().union(*teng._sessions.values())
    assert all(check_table1(teng.index.builder).values())
    np.testing.assert_array_equal(teng.index.builder.adjacency,
                                  jeng.index.builder.adjacency)
    ids, _ = teng.search(target[None])
    assert not np.allclose(teng.index.vectors[int(ids[0, 0])], target)


def test_refine_budget_matches_jax(corpus):
    _, queries = corpus
    jeng, teng = _engines(corpus, k=3, max_batch=4, refine_budget=2)
    for lo in (0, 4, 8):
        _assert_results(teng.search(queries[lo : lo + 4]),
                        jeng.search(queries[lo : lo + 4]))
    assert teng.stats.refine_iterations == jeng.stats.refine_iterations
    assert teng.index.refine_stats["vertices"] == 6
    np.testing.assert_array_equal(teng.index.builder.adjacency,
                                  jeng.index.builder.adjacency)
    assert all(check_table1(teng.index.builder).values())


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------
def test_from_snapshot_and_save(corpus, tmp_path):
    _, queries = corpus
    _, tidx = _pair(corpus)
    eng = QueryEngine(tidx, k=5, max_batch=8)
    q = queries[:6]
    ids_a, d_a = eng.search(q)
    p = tmp_path / "serve.npz"
    eng.save(p)
    warm = QueryEngine.from_snapshot(p, device="cpu", k=5, max_batch=8)
    assert warm.index.n == tidx.n and warm.index.device.type == "cpu"
    ids_b, d_b = warm.search(q)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(d_a, d_b)
    # the restored sq8 store serves the persisted codes
    sq8 = QueryEngine.from_snapshot(p, device="cpu", k=5, max_batch=8,
                                    codec="sq8")
    torch.testing.assert_close(sq8.index._stores["sq8"].data,
                               tidx._stores["sq8"].data, rtol=0, atol=0)
    _assert_results(sq8.search(q),
                    QueryEngine(tidx, k=5, max_batch=8,
                                codec="sq8").search(q))
    # the JAX engine warm-starts from the port's file alike
    jwarm = JQueryEngine.from_snapshot(p, k=5, max_batch=8)
    _assert_results((ids_b, d_b), jwarm.search(q))
    warm.insert(queries[:2])               # the warm engine stays mutable
    assert warm.index.n == tidx.n + 2


# ---------------------------------------------------------------------------
# the query-log golden
# ---------------------------------------------------------------------------
def test_golden_querylog(tmp_path):
    """Case A of the range_search fixture (shared seed vertex 3, k=10,
    eps=0.1), served by the sync engine at max_batch 16 with every query
    logged: the deterministic fields of the golden record exactly, dists
    at rtol 1e-6 (ROADMAP C2).  The golden came from the JAX async
    engine; buckets change padding, never semantics."""
    g = np.load(os.path.join(DATA, "range_search_golden.npz"))
    degree = g["adjacency"].shape[1]
    params = dataclasses.asdict(JDEGParams(degree=degree, k_ext=2 * degree))
    cap = g["adjacency"].shape[0]
    idx = index_from_numpy(g["vectors"][:cap], g["adjacency"], g["weights"],
                           int(g["n"]), params, device="cpu")
    path = str(tmp_path / "q.jsonl")
    qlog = QueryLogWriter(path)
    eng = QueryEngine(idx, k=10, eps=0.1, max_batch=16, trace_sample=1.0,
                      query_log=qlog)
    for i, q in enumerate(g["queries"]):
        eng.submit(q, seed_vertex=int(g["seeds_a"][i, 0]))
    eng.flush()
    qlog.close()
    got = read_query_log(path)
    want = read_query_log(os.path.join(DATA, "querylog_golden.jsonl"))
    assert len(got) == len(want) == 16
    deterministic = ("v", "qid", "qhash", "k", "seed", "exclude_n",
                     "ids", "hops", "evals", "partial", "budget_exhausted")
    for a, b in zip(sorted(got, key=lambda r: r["qid"]),
                    sorted(want, key=lambda r: r["qid"])):
        for f in deterministic:
            assert a[f] == b[f], f
        np.testing.assert_allclose(a["dists"], b["dists"], rtol=1e-6)
        assert a["bucket"] == 16 and a["flush_index"] == 0
    np.testing.assert_array_equal(
        np.stack([r["ids"] for r in got]), g["a_ids"])
