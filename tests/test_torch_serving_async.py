"""The port's AsyncQueryEngine: continuous batching, deadlines, fairness,
cancellation, metrics and drain on close — the twin of the JAX package's
``tests/test_serving_async.py``.

The engine's core guarantee is bit-identity with the sync flush: both go
through ``serving/buckets.dispatch`` and per-lane results are independent
of batch composition, so how the scheduler grouped the requests must not
show in the results.  Pinned here against the port's sync engine
(``torch``-equal), the JAX package's sync engine (ids exact, dists at
rtol 1e-6), the golden range_search fixture and the query-log golden
record (``tests/data/querylog_golden.jsonl``, which the JAX async engine
wrote)."""
import os
import time

import numpy as np
import pytest

from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro.serving.engine import QueryEngine as JQueryEngine
from repro_torch.core.build import DEGIndex, DEGParams, build_deg
from repro_torch.serving.async_engine import AsyncQueryEngine
from repro_torch.serving.engine import QueryEngine
from repro_torch.serving.scheduler import CancelledError
from _torch_threads import _one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")
_FIXTURE = os.path.join(DATA, "range_search_golden.npz")


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(400, 8)).astype(np.float32)
    return build_deg(vecs, DEGParams(degree=8, k_ext=16), wave_size=8,
                     device="cpu"), vecs


def test_async_bit_identical_to_sync_flush(index):
    idx, vecs = index
    rng = np.random.default_rng(1)
    qs = vecs[:40] + 0.01 * rng.normal(size=(40, 8)).astype(np.float32)
    sync_ids, sync_dists = QueryEngine(idx, k=5, max_batch=16).search(qs)
    with AsyncQueryEngine(idx, k=5, max_batch=16,
                          deadline_ms=None) as eng:
        ids, dists = eng.search(qs)
    # exact equality: the scheduler's grouping (however the flushes fell)
    # must be invisible in the results
    np.testing.assert_array_equal(ids, sync_ids)
    np.testing.assert_array_equal(dists, sync_dists)
    assert eng.stats.partials == 0
    # and the JAX package's sync flush over the same build
    jidx = j_build_deg(vecs, JDEGParams(degree=8, k_ext=16), wave_size=8)
    j_ids, j_dists = JQueryEngine(jidx, k=5, max_batch=16).search(qs)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_allclose(dists, j_dists, rtol=1e-6)


@pytest.mark.parametrize("max_batch, floor", [(1, 1), (4, 2), (64, 8)])
def test_async_bit_identical_at_every_bucket_table(index, max_batch, floor):
    idx, vecs = index
    rng = np.random.default_rng(5)
    qs = vecs[100:137] + 0.01 * rng.normal(size=(37, 8)).astype(np.float32)
    sync = QueryEngine(idx, k=5, max_batch=max_batch,
                       bucket_floor=floor).search(qs)
    with AsyncQueryEngine(idx, k=5, max_batch=max_batch, bucket_floor=floor,
                          deadline_ms=None, linger_ms=1.0) as eng:
        got = eng.search(qs)
    np.testing.assert_array_equal(got[0], sync[0])
    np.testing.assert_array_equal(got[1], sync[1])
    assert set(eng.stats.bucket_hist) <= set(eng.buckets)


def test_async_replays_golden_fixture():
    """The async engine serving fixture case A (shared seed vertex 3,
    k=10, eps=0.1) must reproduce the frozen seed-implementation results
    bit for bit — continuous batching is a scheduling change, never a
    semantic one."""
    from repro_torch.core.graph import GraphBuilder

    g = np.load(_FIXTURE)
    degree = g["adjacency"].shape[1]
    cap = g["adjacency"].shape[0]
    idx = DEGIndex(g["vectors"].shape[1],
                   DEGParams(degree=degree, k_ext=2 * degree), capacity=cap,
                   device="cpu")
    rows = g["vectors"][:cap]
    idx.vectors[: rows.shape[0]] = rows
    idx._put_rows(rows, 0)
    b = GraphBuilder(cap, degree, device="cpu")
    b.load(g["adjacency"], g["weights"], int(g["n"]))
    idx.builder = b

    with AsyncQueryEngine(idx, k=10, eps=0.1, max_batch=16,
                          deadline_ms=None) as eng:
        futs = [eng.submit(q, seed_vertex=int(g["seeds_a"][i, 0]))
                for i, q in enumerate(g["queries"])]
        outs = [f.result(120.0) for f in futs]
    np.testing.assert_array_equal(np.stack([o[0] for o in outs]),
                                  g["a_ids"])
    # the fixture's distances are the JAX package's sums (ROADMAP C2)
    np.testing.assert_allclose(np.stack([o[1] for o in outs]),
                               g["a_dists"], rtol=1e-6)


def test_async_replays_golden_querylog(tmp_path):
    """Fixture case A through the async engine with every query logged:
    the deterministic fields of the JAX async engine's golden record
    exactly (ids, hops, evals, seeds, hashes), dists at rtol 1e-6."""
    from repro_torch.interop import index_from_numpy
    from repro_torch.obs import QueryLogWriter, read_query_log

    g = np.load(_FIXTURE)
    degree = g["adjacency"].shape[1]
    cap = g["adjacency"].shape[0]
    params = {"degree": degree, "k_ext": 2 * degree}
    idx = index_from_numpy(g["vectors"][:cap], g["adjacency"], g["weights"],
                           int(g["n"]), params, device="cpu")
    path = str(tmp_path / "q.jsonl")
    qlog = QueryLogWriter(path)
    with AsyncQueryEngine(idx, k=10, eps=0.1, max_batch=16, deadline_ms=None,
                          trace_sample=1.0, query_log=qlog) as eng:
        futs = [eng.submit(q, seed_vertex=int(g["seeds_a"][i, 0]))
                for i, q in enumerate(g["queries"])]
        for f in futs:
            f.result(120.0)
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


def test_deadline_expired_completes_partial(index):
    idx, vecs = index
    with AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=0.0,
                          partial_hops=4) as eng:
        fut = eng.submit(vecs[0])
        ids, dists = fut.result(120.0)
    # expired at dispatch: served under the partial hop budget, flagged —
    # best-so-far results, not a drop
    assert fut.partial
    assert (ids >= 0).any() and np.isfinite(dists).any()
    assert eng.stats.partials == 1
    assert eng.stats.forced_flushes >= 1


def test_no_deadline_never_partial(index):
    idx, vecs = index
    with AsyncQueryEngine(idx, k=5, max_batch=8,
                          deadline_ms=None) as eng:
        futs = [eng.submit(q) for q in vecs[:20]]
        for f in futs:
            f.result(120.0)
    assert all(not f.partial for f in futs)
    assert eng.stats.partials == 0 and eng.stats.forced_flushes == 0


def test_queue_order_fairness_under_full_bucket(index):
    """A burst larger than max_batch is served oldest-first across
    consecutive flushes: flush indices must be non-decreasing in
    submission order (strict FIFO pop — never reordered by arrival
    jitter or deadline)."""
    idx, vecs = index
    with AsyncQueryEngine(idx, k=5, max_batch=8, bucket_floor=8,
                          deadline_ms=None, linger_ms=20.0) as eng:
        futs = [eng.submit(q) for q in vecs[:30]]
        for f in futs:
            f.result(120.0)
    order = [f.flush_index for f in futs]
    assert order == sorted(order)
    assert eng.stats.flushes >= 2          # the burst overfilled a bucket
    assert eng.stats.queries == 30


def test_cancel_queued_request(index):
    idx, vecs = index
    # long linger so the second request is still queued when cancelled
    with AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=None,
                          linger_ms=200.0) as eng:
        keep = eng.submit(vecs[0])
        drop = eng.submit(vecs[1])
        assert drop.cancel()
        with pytest.raises(CancelledError):
            drop.result(120.0)
        ids, _ = keep.result(120.0)
        assert (ids >= 0).any()
    # the cancelled request never occupied a lane
    assert eng.stats.queries == 1
    assert not keep.partial


def test_cancel_after_dispatch_returns_false(index):
    idx, vecs = index
    with AsyncQueryEngine(idx, k=5, max_batch=8,
                          deadline_ms=None) as eng:
        fut = eng.submit(vecs[0])
        fut.result(120.0)
        assert not fut.cancel()            # already done: lane was paid for


def test_metrics_queue_depth_and_flush_histograms(index):
    """The engine's registry is the observable scheduler state: the
    queue-depth gauge tracks admissions, every flush lands in the
    per-bucket latency histogram, and the counters match .stats."""
    from repro_torch.obs import LATENCY_METRIC, MetricsRegistry

    idx, vecs = index
    reg = MetricsRegistry()
    # long linger: submits accumulate before the first dispatch, so the
    # gauge deterministically reads the pending count
    eng = AsyncQueryEngine(idx, k=5, max_batch=16, deadline_ms=None,
                           linger_ms=500.0, metrics=reg)
    try:
        futs = [eng.submit(q) for q in vecs[:12]]
        assert reg.gauge("serving_queue_depth").value == 12
        for f in futs:
            f.result(120.0)
    finally:
        eng.close()
    assert reg.gauge("serving_queue_depth").value == 0
    assert reg.counter("serving_requests_total").value == 12
    assert reg.counter("serving_flushes_total").value == eng.stats.flushes
    # every flush observed into its bucket's latency histogram
    per_bucket = {b: reg.histogram("serving_flush_latency_ms",
                                   bucket=str(b)).count
                  for b in eng.buckets}
    assert sum(per_bucket.values()) == eng.stats.flushes
    for b, n_flushes in eng.stats.bucket_hist.items():
        assert per_bucket[b] == n_flushes
    # request latency histogram saw every request
    assert reg.histogram(LATENCY_METRIC).count == 12
    # hop/eval counters surfaced from the device at zero extra work
    assert reg.counter("serving_hops_total").value > 0
    assert reg.counter("serving_evals_total").value > 0


def test_metrics_deadline_partials_counter(index):
    """Deadline-expired partials are a first-class metric, not just a
    stats field — dashboards alert on shed work."""
    from repro_torch.obs import MetricsRegistry

    idx, vecs = index
    reg = MetricsRegistry()
    with AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=0.0,
                          partial_hops=4, metrics=reg) as eng:
        futs = [eng.submit(q) for q in vecs[:3]]
        for f in futs:
            f.result(120.0)
    n_partial = sum(f.partial for f in futs)
    assert n_partial == eng.stats.partials > 0
    assert reg.counter("serving_deadline_partials_total").value == n_partial
    assert reg.counter("serving_forced_flushes_total").value == \
        eng.stats.forced_flushes


def test_sync_engine_metrics_and_flush_clock(index):
    """The sync QueryEngine reports through the same registry names, and
    its flush timing comes from the monotonic serving clock (the old
    wall-clock read could go backwards under NTP steps)."""
    from repro_torch.obs import LATENCY_METRIC, MetricsRegistry

    idx, vecs = index
    reg = MetricsRegistry()
    eng = QueryEngine(idx, k=5, max_batch=16, metrics=reg)
    eng.search(vecs[:10])
    assert reg.counter("serving_requests_total").value == 10
    assert reg.counter("serving_flushes_total").value >= 1
    # closed-loop request latency == the flush that served it
    assert reg.histogram(LATENCY_METRIC).count == 10
    hist_counts = sum(
        m.count for m in reg.metrics()
        if m.name == "serving_flush_latency_ms")
    assert hist_counts == reg.counter("serving_flushes_total").value


def test_close_drains_accepted_requests(index):
    idx, vecs = index
    eng = AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=None,
                           linger_ms=500.0)
    futs = [eng.submit(q) for q in vecs[:5]]
    eng.close()                            # must not strand queued requests
    for f in futs:
        ids, _ = f.result(10.0)
        assert (ids >= 0).any()
    with pytest.raises(RuntimeError):
        eng.submit(vecs[0])                # closed engine rejects submits
