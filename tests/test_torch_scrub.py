"""The port's online scrubber (``serving/scrub.py``) and quarantine repair
(``core/repair.py``) against the JAX package's.

Both packages build the same index; the same seeded corruption flips the
same entries; a scrubber pass then gives the same summary, the same
quarantine and the same repaired graph (rows sorted by neighbor, weights
at rtol 1e-6, as the WAL twin compares).  Quarantined ids never come back
from the port's sync or async engine, and a published medoid avoids the
quarantine."""
from __future__ import annotations

import time

import numpy as np
import pytest

from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro.core.repair import repair_vertices as j_repair_vertices
from repro.core.repair import sanitize_rows as j_sanitize_rows
from repro.serving.engine import QueryEngine as JQueryEngine
from repro.serving.scrub import IntegrityScrubber as JIntegrityScrubber
from repro.serving.scrub import corrupt_adjacency as j_corrupt_adjacency
from repro_torch.core.build import DEGParams, build_deg
from repro_torch.core.invariants import audit_rows, check_invariants
from repro_torch.core.repair import repair_vertices, sanitize_rows
from repro_torch.obs import (EPOCH_GAUGE, SCRUB_AUDITED_TOTAL,
                             SCRUB_QUARANTINED_TOTAL, SCRUB_REPAIRED_TOTAL,
                             MetricsRegistry)
from repro_torch.resilience import FaultInjected, FaultPlan
from repro_torch.serving.async_engine import AsyncQueryEngine
from repro_torch.serving.engine import QueryEngine
from repro_torch.serving.scrub import IntegrityScrubber, corrupt_adjacency
from _torch_threads import _one_torch_thread  # noqa: F401

N, DIM, DEGREE = 200, 8, 6


def _pair(seed=0):
    vecs = np.random.default_rng(seed).normal(size=(N, DIM)).astype(
        np.float32)
    kw = dict(degree=DEGREE, k_ext=2 * DEGREE)
    jidx = j_build_deg(vecs, JDEGParams(**kw), wave_size=8)
    tidx = build_deg(vecs, DEGParams(**kw), wave_size=8, device="cpu")
    return jidx, tidx, vecs


def _sorted_rows(b):
    adj, w = b.adjacency[: b.n], b.weights[: b.n]
    order = np.argsort(adj, axis=1, kind="stable")
    return (np.take_along_axis(adj, order, 1),
            np.take_along_axis(w, order, 1))


def _assert_graph_like_jax(tb, jb):
    assert tb.n == jb.n
    t_adj, t_w = _sorted_rows(tb)
    j_adj, j_w = _sorted_rows(jb)
    np.testing.assert_array_equal(t_adj, j_adj)
    np.testing.assert_allclose(t_w, j_w, rtol=1e-6)


@pytest.mark.parametrize("n_flips, seed", [(1, 0), (5, 1), (12, 2),
                                           (30, 3)])
def test_corrupt_adjacency_flips_what_jax_flips(n_flips, seed):
    jidx, tidx, _ = _pair()
    rows = corrupt_adjacency(tidx, n_flips, seed=seed)
    assert rows == j_corrupt_adjacency(jidx, n_flips, seed=seed)
    np.testing.assert_array_equal(tidx.builder.adjacency,
                                  jidx.builder.adjacency)
    # the builds' weights already differ in the last ulp (the packages
    # sum squares in different orders), the scribbled ones with them
    np.testing.assert_allclose(tidx.builder.weights, jidx.builder.weights,
                               rtol=1e-6)
    assert tidx.builder.generation == jidx.builder.generation


def test_corruption_reaches_the_device_twin():
    """``corrupt_adjacency`` marks its rows dirty, so the device twin the
    searches read carries the damage after the next sync."""
    _, tidx, _ = _pair()
    g0 = tidx.builder.device_graph().adjacency.clone()
    rows = corrupt_adjacency(tidx, 8, seed=4)
    g1 = tidx.builder.device_graph().adjacency
    np.testing.assert_array_equal(g1.numpy(), tidx.builder.adjacency)
    assert not np.array_equal(g0.numpy()[rows], g1.numpy()[rows])


@pytest.mark.parametrize("n_flips, seed", [(5, 1), (12, 2), (24, 5)])
def test_run_pass_matches_jax(n_flips, seed):
    jidx, tidx, _ = _pair()
    sums = []
    for idx, corrupt, scrubber in ((jidx, j_corrupt_adjacency,
                                    JIntegrityScrubber),
                                   (tidx, corrupt_adjacency,
                                    IntegrityScrubber)):
        idx.enable_publishing()
        corrupt(idx, n_flips, seed=seed)
        s = scrubber(idx)
        sums.append((s.run_pass(), s.run_pass(), s.stats))
    (j1, j2, jst), (t1, t2, tst) = sums
    assert t1 == j1 and t2 == j2
    assert t1["quarantined"] > 0 and t1["repaired"] == t1["quarantined"]
    assert t2["flagged"] == 0
    assert tidx.quarantine == jidx.quarantine == set()
    assert (tst.passes, tst.audited, tst.quarantined, tst.repaired,
            tst.unrepaired) == (jst.passes, jst.audited, jst.quarantined,
                                jst.repaired, jst.unrepaired)
    _assert_graph_like_jax(tidx.builder, jidx.builder)
    ok, problems = check_invariants(tidx.builder)
    assert ok, problems
    assert tidx._epochs.current.epoch == jidx._epochs.current.epoch
    np.testing.assert_array_equal(
        tidx._epochs.current.graph.adjacency.numpy()[: tidx.n],
        tidx.builder.adjacency[: tidx.n])


@pytest.mark.parametrize("refine", [False, True])
def test_repair_vertices_gives_jax_graph(refine):
    jidx, tidx, _ = _pair(seed=1)
    out = []
    for idx, corrupt, sanitize, repair in (
            (jidx, j_corrupt_adjacency, j_sanitize_rows, j_repair_vertices),
            (tidx, corrupt_adjacency, sanitize_rows, repair_vertices)):
        rows = corrupt(idx, 10, seed=6)
        flagged = sorted(set(rows) | set(np.flatnonzero(
            audit_rows(idx.builder, np.arange(idx.n))).tolist()))
        deficient = sanitize(idx, flagged)
        repaired, failed = repair(idx, flagged, refine_after=refine)
        out.append((rows, deficient, repaired, failed))
    assert out[0] == out[1]
    assert out[1][3] == []                   # every row was completed
    _assert_graph_like_jax(tidx.builder, jidx.builder)
    ok, problems = check_invariants(tidx.builder)
    assert ok, problems


def test_scrub_full_sequence_with_metrics():
    _, tidx, _ = _pair()
    reg = MetricsRegistry()
    tidx.metrics = reg
    tidx.enable_publishing()
    assert corrupt_adjacency(tidx, 5, seed=1)
    scrub = IntegrityScrubber(tidx)
    s1 = scrub.run_pass()
    assert s1["quarantined"] > 0 and s1["repaired"] == s1["quarantined"]
    assert s1["readmitted"] == s1["repaired"] and s1["unrepaired"] == 0
    s2 = scrub.run_pass()
    assert s2["flagged"] == 0 and s2["quarantined"] == 0
    assert reg.counter(SCRUB_AUDITED_TOTAL).value >= 2 * tidx.n
    assert reg.counter(SCRUB_QUARANTINED_TOTAL).value == s1["quarantined"]
    assert reg.counter(SCRUB_REPAIRED_TOTAL).value == s1["repaired"]
    assert reg.gauge(EPOCH_GAUGE).value >= 2


def _top1(idx, q):
    return int(np.asarray(idx.search_batch(q[None], k=1).ids)[0, 0])


def test_quarantined_vertices_excluded_from_serving():
    """Sync and async flushes over a quarantined epoch: the quarantined
    ids never come back, and the sync flush equals the JAX package's."""
    jidx, tidx, vecs = _pair()
    qs = vecs[[17, 40, 41, 99]] + 0.001
    hits = sorted({_top1(tidx, q) for q in qs})
    assert hits == sorted({_top1(jidx, q) for q in qs})
    for idx in (jidx, tidx):
        idx.enable_publishing()
        idx.quarantine.update(hits)
        idx.publish()
    ids, dists = QueryEngine(tidx, k=5, max_batch=8).search(qs)
    jids, jdists = JQueryEngine(jidx, k=5, max_batch=8).search(qs)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(dists, jdists, rtol=1e-6)
    assert not set(ids.ravel().tolist()) & set(hits)
    eng = AsyncQueryEngine(tidx, k=5, max_batch=8, deadline_ms=None,
                           linger_ms=5.0)
    try:
        aids, adists = eng.search(qs)
    finally:
        eng.close()
    np.testing.assert_array_equal(aids, ids)
    np.testing.assert_array_equal(adists, dists)


def test_quarantined_session_seed_falls_back_to_the_medoid():
    jidx, tidx, _ = _pair()
    for idx in (jidx, tidx):
        idx.enable_publishing()
        idx.quarantine.add(23)
        idx.publish()
    teng, jeng = (QueryEngine(tidx, k=5, max_batch=8),
                  JQueryEngine(jidx, k=5, max_batch=8))
    tf, jf = teng.explore(23, "s"), jeng.explore(23, "s")
    teng.flush()
    jeng.flush()
    np.testing.assert_array_equal(tf["ids"], jf["ids"])
    assert 23 not in tf["ids"].tolist()
    # a plain query seeded at a quarantined vertex: the medoid instead
    med = tidx._epochs.current.medoid()
    q = tidx.vectors[23]
    a = teng.submit(q, seed_vertex=23)
    b = teng.submit(q, seed_vertex=med)
    teng.flush()
    np.testing.assert_array_equal(a["ids"], b["ids"])


def test_interop_carries_a_jax_quarantine():
    """A JAX index mid-quarantine, carried across with its quarantine set:
    the port publishes the same epoch (quarantine, medoid) and its sync
    flush serves what the JAX flush serves."""
    import dataclasses

    from repro_torch.interop import index_from_numpy

    jidx, _, vecs = _pair(seed=2)
    jidx.quarantine.update({jidx.medoid(), 5, 77})
    b = jidx.builder
    tidx = index_from_numpy(jidx.vectors[: jidx.n], b.adjacency, b.weights,
                            b.n, dataclasses.asdict(jidx.params),
                            device="cpu", quarantine=jidx.quarantine)
    assert tidx.quarantine == jidx.quarantine
    for idx in (jidx, tidx):
        idx.enable_publishing()
    ep, jep = tidx._epochs.current, jidx._epochs.current
    assert ep.quarantine == jep.quarantine and ep.medoid() == jep.medoid()
    qs = vecs[[5, 77, 120]] + 0.001
    ids, dists = QueryEngine(tidx, k=5, max_batch=8).search(qs)
    jids, jdists = JQueryEngine(jidx, k=5, max_batch=8).search(qs)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(dists, jdists, rtol=1e-6)
    assert not set(ids.ravel().tolist()) & jidx.quarantine


def test_published_medoid_avoids_quarantine():
    jidx, tidx, _ = _pair()
    for idx in (jidx, tidx):
        idx.enable_publishing()
        idx.quarantine.add(idx.medoid())
        idx.publish()
    ep, jep = tidx._epochs.current, jidx._epochs.current
    assert ep.medoid() != tidx.medoid()
    assert ep.medoid() not in ep.quarantine
    assert ep.medoid() == jep.medoid() and ep.quarantine == jep.quarantine


def test_delete_remaps_the_quarantine_like_jax():
    jidx, tidx, _ = _pair()
    for idx in (jidx, tidx):
        idx.quarantine.update({5, idx.n - 1, 77})
        idx.remove([5])                      # the last vertex moves to 5
        idx.remove([77])
    assert tidx.quarantine == jidx.quarantine == {5}


def test_scrubber_background_loop_heals():
    _, tidx, _ = _pair()
    tidx.enable_publishing()
    corrupt_adjacency(tidx, 4, seed=2)
    with IntegrityScrubber(tidx, interval_s=0.05) as scrub:
        deadline = time.monotonic() + 60.0
        while tidx.quarantine or scrub.stats.repaired == 0:
            assert time.monotonic() < deadline, "scrubber never converged"
            time.sleep(0.05)
    assert scrub.stats.quarantined > 0
    assert scrub.stats.repaired == scrub.stats.quarantined
    ok, problems = check_invariants(tidx.builder)
    assert ok, problems


def test_scrub_fault_hooks_crash_counted():
    _, tidx, _ = _pair()
    scrub = IntegrityScrubber(tidx, interval_s=0.01)
    with FaultPlan().kill("scrub.audit", at=1):
        with pytest.raises(FaultInjected):
            scrub.run_pass()
    with FaultPlan().kill("scrub.audit", at=1):
        scrub.start()
        deadline = time.monotonic() + 60.0
        while scrub.stats.crashes == 0 or scrub.stats.passes == 0:
            assert time.monotonic() < deadline, "loop never recovered"
            time.sleep(0.02)
        scrub.stop()
    assert scrub.stats.crashes >= 1 and scrub.stats.passes >= 1
