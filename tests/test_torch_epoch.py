"""Epoch publishing in the port (``core/epoch.py`` and the publishing
members of ``DEGIndex``) against the JAX package.

Both packages build the same index from the same numpy rows (a port build
replays the JAX one edge for edge), then run the same mutations.  Held
exactly: epoch numbers, builder generations, live and retired epochs,
ids, hops, evals and adjacency; distances at rtol 1e-6.  The port's own
contracts: an epoch is immutable across refine, insert and remove (its
tensors ``torch.equal`` to before), it retires only after its last
release, and ``recover`` lands on the last published epoch, for a journal
either package wrote."""
from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.serving import buckets as j_buckets
from repro_torch.core.build import DEGParams, build_deg
from repro_torch.core.invariants import check_invariants
from repro_torch.obs import (EPOCH_GAUGE, EPOCH_PUBLISH_TOTAL,
                             EPOCH_RETIRED_LAG_MS, MetricsRegistry)
from repro_torch.resilience import FaultInjected, FaultPlan
from repro_torch.serving import buckets as _buckets
from repro_torch.serving.async_engine import AsyncQueryEngine
from _torch_threads import _one_torch_thread  # noqa: F401

DIM = 8


def _vecs(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, DIM)).astype(
        np.float32)


def _pair(n=200, degree=6, seed=0):
    """The same index built by each package."""
    vecs = _vecs(n, seed)
    jidx = j_build_deg(vecs, JDEGParams(degree=degree, k_ext=2 * degree),
                       wave_size=8)
    tidx = build_deg(vecs, DEGParams(degree=degree, k_ext=2 * degree),
                     wave_size=8, device="cpu")
    assert tidx.builder.generation == jidx.builder.generation
    return jidx, tidx, vecs


def _np(res):
    return {f: np.asarray(getattr(res, f))
            for f in ("ids", "dists", "hops", "evals")}


def _assert_like_jax(tres, jres):
    t, j = _np(tres), _np(jres)
    for f in ("ids", "hops", "evals"):
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)
    np.testing.assert_allclose(t["dists"], j["dists"], rtol=1e-6)


def _assert_state_equal(a, b):
    for f in ("ids", "dists", "hops", "evals"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_published_epoch_is_immutable():
    jidx, tidx, vecs = _pair()
    jm, tm = jidx.enable_publishing(), tidx.enable_publishing()
    ep0 = tm.current
    held = {"adj": ep0.graph.adjacency.clone(),
            "w": ep0.graph.weights.clone(), "v": ep0.vectors.clone()}
    q = (vecs[3] + 0.01)[None]
    res0 = ep0.search_batch(q, k=5)
    _assert_like_jax(res0, jm.current.search_batch(q, k=5))
    for idx in (jidx, tidx):              # refine + insert + delete
        idx.refine(30, seed=1)
        idx.add(vecs[:4] + 0.5)
        idx.remove([7])
        idx.publish()
    # the held epoch's tensors and answers did not move
    assert torch.equal(ep0.graph.adjacency, held["adj"])
    assert torch.equal(ep0.graph.weights, held["w"])
    assert torch.equal(ep0.vectors, held["v"])
    _assert_state_equal(ep0.search_batch(q, k=5), res0)
    cur = tm.current
    assert (cur.epoch, cur.n) == (1, tidx.n) == (jm.current.epoch, jidx.n)
    assert cur.builder_gen == jm.current.builder_gen
    np.testing.assert_array_equal(
        cur.graph.adjacency.numpy()[: cur.n],
        np.asarray(jm.current.graph.adjacency)[: cur.n])
    _assert_state_equal(cur.search_batch(q, k=5), tidx.search_batch(q, k=5))
    _assert_like_jax(cur.search_batch(q, k=5), jm.current.search_batch(q, k=5))


def test_epoch_vectors_are_a_clone():
    """``_put_rows`` writes the live vector buffer in place: an epoch must
    hold its own copy, or the next insert changes it under its readers."""
    _, tidx, vecs = _pair()
    tidx.enable_publishing()
    ep = tidx._epochs.current
    assert ep.vectors.data_ptr() != tidx._dev_vectors.data_ptr()
    assert ep.graph.adjacency.data_ptr() != \
        tidx.builder.device_graph().adjacency.data_ptr()
    before = ep.vectors.clone()
    tidx.add(vecs[:8] + 0.25, wave_size=8)
    assert torch.equal(ep.vectors, before)
    assert not torch.equal(tidx._dev_vectors, before)


def test_epoch_refcount_retires_only_after_release():
    jidx, tidx, _ = _pair()
    for idx in (jidx, tidx):
        mgr = idx.enable_publishing()
        held = mgr.acquire()
        assert held.epoch == 0 and held.refs == 1
        idx.publish()
        assert mgr.live_epochs() == [0, 1] and mgr.retired_total == 0
        mgr.release(held)
        assert mgr.live_epochs() == [1] and mgr.retired_total == 1
        cur = mgr.acquire()
        mgr.release(cur)
        assert mgr.live_epochs() == [1]


def test_acquire_view_passthrough_without_publishing():
    _, tidx, _ = _pair()
    assert not tidx.publishing
    v = tidx.acquire_view()
    assert v is tidx
    tidx.release_view(v)
    tidx.enable_publishing()
    v = tidx.acquire_view()
    assert v is not tidx and v.epoch == 0 and v.refs == 1
    assert v.dim == DIM and v.device == tidx.device
    tidx.release_view(v)
    assert v.refs == 0


def test_publish_exports_metrics():
    jidx, tidx, _ = _pair()
    regs = {}
    for idx, reg in ((jidx, JMetricsRegistry()), (tidx, MetricsRegistry())):
        idx.metrics = reg
        mgr = idx.enable_publishing()
        held = mgr.acquire()
        idx.publish()
        mgr.release(held)                   # retires epoch 0: one lag
        idx.publish()                       # retires epoch 1 at once
        regs[idx is tidx] = reg
    for name in (EPOCH_GAUGE, EPOCH_PUBLISH_TOTAL):
        kind = "gauge" if name == EPOCH_GAUGE else "counter"
        assert (getattr(regs[True], kind)(name).value
                == getattr(regs[False], kind)(name).value)
    assert regs[True].gauge(EPOCH_GAUGE).value == 2
    assert regs[True].counter(EPOCH_PUBLISH_TOTAL).value == 3
    assert (regs[True].histogram(EPOCH_RETIRED_LAG_MS).count
            == regs[False].histogram(EPOCH_RETIRED_LAG_MS).count == 2)


def test_builder_generation_tracks_mutations():
    jidx, tidx, _ = _pair()
    gens = []
    for idx in (jidx, tidx):
        b = idx.builder
        b.device_graph()
        g = b.generation
        seen = [g, b.device_generation()]
        b.mark_dirty(0)
        seen += [b.generation, b.device_generation()]
        b.device_graph()
        seen += [b.device_generation() == b.generation]
        if b.n >= b.capacity:
            b.grow(b.capacity + 8)
        b.add_vertex()
        seen += [b.generation]
        b.invalidate_device()
        seen += [b.generation, b.device_generation()]
        b.load(b.adjacency[: b.n], b.weights[: b.n], b.n)
        seen += [b.generation]
        snap = b.snapshot([1, 2])
        b.restore(snap)
        seen += [b.generation]
        gens.append(seen)
    assert gens[0] == gens[1]
    g = gens[1]
    assert g[1] == g[0] and g[2] == g[0] + 1 and g[3] == -1 and g[4]
    assert g[5] > g[2]


def test_generations_advance_with_the_index_like_jax():
    """Equal generations after every mutation unit, and every epoch's
    stamp equal to the JAX package's."""
    jidx, tidx, vecs = _pair()
    jm, tm = jidx.enable_publishing(), tidx.enable_publishing()
    steps = [lambda i: i.refine(12, seed=4),
             lambda i: i.add(vecs[:9] + 0.3, wave_size=8),
             lambda i: i.remove([3, 40]),
             lambda i: i.builder.grow(i.builder.capacity + 16)]
    for step in steps:
        step(jidx)
        step(tidx)
        assert tidx.builder.generation == jidx.builder.generation
        assert tidx.publish() == jidx.publish()
        assert tm.current.builder_gen == jm.current.builder_gen
    assert tm.live_epochs() == jm.live_epochs() == [len(steps)]
    assert tm.retired_total == jm.retired_total == len(steps)


def test_publish_after_device_sync_captures_host_mutation():
    jidx, tidx, _ = _pair()
    for idx in (jidx, tidx):
        idx.enable_publishing()
        idx.builder.device_graph()
        idx.remove([5])
        idx.builder.device_graph()
        idx.remove([9])
        idx.publish()
    ep = tidx._epochs.current
    got = ep.graph.adjacency.numpy()[: tidx.n]
    np.testing.assert_array_equal(got, tidx.builder.adjacency[: tidx.n])
    np.testing.assert_array_equal(got, jidx.builder.adjacency[: jidx.n])
    assert ep.builder_gen == jidx._epochs.current.builder_gen


def _replay(ep, cfg, query, exclude=(), buckets=_buckets):
    """One query against a held epoch through the serving dispatch: the
    bit-identity oracle (the JAX package's dispatch for a JAX epoch; the
    config's fields are plain values either package reads)."""
    items = [buckets.BatchItem(query=query, exclude=tuple(exclude))]
    qs, seeds, excl = buckets.pad_batch(items, 1, ep.medoid())
    return buckets.dispatch(ep, cfg, qs, seeds, excl)


def test_stale_epoch_regression_async_flush():
    """Removes, device syncs and async flushes interleaved: every served
    result replays bit-identically against its stamped epoch, and each
    epoch answers as the JAX package's epoch of the same number."""
    jidx, tidx, vecs = _pair(n=200)
    mgr = tidx.enable_publishing()
    jmgr = jidx.enable_publishing()
    kept, jkept = {0: mgr.current}, {0: jmgr.current}
    eng = AsyncQueryEngine(tidx, k=5, max_batch=8, deadline_ms=None,
                           linger_ms=5.0)
    try:
        for f in [eng.submit(vecs[i] + 0.01) for i in range(6)]:
            f.result(120.0)
        with tidx.mutation_lock:
            tidx.remove([11])
            tidx.builder.device_graph()
            tidx.remove([3])
            e = tidx.publish()
            kept[e] = mgr.current
        jidx.remove([11])
        jidx.remove([3])
        je = jidx.publish()
        jkept[je] = jmgr.current
        futs2 = [(vecs[i] + 0.02, eng.submit(vecs[i] + 0.02))
                 for i in range(8)]
        for q, f in futs2:
            ids, dists = f.result(120.0)
            assert f.epoch in kept
            res = _replay(kept[f.epoch], eng.cfg, q)
            np.testing.assert_array_equal(ids, res.ids.numpy()[0])
            np.testing.assert_array_equal(dists, res.dists.numpy()[0])
            _assert_like_jax(res, _replay(jkept[f.epoch], eng.cfg, q,
                                          buckets=j_buckets))
        assert any(f.epoch == max(kept) for _, f in futs2)
    finally:
        eng.close()


def _wal_run(idx, vecs, snap, wal):
    idx.save(snap)
    idx.enable_wal(wal)
    idx.enable_publishing()                  # epoch 0 journaled
    rng = np.random.default_rng(7)
    idx.add(rng.normal(size=(5, DIM)).astype(np.float32))
    idx.refine(10, seed=2)
    idx.publish()                            # epoch 1 journaled
    at_publish = idx.builder.adjacency[: idx.n].copy()
    n_publish = idx.n
    idx.add(rng.normal(size=(3, DIM)).astype(np.float32))
    idx.remove([4])                          # an unpublished tail
    return at_publish, n_publish


def test_recover_lands_on_last_published_epoch(tmp_path):
    from repro.persist.wal import recover as j_recover
    from repro_torch.persist.wal import read_wal, recover

    jidx, tidx, vecs = _pair()
    j_at, j_n = _wal_run(jidx, vecs, tmp_path / "j.npz", tmp_path / "j.wal")
    at, n = _wal_run(tidx, vecs, tmp_path / "t.npz", tmp_path / "t.wal")
    assert n == j_n
    np.testing.assert_array_equal(at, j_at)
    wal_full = tmp_path / "t_full.wal"
    shutil.copy(tmp_path / "t.wal", wal_full)
    rec = recover(tmp_path / "t.npz", tmp_path / "t.wal", device="cpu")
    assert rec.n == n
    np.testing.assert_array_equal(rec.builder.adjacency[: rec.n], at)
    assert read_wal(tmp_path / "t.wal")[-1].op == "epoch_publish"
    rec2 = recover(tmp_path / "t.npz", tmp_path / "t.wal", device="cpu")
    np.testing.assert_array_equal(rec2.builder.adjacency[: rec2.n],
                                  rec.builder.adjacency[: rec.n])
    full = recover(tmp_path / "t.npz", wal_full, to_last_publish=False,
                   device="cpu")
    assert full.n == n + 3 - 1
    ok, problems = check_invariants(full.builder)
    assert ok, problems
    jrec = j_recover(tmp_path / "j.npz", tmp_path / "j.wal")
    np.testing.assert_array_equal(rec.builder.adjacency[: rec.n],
                                  jrec.builder.adjacency[: jrec.n])


def _sorted_rows(adj, w):
    order = np.argsort(adj, axis=1, kind="stable")
    return (np.take_along_axis(adj, order, 1),
            np.take_along_axis(w, order, 1))


def test_port_recovers_a_jax_journal_with_publishes(tmp_path):
    """A JAX snapshot and a JAX journal holding ``epoch_publish`` records:
    the port recovers it to the last published epoch, edge for edge as
    the JAX package does (rows sorted by neighbor, weights at rtol 1e-6:
    the Alg. 4 step-4a ulp tie)."""
    from repro.persist.wal import recover as j_recover
    from repro_torch.persist.wal import read_wal, recover

    jidx, _, vecs = _pair()
    snap, wal = tmp_path / "snap.npz", tmp_path / "mut.wal"
    _wal_run(jidx, vecs, snap, wal)
    ops = [r.op for r in read_wal(wal)]
    assert ops.count("epoch_publish") == 2
    rec = recover(snap, wal, device="cpu")
    want = j_recover(snap, wal)
    assert rec.n == want.n
    got_adj, got_w = _sorted_rows(rec.builder.adjacency[: rec.n],
                                  rec.builder.weights[: rec.n])
    want_adj, want_w = _sorted_rows(want.builder.adjacency[: want.n],
                                    want.builder.weights[: want.n])
    np.testing.assert_array_equal(got_adj, want_adj)
    np.testing.assert_allclose(got_w, want_w, rtol=1e-6)
    np.testing.assert_array_equal(rec.vectors[: rec.n],
                                  want.vectors[: want.n])


def test_recover_after_kill_mid_publish(tmp_path):
    _, tidx, _ = _pair()
    snap, wal = tmp_path / "snap.npz", tmp_path / "mut.wal"
    tidx.save(snap)
    tidx.enable_wal(wal)
    tidx.enable_publishing()
    tidx.refine(10, seed=3)
    at_kill = tidx.builder.adjacency[: tidx.n].copy()
    with FaultPlan().kill("publish.swap", at=1):
        with pytest.raises(FaultInjected):
            tidx.publish()
    from repro_torch.persist.wal import recover

    rec = recover(snap, wal, device="cpu")
    np.testing.assert_array_equal(rec.builder.adjacency[: rec.n], at_kill)
    assert tidx._epochs.current.epoch == 0   # the swap never happened


def test_recover_after_kill_before_publish_record(tmp_path):
    _, tidx, _ = _pair()
    snap, wal = tmp_path / "snap.npz", tmp_path / "mut.wal"
    tidx.save(snap)
    tidx.enable_wal(wal)
    tidx.enable_publishing()
    n0 = tidx.n
    adj0 = tidx.builder.adjacency[:n0].copy()
    tidx.add(np.random.default_rng(9).normal(size=(4, DIM)).astype(
        np.float32))
    with FaultPlan().kill("wal.append", at=1):
        with pytest.raises(FaultInjected):
            tidx.publish()
    from repro_torch.persist.wal import recover

    rec = recover(snap, wal, device="cpu")
    assert rec.n == n0
    np.testing.assert_array_equal(rec.builder.adjacency[:n0], adj0)


def test_refine_chunk_ticks_republish():
    """``enable_publishing(every_chunks=2)``: a refine sweep of 5 chunks
    republishes at every second chunk boundary, as in the JAX package."""
    jidx, tidx, _ = _pair()
    for idx in (jidx, tidx):
        idx.enable_publishing(every_chunks=2)
        idx.refine(80, seed=5)               # chunks of 16: 4 boundaries
    assert tidx._epochs.current.epoch == jidx._epochs.current.epoch == 2
    assert (tidx._epochs.current.builder_gen
            == jidx._epochs.current.builder_gen)


def test_mutators_hold_the_mutation_lock():
    import threading

    _, tidx, vecs = _pair()
    got = []
    with tidx.mutation_lock:
        t = threading.Thread(target=lambda: got.append(
            tidx.add(vecs[:1] + 0.1)))
        t.start()
        t.join(timeout=0.5)
        assert t.is_alive()                  # add waits for the lock
        n = tidx.n
    t.join(timeout=60)
    assert not t.is_alive() and tidx.n == n + 1
