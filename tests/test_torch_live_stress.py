"""Live mutation under serving, the port's stress twin of the JAX
package's ``test_stress_live_mutation_no_torn_reads``: a writer thread
refines, inserts, deletes and publishes for a fixed number of ticks while
the integrity scrubber audits and the async engine serves.

Every served result must replay bit-identically (``torch.equal`` on the
replayed tensors) against the epoch stamped on it: zero torn reads.
Table 1 holds at the end, recall graded against each result's own epoch
clears a floor, and the writer's ticks leave the same graph as the JAX
package applying them in order (no damage is injected, so the scrubber
only audits)."""
from __future__ import annotations

import threading

import numpy as np

from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro_torch.core.build import DEGParams, build_deg
from repro_torch.core.graph import pow2_bucket
from repro_torch.core.invariants import check_invariants
from repro_torch.serving import buckets as _buckets
from repro_torch.serving.async_engine import AsyncQueryEngine
from repro_torch.serving.scrub import IntegrityScrubber
from _torch_threads import _one_torch_thread  # noqa: F401

N, DIM, DEGREE = 400, 8, 8
TICKS = 6


def _tick(idx, i, wrng):
    """One writer tick, the JAX stress test's: refine, sometimes insert or
    delete, then publish."""
    idx.refine(8, seed=i)
    if i % 3 == 0:
        idx.add(wrng.normal(size=(1, DIM)).astype(np.float32))
    if i % 5 == 0 and idx.n > 350:
        idx.remove([int(wrng.integers(0, idx.n))])
    idx.publish()


def test_stress_live_mutation_no_torn_reads():
    vecs = np.random.default_rng(5).normal(size=(N, DIM)).astype(np.float32)
    kw = dict(degree=DEGREE, k_ext=2 * DEGREE)
    idx = build_deg(vecs, DEGParams(**kw), wave_size=8, device="cpu")
    mgr = idx.enable_publishing()
    kept = {e: mgr.live[e] for e in mgr.live_epochs()}
    kept_lock = threading.Lock()
    orig_publish = mgr.publish

    def keeping_publish(ep):                 # hold every epoch for replay
        with kept_lock:
            kept[ep.epoch] = ep
        orig_publish(ep)

    mgr.publish = keeping_publish
    writer_done = threading.Event()
    writer_err = []

    def writer():
        wrng = np.random.default_rng(13)
        try:
            for i in range(TICKS):
                _tick(idx, i, wrng)
        except Exception as e:               # pragma: no cover
            writer_err.append(e)
        finally:
            writer_done.set()

    wt = threading.Thread(target=writer, daemon=True)
    scrub = IntegrityScrubber(idx, interval_s=0.05)
    eng = AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=None,
                           linger_ms=2.0)
    served = []                              # (query, ids, dists, epoch)
    rng = np.random.default_rng(4)
    try:
        wt.start()
        scrub.start()
        while not writer_done.is_set() or len(served) < 60:
            qs = vecs[rng.integers(0, N, 6)] + 0.01 * rng.normal(
                size=(6, DIM)).astype(np.float32)
            futs = [(q, eng.submit(q)) for q in qs]
            for q, f in futs:
                ids, dists = f.result(120.0)
                served.append((q, ids, dists, f.epoch))
    finally:
        wt.join(timeout=120.0)
        scrub.stop()
        eng.close()
    assert not writer_err, writer_err
    assert scrub.stats.passes >= 1 and scrub.stats.quarantined == 0
    epochs = sorted({e for *_, e in served})
    assert len(epochs) >= 2 and epochs[-1] > 0, epochs
    assert mgr.current.epoch == TICKS
    # zero torn reads: every result replays bit-identically on its epoch,
    # in per-epoch batches (a lane does not depend on its batch)
    by_epoch: dict = {}
    for q, ids, dists, e in served:
        by_epoch.setdefault(e, []).append((q, ids, dists))
    recalls = []
    for e, group in sorted(by_epoch.items()):
        ep = kept[e]
        base = ep.vectors.numpy()[: ep.n]
        for lo in range(0, len(group), 64):
            chunk = group[lo:lo + 64]
            bucket = pow2_bucket(len(chunk))
            items = [_buckets.BatchItem(query=g[0]) for g in chunk]
            pqs, seeds, excl = _buckets.pad_batch(items, bucket, ep.medoid())
            res = _buckets.dispatch(ep, eng.cfg, pqs, seeds, excl)
            rids, rdists = res.ids.numpy(), res.dists.numpy()
            qs = np.stack([g[0] for g in chunk])
            d2 = ((base[None, :, :] - qs[:, None, :]) ** 2).sum(-1)
            gt = np.argsort(d2, axis=1)[:, :5]
            for i, (q, ids, dists) in enumerate(chunk):
                assert np.array_equal(ids, rids[i]), \
                    f"torn read: epoch {e} replay disagrees"
                assert np.array_equal(dists, rdists[i])
                recalls.append(len(set(ids.tolist())
                                   & set(gt[i].tolist())) / 5.0)
    assert float(np.mean(recalls)) >= 0.8
    with idx.mutation_lock:
        ok, problems = check_invariants(idx.builder)
    assert ok, problems
    # the same ticks applied in order by the JAX package
    jidx = j_build_deg(vecs, JDEGParams(**kw), wave_size=8)
    jidx.enable_publishing()
    wrng = np.random.default_rng(13)
    for i in range(TICKS):
        _tick(jidx, i, wrng)
    assert (idx.n, idx.builder.generation) == (jidx.n, jidx.builder.generation)
    np.testing.assert_array_equal(idx.builder.adjacency[: idx.n],
                                  jidx.builder.adjacency[: jidx.n])
    assert mgr.current.builder_gen == jidx._epochs.current.builder_gen
