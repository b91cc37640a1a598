"""Online integrity scrubber: audit, quarantine, repair, re-admit — live.

The paper's Table-1 guarantees (even regularity, undirectedness with
equal weights, no self loops / duplicates, single connected component)
were historically asserted only in tests.  This module audits them
continuously on a *serving* index and heals violations without taking
traffic down:

1. **Audit** — each pass sweeps the adjacency rows in chunks through the
   vectorized ``invariants.audit_rows`` (plus one frontier-sweep
   reachability check), under the index mutation lock so a concurrent
   writer's half-applied surgery is never mistaken for damage.
2. **Quarantine** — flagged vertices enter ``index.quarantine`` and the
   damaged rows are sanitized immediately (invalid half-edges dropped, so
   the live graph stays safely traversable); a ``publish()`` makes the
   quarantine visible to serving at the next flush — quarantined ids are
   excluded from results and session seeds, and the published medoid
   avoids them.
3. **Repair** — ``core.repair.repair_vertices`` re-completes the
   deficient rows (delete-repair pairing + edge splits), reconnects any
   split component, and polishes with an Alg.-5 refinement sweep.
4. **Re-admit** — repaired vertices leave quarantine only after a clean
   re-audit (row bitmask 0 *and* reachable); the follow-up ``publish()``
   restores them to serving.  Vertices that fail re-audit stay
   quarantined and are retried next pass.

The loop is wired like the async engine's supervisor: a daemon thread
with deterministic fault hooks (``scrub.audit`` per chunk,
``scrub.repair`` before surgery) so chaos tests can delay or kill it at
decision points; a crashed pass is counted and the next pass starts
clean — the scrubber never takes the serving path down with it.

Known limit: a concurrent delete compacts slots, and although the
quarantine set tracks the remap (core/delete.py), a vertex flagged in an
earlier chunk of the *same pass* may have moved by repair time.  The
repair re-audits whatever currently sits at those ids, so the worst case
is a healthy vertex briefly quarantined — excluded, never corrupted —
and the next pass converges.

WAL interaction: repairs are deliberately *not* journaled.  Corruption is
an in-RAM event the journal never saw, so ``recover(snapshot, wal)``
reconstructs the uncorrupted timeline directly — journaling the repair
would bake the damage into an otherwise clean recovery.  The cost is that
after a repair the live graph may differ bit-wise from a fresh replay
(the repaired edges are not necessarily the original ones); structural
validity and the publish protocol hold either way.

``corrupt_adjacency`` is the seeded fault injector of the tests and of
``launch/serve.py --inject-corruption``: it simulates in-range bit flips
(wrong neighbor id, scribbled weight) that a search can traverse without
crashing but the audit must catch.  It writes the builder rows directly,
so it marks them dirty: the next ``device_graph()`` then copies the damage
to the device twin the searches read, as a real fault would sit there.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from repro_torch.core import invariants as _inv
from repro_torch.obs import clock
from repro_torch.obs.metrics import (SCRUB_AUDITED_TOTAL, SCRUB_QUARANTINED_TOTAL,
                               SCRUB_REPAIRED_TOTAL)
from repro_torch.resilience import faults as _faults


@dataclasses.dataclass
class ScrubStats:
    passes: int = 0
    audited: int = 0        # row audits performed (rows x passes)
    quarantined: int = 0    # vertices that entered quarantine
    repaired: int = 0       # vertices that passed a clean re-audit
    readmitted: int = 0     # == repaired (kept separate for the summary)
    unrepaired: int = 0     # still quarantined after the latest pass
    crashes: int = 0        # passes killed by injected faults
    errors: int = 0         # passes that died on an unexpected exception
    last_pass_s: float = 0.0


class IntegrityScrubber:
    """Background Table-1 auditor with quarantine-and-repair.

    ``start()`` spawns the daemon loop (one pass every ``interval_s``);
    ``run_pass()`` is the synchronous unit the loop calls — tests drive
    it directly for determinism.  Metrics flow through the owning index's
    registry when one is attached (``scrub_vertices_audited_total``,
    ``scrub_quarantined_total``, ``scrub_repaired_total``)."""

    def __init__(self, index, *, chunk: int = 256, interval_s: float = 0.5,
                 refine_repaired: bool = True, publish: bool = True):
        self.index = index
        self.chunk = int(chunk)
        self.interval_s = float(interval_s)
        self.refine_repaired = bool(refine_repaired)
        # publish quarantine/repair transitions as new epochs (requires
        # enable_publishing(); off = pure audit/repair, e.g. sync mode)
        self.publish = bool(publish)
        self.stats = ScrubStats()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # set once the background loop has ended a pass, cleanly or not
        self.pass_ended = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="deg-scrubber", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30.0)

    close = stop

    @property
    def running(self) -> bool:
        """Whether the background loop is up (``start()``, no ``stop()``)."""
        return self._thread is not None

    def __enter__(self) -> "IntegrityScrubber":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        from repro_torch.resilience.faults import FaultInjected

        while not self._stop.wait(self.interval_s):
            try:
                self.run_pass()
            except FaultInjected:
                self.stats.crashes += 1      # chaos kill: next pass restarts
            except Exception:
                self.stats.errors += 1       # never take serving down
            self.pass_ended.set()

    # -- one pass ----------------------------------------------------------
    def run_pass(self) -> dict:
        """Audit the whole graph once, quarantine + repair + re-admit.
        Returns a summary dict (also folded into ``self.stats``)."""
        idx = self.index
        t0 = clock.now()
        summary = {"audited": 0, "flagged": 0, "quarantined": 0,
                   "repaired": 0, "readmitted": 0, "unrepaired": 0}
        if idx.builder is None:
            return summary
        metrics = idx.metrics
        flagged: list[int] = []
        # 1. chunked row audit (lock per chunk: writers interleave freely)
        start = 0
        while start < idx.n:
            _faults.fire("scrub.audit", start=start)
            with idx.mutation_lock:
                hi = min(start + self.chunk, idx.n)
                rows = np.arange(start, hi)
                mask = _inv.audit_rows(idx.builder, rows)
                bad = rows[mask != 0]
            flagged.extend(int(v) for v in bad)
            summary["audited"] += int(rows.size)
            start = hi
        # reachability: one frontier sweep from the published entry point
        with idx.mutation_lock:
            if idx.n > 0:
                entry = idx.medoid()
                unreached = _inv.unreachable_vertices(idx.builder, entry)
                flagged.extend(int(v) for v in unreached)
        flagged = sorted(set(flagged))
        summary["flagged"] = len(flagged)
        self.stats.passes += 1
        self.stats.audited += summary["audited"]
        if metrics is not None:
            metrics.counter(SCRUB_AUDITED_TOTAL).inc(summary["audited"])
        # 2. quarantine + sanitize + publish (serving is protected from
        # the damage one flush after this swap)
        if flagged:
            from repro_torch.core.repair import sanitize_rows

            with idx.mutation_lock:
                fresh = [v for v in flagged if v not in idx.quarantine]
                idx.quarantine.update(flagged)
                sanitize_rows(idx, flagged)
                if self.publish and idx.publishing:
                    idx.publish()
            summary["quarantined"] = len(fresh)
            self.stats.quarantined += len(fresh)
            if metrics is not None and fresh:
                metrics.counter(SCRUB_QUARANTINED_TOTAL).inc(len(fresh))
        # 3. repair everything currently quarantined (incl. carry-overs
        # from earlier passes), re-audit, re-admit what came back clean
        if idx.quarantine:
            _faults.fire("scrub.repair", quarantined=len(idx.quarantine))
            from repro_torch.core.repair import repair_vertices

            with idx.mutation_lock:
                work = sorted(idx.quarantine)
                candidates, _failed = repair_vertices(
                    idx, work, refine_after=self.refine_repaired)
                # re-admission gate: clean row audit AND reachable
                clean: list[int] = []
                if candidates:
                    mask = _inv.audit_rows(
                        idx.builder, np.asarray(candidates, np.int64))
                    entry = idx.medoid()
                    unreached = set(
                        int(v) for v in _inv.unreachable_vertices(
                            idx.builder, entry))
                    clean = [v for v, m in zip(candidates, mask)
                             if m == 0 and v not in unreached]
                for v in clean:
                    idx.quarantine.discard(v)
                # drop quarantined ids that no longer exist (deletes)
                idx.quarantine = {v for v in idx.quarantine if v < idx.n}
                if self.publish and idx.publishing:
                    idx.publish()
            summary["repaired"] = len(clean)
            summary["readmitted"] = len(clean)
            self.stats.repaired += len(clean)
            self.stats.readmitted += len(clean)
            if metrics is not None and clean:
                metrics.counter(SCRUB_REPAIRED_TOTAL).inc(len(clean))
        summary["unrepaired"] = len(idx.quarantine)
        self.stats.unrepaired = len(idx.quarantine)
        self.stats.last_pass_s = clock.now() - t0
        return summary


def corrupt_adjacency(index, n_flips: int, seed: int = 0) -> list[int]:
    """Seeded corruption injector (tests, serve --inject-corruption): flip
    ``n_flips`` adjacency entries to wrong in-range neighbor ids and
    scribble their weights — the damage class a memory fault or a buggy
    surgery leaves behind.  In-range ids keep the beam traversal safe
    (gathers stay in bounds) while breaking undirectedness / weights, so
    serving survives until the scrubber heals the graph.  Returns the
    corrupted row ids."""
    b = index.builder
    if b is None or b.n < 3:
        return []
    rng = np.random.default_rng(seed)
    rows: list[int] = []
    with index.mutation_lock:
        for _ in range(int(n_flips)):
            r = int(rng.integers(0, b.n))
            s = int(rng.integers(0, b.degree))
            wrong = int(rng.integers(0, b.n))
            b.adjacency[r, s] = wrong
            b.weights[r, s] = float(abs(b.weights[r, s]) * 2.0 + 1.0)
            b.mark_dirty(r)
            rows.append(r)
    return sorted(set(rows))
