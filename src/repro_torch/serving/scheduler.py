"""Admission queue + request futures for the continuous-batching engine.

The scheduler side of ``AsyncQueryEngine``: single-query submits land in
an :class:`AdmissionQueue` as :class:`Request` records and are handed out
strictly FIFO (queue-order fairness — a burst that overfills one bucket
is served oldest-first across consecutive flushes, never reordered by
deadline or arrival jitter).  Each request carries an
:class:`AsyncResult`, a thread-safe future the extract stage completes;
cancellation is resolved at dispatch time (a cancelled request still in
the queue is dropped before it costs a lane).

Deadlines are absolute :func:`repro_torch.obs.clock.now` instants (the one
monotonic clock every serving timestamp comes from — see obs/clock.py).
The queue only *accounts* for them (``next_deadline`` feeds the engine's
flush-timing decision); the policy itself — force a flush when a request
nears its deadline, search an already-expired request under a partial hop
budget — lives in ``serving/async_engine.py``.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import threading
from typing import Callable, Optional, Sequence

from repro_torch.obs import clock
from repro_torch.resilience.errors import OverloadError


class CancelledError(RuntimeError):
    """Raised by :meth:`AsyncResult.result` for a cancelled request."""


class AsyncResult:
    """Thread-safe future for one submitted query.

    States: pending -> dispatched -> done, or pending -> cancelled, or
    (pending | dispatched) -> failed.  A *failed* future carries a typed
    exception in ``error`` (:class:`~repro_torch.resilience.OverloadError` when
    the bounded queue shed it, :class:`~repro_torch.resilience.EngineCrashedError`
    when a serving thread died while it was outstanding) which
    :meth:`result` re-raises — callers never hang on a request the engine
    can no longer serve.  ``ids``/``dists`` are the per-request result
    rows; ``partial`` is True when the request's deadline expired before
    dispatch and the engine returned the best-so-far beam under the
    partial hop budget instead of dropping it; ``degraded``/
    ``degrade_level`` record whether the ladder served it below the base
    search program; ``epoch`` is the published-epoch number the flush
    searched (None when the index is not publishing) — replaying the
    query against that epoch's snapshot must reproduce ``ids``/``dists``
    bit for bit, the no-torn-reads contract of live mutation.

    The future doubles as the request's trace record: ``submitted_at`` /
    ``dispatched_at`` / ``device_done_at`` / ``completed_at`` are
    :func:`repro_torch.obs.clock.now` stamps set as the request moves through
    the pipeline (ordering invariant: each <= the next), ``seq`` its
    admission order, ``sampled`` whether the engine's query-log sampler
    took it.  Tracing therefore allocates nothing per query beyond this
    object, which exists anyway."""

    __slots__ = ("_event", "_lock", "_state", "ids", "dists", "partial",
                 "submitted_at", "dispatched_at", "device_done_at",
                 "completed_at", "deadline", "flush_index", "seq", "sampled",
                 "error", "degraded", "degrade_level", "epoch")

    def __init__(self, deadline: Optional[float] = None):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._state = "pending"
        self.ids = None
        self.dists = None
        self.partial = False
        self.error: Optional[BaseException] = None
        self.degraded = False
        self.degrade_level = 0
        self.epoch: Optional[int] = None
        self.submitted_at = clock.now()
        self.dispatched_at: Optional[float] = None
        self.device_done_at: Optional[float] = None
        self.completed_at: Optional[float] = None
        self.deadline = deadline
        self.flush_index: Optional[int] = None
        self.seq: Optional[int] = None
        self.sampled = False

    # -- state transitions (engine-side) -----------------------------------
    def _mark_dispatched(self, flush_index: int) -> None:
        with self._lock:
            self._state = "dispatched"
            self.dispatched_at = clock.now()
            self.flush_index = flush_index

    def _complete(self, ids, dists, *, partial: bool) -> None:
        with self._lock:
            self.ids, self.dists = ids, dists
            self.partial = partial
            self.completed_at = clock.now()
            self._state = "done"
        self._event.set()

    def _try_cancel(self) -> bool:
        with self._lock:
            if self._state != "pending":
                return False
            self._state = "cancelled"
        self._event.set()
        return True

    def _fail(self, exc: BaseException) -> bool:
        """Resolve the future with a typed error (shed / engine crash).

        Valid from *pending* (queue shed it) and *dispatched* (a loop
        thread died while the batch was in flight).  Returns False if the
        future already resolved — completion wins races with failure."""
        with self._lock:
            if self._state not in ("pending", "dispatched"):
                return False
            self._state = "failed"
            self.error = exc
            self.completed_at = clock.now()
        self._event.set()
        return True

    # -- caller side -------------------------------------------------------
    @property
    def cancelled(self) -> bool:
        return self._state == "cancelled"

    @property
    def failed(self) -> bool:
        return self._state == "failed"

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> bool:
        """Cancel if still queued.  Returns False once dispatched — the
        lane is already paid for and the result will arrive."""
        return self._try_cancel()

    def result(self, timeout: Optional[float] = None):
        """Block for (ids, dists).  Raises :class:`CancelledError` for a
        cancelled request, the stored typed error for a failed one
        (overload shed / engine crash), TimeoutError if the wait
        expires."""
        if not self._event.wait(timeout):
            raise TimeoutError("result not ready")
        if self._state == "cancelled":
            raise CancelledError("request was cancelled before dispatch")
        if self._state == "failed":
            raise self.error
        return self.ids, self.dists

    @property
    def latency_s(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at


@dataclasses.dataclass
class Request:
    """One admitted query: operands plus scheduling metadata."""

    query: "object"                      # (m,) float32 np.ndarray
    result: AsyncResult
    seq: int                             # admission order (FIFO key)
    exclude: Sequence[int] = ()
    seed_vertex: Optional[int] = None

    @property
    def deadline(self) -> Optional[float]:
        return self.result.deadline


class AdmissionQueue:
    """FIFO admission queue shared by the submit side and the scheduler
    thread.  All waits go through one condition variable.

    Pushes are cheap by design — the serving host shares cores with the
    device program (single-process jax), so per-request overhead on the
    submit path is stolen straight from search compute.  ``push`` only
    wakes the scheduler on the transitions it actually acts on: queue
    went non-empty (start the linger clock) or reached ``notify_at``
    (= the engine's ``max_batch``: a full bucket should flush now, not at
    linger expiry).  In between, the scheduler's own timed waits poll the
    flush instant.  Deadlines are tracked in a lazy min-heap so
    :meth:`next_deadline` is O(log n) amortized, not a deque scan per
    scheduler pass.

    With ``capacity`` set the queue is bounded and sheds under pressure
    (``capacity=None`` keeps the historical unbounded behavior).  Two
    policies:

    - ``"reject"`` — a push that would exceed capacity raises
      :class:`~repro_torch.resilience.OverloadError`; queued work is never
      disturbed.
    - ``"drop"`` — deadline-aware: the request shed is the one that
      would miss its SLO anyway — the *earliest-deadline* live request,
      the incoming one included (a request with no deadline is never the
      victim).  A queued victim's future fails with ``OverloadError``
      (``shed_at="queue"``); if the incoming request is the most doomed,
      the push itself raises (``shed_at="submit"``).  With no deadlines
      anywhere the policy degenerates to reject.

    The live count excludes requests already cancelled or shed (they
    still occupy deque slots until ``pop_ready`` discards them), so the
    recount is only paid on the already-slow overload path."""

    def __init__(self, notify_at: Optional[int] = None,
                 capacity: Optional[int] = None, shed_policy: str = "reject",
                 on_shed: Optional[Callable[[Request], None]] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None, got {capacity}")
        if shed_policy not in ("reject", "drop"):
            raise ValueError(f"unknown shed_policy {shed_policy!r}")
        self._dq: collections.deque[Request] = collections.deque()
        self._cv = threading.Condition()
        self._seq = 0
        self._head = 0            # seq of the oldest request still queued
        self._deadlines: list[tuple[float, int]] = []   # (deadline, seq)
        self.notify_at = notify_at
        self.capacity = capacity
        self.shed_policy = shed_policy
        self.on_shed = on_shed

    def __len__(self) -> int:
        with self._cv:
            return len(self._dq)

    def push(self, query, *, exclude: Sequence[int] = (),
             seed_vertex: Optional[int] = None,
             deadline: Optional[float] = None) -> AsyncResult:
        res = AsyncResult(deadline=deadline)
        victim: Optional[Request] = None
        with self._cv:
            if self.capacity is not None and \
                    len(self._dq) >= self.capacity:
                victim = self._shed_for(deadline)
                if victim is not None:
                    # fail under _cv so pop_ready can't dispatch the
                    # victim between selection and the state flip (the
                    # result lock nests inside _cv, never the reverse)
                    victim.result._fail(OverloadError(
                        "shed from queue: a fuller queue arrived before "
                        "your deadline", depth=self.capacity,
                        capacity=self.capacity, shed_at="queue"))
            req = Request(query=query, result=res, seq=self._seq,
                          exclude=exclude, seed_vertex=seed_vertex)
            res.seq = req.seq
            self._seq += 1
            self._dq.append(req)
            if deadline is not None:
                heapq.heappush(self._deadlines, (deadline, req.seq))
            n = len(self._dq)
            if n == 1 or (self.notify_at is not None
                          and n >= self.notify_at):
                self._cv.notify_all()
        if victim is not None and self.on_shed is not None:
            # callback outside the lock; the victim stays in the deque
            # (pop_ready discards it) so the seq-contiguity that
            # next_deadline's lazy heap relies on is preserved
            self.on_shed(victim)
        return res

    def _shed_for(self, incoming_deadline: Optional[float]
                  ) -> Optional[Request]:
        """Called under ``_cv`` when the deque is at/over capacity.
        Returns a queued victim to fail (admitting the incoming request),
        or raises :class:`OverloadError` to reject the incoming one."""
        live = [r for r in self._dq if r.result._state == "pending"]
        if len(live) < self.capacity:
            return None               # slack was cancelled/shed slots
        depth = len(live)
        if self.shed_policy == "drop":
            with_dl = [r for r in live if r.deadline is not None]
            if with_dl:
                victim = min(with_dl, key=lambda r: r.deadline)
                if incoming_deadline is None \
                        or incoming_deadline > victim.deadline:
                    return victim
                # the incoming request is the most doomed: fall through
        raise OverloadError(
            f"admission queue full ({depth}/{self.capacity})",
            depth=depth, capacity=self.capacity, shed_at="submit")

    def pop_ready(self, max_n: int) -> list[Request]:
        """Up to ``max_n`` oldest live requests, strict FIFO.  Requests
        cancelled or shed while queued are discarded here (their futures
        are already set), so they never occupy a lane."""
        out: list[Request] = []
        with self._cv:
            while self._dq and len(out) < max_n:
                req = self._dq.popleft()
                self._head = req.seq + 1
                if req.result._state != "pending":
                    continue
                out.append(req)
        return out

    def oldest_submit_t(self) -> Optional[float]:
        with self._cv:
            for req in self._dq:
                if req.result._state == "pending":
                    return req.result.submitted_at
        return None

    def next_deadline(self) -> Optional[float]:
        """Earliest live deadline currently queued (None if none carry
        one) — the input to the engine's deadline-aware flush timing.
        Stale heap entries (dispatched or cancelled requests) are
        discarded lazily here."""
        with self._cv:
            h = self._deadlines
            while h and h[0][1] < self._head:
                heapq.heappop(h)
            # a cancelled/shed-but-still-queued request: O(dead entries),
            # and only when the earliest deadline is a dead one
            while h and h[0][1] >= self._head:
                dl, seq = h[0]
                req = self._dq[seq - self._head] \
                    if seq - self._head < len(self._dq) else None
                if req is not None and req.seq == seq \
                        and req.result._state != "pending":
                    heapq.heappop(h)
                    continue
                return dl
        return None

    def wait(self, timeout: Optional[float] = None) -> None:
        """Sleep until a push (or timeout).  Spurious wakeups are fine —
        the engine recomputes its flush decision every pass."""
        with self._cv:
            self._cv.wait(timeout)

    def notify(self) -> None:
        with self._cv:
            self._cv.notify_all()
