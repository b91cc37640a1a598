"""Continuous-batching async serving engine.

``AsyncQueryEngine`` turns the synchronous ``QueryEngine.flush`` batch
call into an online serving loop:

* **admission queue** — ``submit`` returns immediately with an
  :class:`~repro_torch.serving.scheduler.AsyncResult`; a scheduler thread
  coalesces queued singles into dynamic batches, padded into the same
  power-of-two **bucketed fixed-shape programs** the sync engine flushes
  through (``serving/buckets.py``), so steady state reuses warmed shapes and a
  light load never pays the ``max_batch``-wide program;
* **deadline-aware flush** — a request nearing its deadline (minus the
  measured flush latency and a safety ``slack_ms``) forces a flush
  before the batch fills; a request whose deadline already expired at
  dispatch is searched under a ``partial_hops`` per-lane hop budget
  (the beam engine's early-extract operand) and completes flagged
  ``partial=True`` — best-so-far results instead of a drop;
* **host↔device pipelining** — dispatch is asynchronous: the search
  path reads nothing to the host between ``buckets.dispatch`` and
  ``engine.to_host`` (on the card it enqueues its kernels on the stream
  and returns), so while flush *i* computes on device, the scheduler
  thread stages and enqueues flush *i+1* and the extract thread blocks
  in ``to_host`` on flush *i*'s one device→host copy; a bounded
  in-flight queue (``pipeline_depth``) is the double buffer and the
  backpressure;
* **bit-identity** — with no deadline fired, a flush runs the *same
  program on the same operands* as ``QueryEngine.flush`` (both go
  through ``buckets.dispatch``), and per-lane results are independent of
  batch composition, so async results are bit-identical to a sync flush
  of the same queries no matter how the scheduler grouped them (pinned
  against the golden fixture of the query log).

Resilience (all opt-in, defaults preserve the historical behavior; see
``resilience/``): a bounded admission queue (``max_queue`` +
``shed_policy``) sheds with typed ``OverloadError`` instead of growing
latency without bound; a degradation ladder (``degrade=True``) steps the
search program down rungs (slimmer beam -> hop cap -> sq8 traversal)
under sustained queue pressure with hysteresis and back up when the
queue drains; ``submit`` validates queries (NaN/Inf never reach a
batch); and a watchdog/supervisor turns a dying loop thread into typed
``EngineCrashedError`` futures plus (``max_restarts`` budget allowing) a
restarted pipeline — ``result()`` never hangs on a dead engine.

Live mutation: when the index has epoch publication enabled
(``DEGIndex.enable_publishing()``), every flush acquires the current
published epoch (``acquire_view``) and searches *its* frozen buffers —
writers are free to insert / delete / refine the live builder
concurrently and ``publish()`` at batch boundaries; a flush never
observes mid-surgery state, and each result is stamped with the epoch it
searched (``AsyncResult.epoch``) so a replay against that snapshot is
bit-identical.  Quarantined vertices (the integrity scrubber's set,
carried on the epoch) are appended to each lane's exclude list and
dropped as session seeds.  Without publishing the engine behaves as
before: it serves the index's own device cache and the index must stay
read-only while the engine is live.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs import clock
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.querylog import LATENCY_METRIC, QueryLogWriter, make_record
from repro_torch.obs.trace import Sampler
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.degrade import (DegradePolicy, LadderController,
                                      LadderRung, build_ladder)
from repro_torch.resilience.errors import (EngineCrashedError, OverloadError,
                                     RequestValidationError)
from repro_torch.resilience.validate import validate_query
from repro_torch.serving import buckets as _buckets
from repro_torch.serving.engine import to_host
from repro_torch.serving.scheduler import AdmissionQueue, AsyncResult, Request


@dataclasses.dataclass
class AsyncEngineStats:
    flushes: int = 0
    queries: int = 0
    partials: int = 0           # deadline-expired, served best-so-far
    forced_flushes: int = 0     # flushed early for a nearing deadline
    ema_flush_s: float = 0.0    # smoothed dispatch->extracted wall time
    bucket_hist: dict = dataclasses.field(default_factory=dict)
    shed: int = 0               # overload-shed requests (queue + submit)
    invalid: int = 0            # rejected at validation, never enqueued
    degraded: int = 0           # requests served below the base rung
    crashes: int = 0            # loop-thread deaths observed
    restarts: int = 0           # successful supervisor restarts


class AsyncQueryEngine:
    def __init__(self, index, *, k: int = 10, eps: float = 0.1,
                 beam_width: Optional[int] = None,
                 codec: str = "float32", rerank_k: Optional[int] = None,
                 expand_width: Optional[int] = None,
                 visited_size: Optional[int] = None,
                 hop_backend: Optional[str] = None,
                 preset: Optional[str] = None,
                 slo: "str | object | None" = None,
                 max_batch: Optional[int] = None,
                 bucket_floor: Optional[int] = None,
                 deadline_ms: "float | None" = "unset",
                 slack_ms: Optional[float] = None,
                 linger_ms: Optional[float] = None,
                 partial_hops: Optional[int] = None,
                 pipeline_depth: Optional[int] = None,
                 exclude_width: int = 8,
                 metrics: Optional[MetricsRegistry] = None,
                 trace_sample: float = 0.0,
                 query_log: Optional[QueryLogWriter] = None,
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject",
                 degrade: "bool | DegradePolicy" = False,
                 validate: bool = True,
                 max_restarts: int = 3,
                 start: bool = True):
        """``preset`` names a ``configs.deg.SEARCH_PRESETS`` entry (the
        L/E search program); ``slo`` a ``configs.deg.SLO_PRESETS`` entry
        (or a ``ServingPreset`` instance) supplying the scheduler knobs —
        explicit keyword arguments win over both.  ``deadline_ms`` is the
        default per-request SLO (None = no deadline; requests may
        override per ``submit``).

        ``metrics`` is the engine's :class:`MetricsRegistry` (own one by
        default — pass a shared registry to roll several engines into one
        export).  Flush-level metrics and the request-latency histogram
        are always on (allocation-free observes).  ``trace_sample`` in
        [0, 1] picks which queries get a ``query_log`` JSONL record
        (obs/querylog.py); at 0.0 the per-query cost is one attribute
        compare per flush — no record is built, nothing allocated.

        Resilience knobs (all default to the historical behavior):
        ``max_queue`` bounds the admission queue (None = unbounded) with
        ``shed_policy`` ("reject" | "drop", see AdmissionQueue) deciding
        who gets the typed ``OverloadError``; ``degrade=True`` (or a
        :class:`DegradePolicy`) arms the graceful-degradation ladder —
        requires a bounded queue, since queue pressure is its input;
        ``validate`` screens NaN/Inf/shape at submit; ``max_restarts``
        caps how many times the supervisor revives crashed loop threads
        (0 = fail fast: the first crash is terminal)."""
        from repro_torch.configs.deg import SLO_PRESETS, ServingPreset

        if preset is not None:
            from repro_torch.configs.deg import SEARCH_PRESETS

            p = SEARCH_PRESETS[preset]
            expand_width = p.expand_width if expand_width is None \
                else expand_width
            hop_backend = p.hop_backend if hop_backend is None \
                else hop_backend
            visited_size = p.visited_size if visited_size is None \
                else visited_size
            beam_width = p.beam_width if beam_width is None else beam_width
        s = SLO_PRESETS[slo] if isinstance(slo, str) else \
            (slo or ServingPreset())
        self.index = index
        self.cfg = _buckets.ProgramConfig(
            k=k, eps=eps, beam_width=beam_width, codec=codec,
            rerank_k=rerank_k, expand_width=expand_width,
            visited_size=visited_size, hop_backend=hop_backend)
        self.max_batch = max_batch if max_batch is not None else s.max_batch
        self.buckets = _buckets.bucket_sizes(
            self.max_batch,
            bucket_floor if bucket_floor is not None else s.bucket_floor)
        self.default_deadline_ms = (s.deadline_ms if deadline_ms == "unset"
                                    else deadline_ms)
        self.slack_s = (slack_ms if slack_ms is not None else s.slack_ms) \
            / 1e3
        self.linger_s = (linger_ms if linger_ms is not None else s.linger_ms) \
            / 1e3
        self.partial_hops = (partial_hops if partial_hops is not None
                             else s.partial_hops)
        depth = pipeline_depth if pipeline_depth is not None \
            else s.pipeline_depth
        self._exclude_width = max(1, exclude_width)
        self.stats = AsyncEngineStats()
        # observability: resolve every metric object once here so the
        # scheduler / extract threads never touch the registry dict.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._sampler = Sampler(trace_sample)
        self._query_log = query_log
        self._m_queries = self.metrics.counter("serving_requests_total")
        self._m_flushes = self.metrics.counter("serving_flushes_total")
        self._m_forced = self.metrics.counter("serving_forced_flushes_total")
        self._m_partials = self.metrics.counter(
            "serving_deadline_partials_total")
        self._m_hops = self.metrics.counter("serving_hops_total")
        self._m_evals = self.metrics.counter("serving_evals_total")
        self._m_queue_depth = self.metrics.gauge("serving_queue_depth")
        self._m_latency = self.metrics.histogram(LATENCY_METRIC)
        self._m_flush_lat = {
            b: self.metrics.histogram("serving_flush_latency_ms",
                                      bucket=str(b))
            for b in self.buckets}
        self._m_shed = self.metrics.counter("serving_shed_total")
        self._m_invalid = self.metrics.counter(
            "serving_invalid_requests_total")
        self._m_degraded = self.metrics.counter("serving_degraded_total")
        self._m_level = self.metrics.gauge("serving_degrade_level")
        self._m_trans = {
            d: self.metrics.counter("serving_degrade_transitions_total",
                                    direction=d)
            for d in ("down", "up")}
        self._m_crashes = self.metrics.counter("serving_engine_crashes_total")
        self._m_restarts = self.metrics.counter(
            "serving_thread_restarts_total")
        # -- resilience: bounded admission + degradation ladder ------------
        self._validate = validate
        self.max_restarts = max_restarts
        self._queue = AdmissionQueue(notify_at=self.max_batch,
                                     capacity=max_queue,
                                     shed_policy=shed_policy,
                                     on_shed=self._on_shed)
        self._ladder: list[LadderRung] = [LadderRung("base", self.cfg)]
        self._ladder_ctl: Optional[LadderController] = None
        if degrade:
            if max_queue is None:
                raise ValueError("degrade needs a bounded queue "
                                 "(max_queue): queue pressure is the "
                                 "ladder's input signal")
            policy = degrade if isinstance(degrade, DegradePolicy) \
                else DegradePolicy()
            self._ladder = build_ladder(self.cfg, index.params.degree,
                                        policy)
            self._ladder_ctl = LadderController(
                len(self._ladder), max_queue, policy,
                on_change=self._on_ladder_change)
        # late-binding pipeline: the scheduler takes a dispatch slot
        # BEFORE popping the queue, so a batch is formed at the instant
        # the pipeline can absorb it (pop early and requests arriving
        # while the staged flush waits would miss the bus — the
        # small-flush oscillation).  The semaphore holds ``depth`` slots
        # (the double buffer); extract releases one per drained flush.
        self._depth = max(1, depth)
        self._slots = threading.Semaphore(self._depth)
        self._inflight: _queue.Queue = _queue.Queue()
        self._stop = False
        self._halt = False              # crash path: exit without drain
        self._crashed: Optional[EngineCrashedError] = None
        self._generation = 0
        self._staging: Optional[list[Request]] = None
        self._extracting: Optional[tuple] = None
        self._events: _queue.Queue = _queue.Queue()
        self._threads: list[threading.Thread] = []
        self._sup_thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- resilience callbacks ----------------------------------------------
    def _on_shed(self, req: Request) -> None:
        self.stats.shed += 1
        self._m_shed.inc()

    def _on_ladder_change(self, old: int, new: int, direction: str) -> None:
        self._m_trans[direction].inc()
        self._m_level.set(new)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._threads:
            return
        self._stop = False
        self._spawn_loops()
        self._sup_thread = threading.Thread(
            target=self._supervisor_loop, name="deg-serve-supervisor",
            daemon=True)
        self._sup_thread.start()

    def _spawn_loops(self) -> None:
        gen = self._generation
        self._threads = [
            threading.Thread(target=self._guarded,
                             args=(self._scheduler_loop, "scheduler", gen),
                             name="deg-serve-scheduler", daemon=True),
            threading.Thread(target=self._guarded,
                             args=(self._extract_loop, "extract", gen),
                             name="deg-serve-extract", daemon=True),
        ]
        for t in self._threads:
            t.start()

    def close(self) -> None:
        """Drain the queue (every accepted request completes), stop the
        threads.  Idempotent."""
        self._stop = True
        self._queue.notify()
        for t in self._threads:
            t.join()
        self._threads = []
        if self._sup_thread is not None:
            # FIFO: any pending crash event is handled (futures failed,
            # no restart — _stop suppresses it) before the stop sentinel
            self._events.put(None)
            self._sup_thread.join()
            self._sup_thread = None
        # a submit that raced close() past the running check: cancel its
        # future rather than leave it forever pending
        for req in self._queue.pop_ready(self.max_batch):
            req.result._try_cancel()
        if self._query_log is not None:
            self._query_log.flush()

    def __enter__(self) -> "AsyncQueryEngine":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- watchdog / supervisor ---------------------------------------------
    def _guarded(self, body, name: str, gen: int) -> None:
        """Loop-thread wrapper: a dying loop becomes a crash event for
        the supervisor instead of a silent thread exit that leaves every
        outstanding ``result()`` hanging forever."""
        try:
            body()
        except BaseException as exc:    # noqa: BLE001 — watchdog boundary
            self._events.put(("crash", gen, name, exc))

    def _supervisor_loop(self) -> None:
        while True:
            ev = self._events.get()
            if ev is None:
                return
            _, gen, name, exc = ev
            if gen != self._generation:
                continue                # stale: peer of an already-handled
            self._handle_crash(name, exc)   # crash, threads replaced

    def _handle_crash(self, name: str, exc: BaseException) -> None:
        self._generation += 1           # events from these threads: stale
        self._halt = True
        err = EngineCrashedError(
            f"serving {name} thread died: {exc!r}", thread=name)
        err.__cause__ = exc
        self._crashed = err
        self.stats.crashes += 1
        self._m_crashes.inc()
        self._queue.notify()            # unblock the scheduler's waits
        self._inflight.put(None)        # unblock the extract's get()
        for t in self._threads:
            t.join(timeout=10.0)
        # fail everything outstanding, in pipeline order: the batch the
        # scheduler popped but never enqueued, the flushes in the device
        # pipeline (incl. the one extract was unpacking), then the queue
        staging, self._staging = self._staging, None
        extracting, self._extracting = self._extracting, None
        for req in (staging or []):
            req.result._fail(err)
        if extracting is not None:
            for req in extracting[0]:
                req.result._fail(err)
            if extracting[5] is not None:      # not yet released by extract
                self.index.release_view(extracting[5])
        while True:
            try:
                item = self._inflight.get_nowait()
            except _queue.Empty:
                break
            if item is None:
                continue
            for req in item[0]:
                req.result._fail(err)
            if item[5] is not None:
                self.index.release_view(item[5])
        for req in self._queue.pop_ready(1 << 30):
            req.result._fail(err)
        self._m_queue_depth.set(0)
        if self._stop or self.stats.restarts >= self.max_restarts:
            return                      # terminal: submit now raises
        # -- revive: fresh pipeline state, new loop threads -------------
        self.stats.restarts += 1
        self._m_restarts.inc()
        self._slots = threading.Semaphore(self._depth)
        self._inflight = _queue.Queue()
        self._halt = False
        self._crashed = None
        self._spawn_loops()
        # close the submit/crash race: anything pushed between the queue
        # sweep above and the new scheduler starting is simply served

    def health(self) -> dict:
        """Liveness/pressure summary for the ``/healthz`` endpoint."""
        lvl = 0 if self._ladder_ctl is None else self._ladder_ctl.level
        status = "crashed" if self._crashed is not None else \
            ("degraded" if lvl > 0 else "ok")
        return {
            "status": status,
            "queue_depth": len(self._queue),
            "max_queue": self._queue.capacity,
            "degrade_level": lvl,
            "degrade_rung": self._ladder[min(lvl, len(self._ladder) - 1)].name,
            "restarts": self.stats.restarts,
            "crashes": self.stats.crashes,
            "shed": self.stats.shed,
            "flushes": self.stats.flushes,
            "queries": self.stats.queries,
        }

    def warmup(self) -> dict:
        """Boot-time warm-up of every (bucket, {plain, budget}) flush
        this engine can dispatch, so no live request pays a kernel build
        or a first allocation.  With the degradation ladder armed this
        covers every rung (which also encodes e.g. the sq8 store), so
        stepping down under pressure never stalls.  Returns
        ``{(bucket, variant): seconds}``."""
        times: dict = {}
        seen: set = set()
        # warm against an acquired view: under live mutation the epoch's
        # cloned buffers are the ones a concurrent writer cannot touch
        view = self.index.acquire_view()
        try:
            for i, rung in enumerate(self._ladder):
                if rung.cfg in seen:
                    continue
                seen.add(rung.cfg)
                t = _buckets.precompile(view, rung.cfg, self.buckets,
                                        with_budget=True)
                for (b, variant), secs in t.items():
                    times[(b, variant if i == 0 else f"r{i}-{variant}")] \
                        = secs
        finally:
            self.index.release_view(view)
        return times

    # -- request path ------------------------------------------------------
    def submit(self, query: np.ndarray, *,
               deadline_ms: "float | None" = "unset",
               exclude: Sequence[int] = (),
               seed_vertex: Optional[int] = None) -> AsyncResult:
        """Queue one query; returns immediately.  ``deadline_ms`` is
        relative to now ("unset" = the engine default; None = no SLO).
        ``seed_vertex`` replaces the medoid seed (exploration-style
        callers add it to ``exclude`` themselves when the protocol hides
        it).

        Typed failure surface: raises
        :class:`~repro_torch.resilience.RequestValidationError` for a malformed
        query (never enqueued), :class:`~repro_torch.resilience.OverloadError`
        when the bounded queue rejects it, and
        :class:`~repro_torch.resilience.EngineCrashedError` when the serving
        loops are dead beyond the supervisor's restart budget."""
        if self._crashed is not None:
            raise self._crashed
        if self._stop or not self._threads:
            raise RuntimeError("engine is not running (closed or never "
                               "started)")
        if self._validate:
            try:
                q = validate_query(query, self.index.dim)
            except RequestValidationError:
                self.stats.invalid += 1
                self._m_invalid.inc()
                raise
        else:
            q = np.asarray(query, np.float32)
        dl_ms = self.default_deadline_ms if deadline_ms == "unset" \
            else deadline_ms
        deadline = None if dl_ms is None else clock.now() + dl_ms / 1e3
        try:
            res = self._queue.push(q, exclude=list(exclude),
                                   seed_vertex=seed_vertex,
                                   deadline=deadline)
        except OverloadError:
            self.stats.shed += 1
            self._m_shed.inc()
            raise
        # close the submit/crash race: a push that slipped in after the
        # crash handler swept the queue would otherwise hang forever
        if self._crashed is not None:
            res._fail(self._crashed)
            raise self._crashed
        self._m_queue_depth.set(len(self._queue))
        return res

    def search(self, queries: np.ndarray, timeout: Optional[float] = 60.0
               ) -> tuple[np.ndarray, np.ndarray]:
        """Submit a batch and block for all results (convenience — the
        closed-loop face of the async engine, used by the bit-identity
        tests)."""
        futs = [self.submit(q) for q in np.atleast_2d(queries)]
        outs = [f.result(timeout) for f in futs]
        return (np.stack([o[0] for o in outs]),
                np.stack([o[1] for o in outs]))

    # -- scheduler thread --------------------------------------------------
    def _flush_at(self) -> tuple[Optional[float], bool]:
        """(instant the current queue content must flush, whether a
        deadline pulled it earlier): the oldest request's linger expiry,
        pulled forward if a queued deadline (minus slack and the measured
        flush latency) is nearer."""
        oldest = self._queue.oldest_submit_t()
        if oldest is None:
            return None, False
        at = oldest + self.linger_s
        nd = self._queue.next_deadline()
        if nd is not None:
            dl_at = nd - self.slack_s - self.stats.ema_flush_s
            if dl_at < at:
                return dl_at, True
        return at, False

    def _scheduler_loop(self) -> None:
        while True:
            if self._halt:
                return                # crash path: supervisor owns cleanup
            _faults.fire("scheduler.loop")
            if self._stop:
                while True:           # drain: accepted requests complete
                    reqs = self._queue.pop_ready(self.max_batch)
                    if not reqs:
                        break
                    self._dispatch(reqs)
                self._inflight.put(None)
                return
            if len(self._queue) == 0:
                self._queue.wait(0.02)
                continue
            if not self._slots.acquire(timeout=0.02):
                continue              # pipeline full; recheck stop flag
            deadline_forced = False
            while (not self._stop and not self._halt
                   and len(self._queue) < self.max_batch):
                at, forced = self._flush_at()
                now = clock.now()
                if at is None or now >= at:
                    deadline_forced = forced and at is not None
                    break
                self._queue.wait(min(at - now, 0.02))
                if len(self._queue) == 0:
                    break
            reqs = self._queue.pop_ready(self.max_batch)
            if reqs:
                if deadline_forced:
                    self.stats.forced_flushes += 1
                    self._m_forced.inc()
                self._dispatch(reqs)
            else:
                self._slots.release()

    def _dispatch(self, reqs: list[Request]) -> None:
        """Stage one bucketed flush and enqueue it (asynchronously: the
        search returns before the device finishes) for the extract
        thread."""
        # _staging lets the crash handler fail a batch that was popped
        # from the queue but never made it into the in-flight pipeline
        self._staging = reqs
        _faults.fire("scheduler.dispatch", batch=len(reqs))
        B = len(reqs)
        bucket = next(b for b in self.buckets if b >= B)
        # degradation ladder: backlog left *after* popping this batch is
        # the pressure signal; the whole flush dispatches at one rung
        level = 0
        if self._ladder_ctl is not None:
            level = self._ladder_ctl.observe(len(self._queue))
        rung = self._ladder[level]
        now = clock.now()
        expired = [r.deadline is not None and now > r.deadline for r in reqs]
        budget = None
        if any(expired) or rung.hop_budget is not None:
            # expired lanes run the partial-hop early extract; the rest
            # (and the padding) run the rung's cap, or uncapped at the
            # base rung.  One budgeted program per bucket regardless of
            # which lanes expired (traced operand).
            base = _buckets.NO_BUDGET if rung.hop_budget is None \
                else rung.hop_budget
            budget = np.full(bucket, base, np.int32)
            for i, ex in enumerate(expired):
                if ex:
                    budget[i] = min(self.partial_hops, int(base))
        # live-mutation epoch capture: the whole flush searches ONE
        # immutable published snapshot (or the index itself when not
        # publishing — then the single-writer contract applies).  The
        # reference is dropped by the extract thread once results are on
        # host; the epoch retires when its last in-flight flush releases.
        view = self.index.acquire_view()
        try:
            quarantine = tuple(getattr(view, "quarantine", ()) or ())
            qset = set(quarantine)
            items = []
            for r in reqs:
                excl_ids = r.exclude
                if quarantine:
                    # quarantined vertices never appear in results; a
                    # quarantined session seed falls back to the medoid
                    excl_ids = list(dict.fromkeys(
                        list(excl_ids) + list(quarantine)))
                sv = r.seed_vertex
                if sv is not None and sv in qset:
                    sv = None
                items.append(_buckets.BatchItem(
                    query=r.query, exclude=excl_ids, seed_vertex=sv))
            qs, seeds, excl = _buckets.pad_batch(items, bucket,
                                                 view.medoid(),
                                                 self._exclude_width)
            res = _buckets.dispatch(view, rung.cfg, qs, seeds, excl,
                                    hop_budget=budget)
        except BaseException:
            self.index.release_view(view)
            raise
        flush_index = self.stats.flushes
        self.stats.flushes += 1
        self.stats.queries += B
        self.stats.bucket_hist[bucket] = \
            self.stats.bucket_hist.get(bucket, 0) + 1
        self._m_flushes.inc()
        self._m_queries.inc(B)
        self._m_queue_depth.set(len(self._queue))
        if level > 0:
            self.stats.degraded += B
            self._m_degraded.inc(B)
        if self._sampler.active:          # one compare per flush at 0.0
            for r in reqs:                # single-threaded sampler use
                r.result.sampled = self._sampler.take()
        for r in reqs:
            r.result.degraded = level > 0
            r.result.degrade_level = level
            r.result.epoch = getattr(view, "epoch", None)
            r.result._mark_dispatched(flush_index)
        # in-flight count is bounded by the dispatch-slot semaphore
        # (acquired before the batch was popped), so this never blocks;
        # extract releases the slot once the flush is drained.  A list,
        # not a tuple: slot 5 (the epoch view) is cleared in place on
        # release so the crash handler can't double-release it.
        self._inflight.put([reqs, res, expired, bucket, clock.now(), view])
        self._staging = None

    # -- extract thread ----------------------------------------------------
    def _extract_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            # _extracting mirrors _staging: if this loop dies mid-item,
            # the crash handler fails the futures it had already dequeued
            self._extracting = item
            _faults.fire("extract.loop")
            reqs, res, expired, bucket, t0, view = item
            B = len(reqs)
            # one device->host copy of every field: blocks until the
            # flush's kernels have run
            ids, dists, hops, evals, vfrac = to_host(res)
            t_dev = clock.now()
            dt = t_dev - t0
            self.stats.ema_flush_s = dt if not self.stats.ema_flush_s \
                else 0.8 * self.stats.ema_flush_s + 0.2 * dt
            self._m_flush_lat[bucket].observe(dt * 1e3)
            self._m_hops.inc(int(hops[:B].sum()))
            self._m_evals.inc(int(evals[:B].sum()))
            # every device read of this flush is on host: drop the epoch
            # reference (clearing the slot keeps a crash-drain from
            # double-releasing this item)
            item[5] = None
            self.index.release_view(view)
            log = self._query_log
            any_sampled = log is not None and any(
                r.result.sampled for r in reqs)
            for i, r in enumerate(reqs):
                if expired[i]:
                    self.stats.partials += 1
                    self._m_partials.inc()
                r.result.device_done_at = t_dev
                r.result._complete(ids[i].copy(), dists[i].copy(),
                                   partial=expired[i])
                # observe AFTER _complete so the histogram sees the same
                # completed_at the future exposes (log replay matches)
                self._m_latency.observe(
                    (r.result.completed_at - r.result.submitted_at) * 1e3)
                if any_sampled and r.result.sampled:
                    log.write(make_record(
                        qid=r.seq, query=r.query, k=self.cfg.k,
                        ids=ids[i], dists=dists[i],
                        hops=int(hops[i]), evals=int(evals[i]),
                        seed_vertex=r.seed_vertex,
                        exclude_n=len(r.exclude),
                        visited_frac=None if vfrac is None
                        else float(vfrac[i]),
                        budget_exhausted=bool(
                            expired[i] and self.partial_hops is not None
                            and hops[i] >= self.partial_hops),
                        partial=expired[i],
                        flush_index=r.result.flush_index, bucket=bucket,
                        latency_ms=(r.result.completed_at
                                    - r.result.submitted_at) * 1e3,
                        result=r.result,
                        t_mono=r.result.submitted_at))
            self._extracting = None
            self._slots.release()     # free the dispatch slot last, so a
            # newly formed batch sees this flush's arrivals in the queue
