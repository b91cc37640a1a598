"""Serving: batched ANN query engines over a DEG index.

* ``engine.QueryEngine`` — the synchronous batch engine (sessions, online
  inserts and deletes, refinement between flushes, compressed serving,
  metrics and the query log, warm start from a snapshot);
* ``async_engine.AsyncQueryEngine`` — the continuous-batching online
  engine (admission queue, deadline-aware flush, pipelined bucketed
  flushes, the resilience layer);
* ``buckets`` — the bucketed fixed-shape batch table both flush through;
  ``scheduler`` — the admission queue and request futures;
* ``scrub`` — the online integrity scrubber (audit, quarantine, repair,
  re-admit) for live mutation under epoch publishing.
"""
from repro_torch.serving.async_engine import AsyncEngineStats, AsyncQueryEngine  # noqa: F401
from repro_torch.serving.engine import EngineStats, QueryEngine  # noqa: F401
from repro_torch.serving.scheduler import AsyncResult, CancelledError  # noqa: F401
