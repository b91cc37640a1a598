"""Serving: the synchronous batched ANN query engine over a DEG index.

* ``engine.QueryEngine`` — request batching, exploration sessions, online
  inserts and deletes, refinement between flushes, compressed serving,
  metrics and the query log, warm start from a snapshot;
* ``buckets`` — the bucketed fixed-shape batch table the engine flushes
  through.

The JAX package's continuous-batching async engine is not ported yet
(ROADMAP A9).
"""
from repro_torch.serving.engine import EngineStats, QueryEngine  # noqa: F401
