"""Observability layer, copied from the JAX package's ``obs/``: one clock,
a mergeable metrics registry, per-query span tracing, the structured query
log and the scrape endpoint.  Numpy and the standard library only."""
from . import clock
from .metrics import (DEFAULT_LATENCY_BOUNDS_MS, EPOCH_GAUGE,
                      EPOCH_PUBLISH_TOTAL, EPOCH_RETIRED_LAG_MS,
                      SCRUB_AUDITED_TOTAL, SCRUB_QUARANTINED_TOTAL,
                      SCRUB_REPAIRED_TOTAL, Counter, Gauge, Histogram,
                      MetricsRegistry, log_buckets)
from .trace import Sampler, span, span_fields
from .querylog import (LATENCY_METRIC, QueryLogWriter, make_record,
                       mining_view, query_hash, read_query_log,
                       recall_from_log, replay_registry)
from .http import MetricsServer, serve_metrics

__all__ = [
    "clock",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BOUNDS_MS", "log_buckets",
    "EPOCH_GAUGE", "EPOCH_PUBLISH_TOTAL", "EPOCH_RETIRED_LAG_MS",
    "SCRUB_AUDITED_TOTAL", "SCRUB_QUARANTINED_TOTAL", "SCRUB_REPAIRED_TOTAL",
    "Sampler", "span", "span_fields",
    "QueryLogWriter", "LATENCY_METRIC", "make_record", "mining_view",
    "query_hash", "read_query_log", "recall_from_log", "replay_registry",
    "MetricsServer", "serve_metrics",
]
