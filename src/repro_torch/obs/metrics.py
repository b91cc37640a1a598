"""Metrics registry: counters, gauges, and log-bucketed histograms.

The serving stack's measurement layer.  Design constraints, in order:

* **cheap on the hot path** — ``Counter.inc`` / ``Histogram.observe`` are
  a lock, an index computation, and integer adds: no allocation, no
  string formatting, no wall-clock reads.  Metric objects are created
  once (``registry.counter(...)`` is get-or-create) and cached by the
  caller, so steady state never touches the registry dict;
* **mergeable** — two histograms with the same bucket layout add
  bucket-wise (:meth:`Histogram.merge_from`), so per-engine / per-shard
  registries roll up into one fleet view without losing percentile
  fidelity beyond the bucket width (``tests/test_obs_metrics.py`` pins
  merged percentiles against exact numpy over the concatenated samples);
* **reproducible percentiles** — p50/p99/p99.9 are a pure function of
  the bucket counts.  Feeding the same observations into a fresh
  histogram (e.g. replaying the query log, ``obs/querylog.py``)
  reproduces the registry's percentiles *exactly*, which is the
  round-trip the serving bench asserts;
* **exportable** — :meth:`MetricsRegistry.snapshot` is a JSON-able dict
  (the ``/metrics.json`` endpoint and the bench artifacts),
  :meth:`MetricsRegistry.to_prometheus` the text exposition format
  (``launch/serve.py --metrics-port``).

Histogram buckets are geometric (log-spaced): ``bounds[i+1] =
bounds[i] * growth``.  Relative quantile error is bounded by
``growth - 1`` per bucket, so the default ``growth=1.25`` holds every
percentile within 25% of the exact order statistic while covering
50 us .. 80 s of latency in ~54 buckets of int counts.
"""
from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Optional, Sequence

#: default latency bucket layout (milliseconds): 0.05 ms .. ~80 s
DEFAULT_LATENCY_BOUNDS_MS = None   # filled below by log_buckets()


def log_buckets(lo: float, hi: float, growth: float = 1.25
                ) -> tuple[float, ...]:
    """Geometric bucket upper bounds: lo, lo*growth, ... >= hi."""
    if not (lo > 0 and hi > lo and growth > 1.0):
        raise ValueError(f"bad bucket spec lo={lo} hi={hi} growth={growth}")
    n = int(math.ceil(math.log(hi / lo) / math.log(growth))) + 1
    return tuple(lo * growth ** i for i in range(n))


DEFAULT_LATENCY_BOUNDS_MS = log_buckets(0.05, 80_000.0)

# Canonical metric names of the live-mutation subsystem (epoch publication
# + integrity scrubber).  One authoritative spelling shared by
# core/epoch.py, core/build.py, serving/scrub.py, launch/serve.py and the
# obs round-trip test — dashboards key on these strings.
EPOCH_GAUGE = "deg_epoch"
EPOCH_PUBLISH_TOTAL = "epoch_publish_total"
EPOCH_RETIRED_LAG_MS = "epoch_retired_lag_ms"
SCRUB_AUDITED_TOTAL = "scrub_vertices_audited_total"
SCRUB_QUARANTINED_TOTAL = "scrub_quarantined_total"
SCRUB_REPAIRED_TOTAL = "scrub_repaired_total"


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _prom_name(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _prom_labels(labels: tuple, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    """Monotone float counter."""

    __slots__ = ("name", "labels", "_lock", "value")

    kind = "counter"

    def __init__(self, name: str, labels: tuple):
        self.name, self.labels = name, labels
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def merge_from(self, other: "Counter") -> None:
        with self._lock:
            self.value += other.value

    def state(self) -> dict:
        return {"value": self.value}

    def load_state(self, st: dict) -> None:
        self.value = float(st["value"])


class Gauge:
    """Last-write-wins instantaneous value (queue depth, occupancy)."""

    __slots__ = ("name", "labels", "_lock", "value")

    kind = "gauge"

    def __init__(self, name: str, labels: tuple):
        self.name, self.labels = name, labels
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def merge_from(self, other: "Gauge") -> None:
        # merging point-in-time gauges across shards: sum (queue depths,
        # occupancies add; for averages export a counter pair instead)
        with self._lock:
            self.value += other.value

    def state(self) -> dict:
        return {"value": self.value}

    def load_state(self, st: dict) -> None:
        self.value = float(st["value"])


class Histogram:
    """Log-bucketed histogram with bucket-exact percentiles.

    ``bounds`` are *upper* bucket edges (``observe(v)`` lands in the first
    bucket with ``v <= bounds[i]``); one overflow bucket catches the rest.
    Percentiles interpolate within the winning bucket, so they are a pure
    function of the counts — replay-reproducible and merge-stable.
    """

    __slots__ = ("name", "labels", "bounds", "_lock", "counts", "sum",
                 "count")

    kind = "histogram"

    def __init__(self, name: str, labels: tuple,
                 bounds: Optional[Sequence[float]] = None):
        self.name, self.labels = name, labels
        b = tuple(bounds) if bounds is not None else DEFAULT_LATENCY_BOUNDS_MS
        if list(b) != sorted(b) or len(b) < 1:
            raise ValueError("histogram bounds must be sorted and non-empty")
        self.bounds = b
        self._lock = threading.Lock()
        self.counts = [0] * (len(b) + 1)       # +1 overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def merge_from(self, other: "Histogram") -> None:
        if other.bounds != self.bounds:
            raise ValueError(
                f"cannot merge histogram {self.name!r}: bucket layouts "
                f"differ ({len(self.bounds)} vs {len(other.bounds)} bounds)")
        with self._lock:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.sum += other.sum
            self.count += other.count

    def percentile(self, q: float) -> float:
        """Bucket-interpolated q-th percentile (q in [0, 100]).  Returns
        nan when empty.  Deterministic in the counts alone."""
        total = self.count
        if total == 0:
            return float("nan")
        rank = (q / 100.0) * total
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            prev_cum = cum
            cum += c
            if cum >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1] * (self.bounds[-1] /
                                            self.bounds[-2])
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.bounds[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def percentiles(self) -> dict:
        return {"p50": self.percentile(50.0), "p99": self.percentile(99.0),
                "p999": self.percentile(99.9)}

    def state(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count,
                **self.percentiles()}

    def load_state(self, st: dict) -> None:
        if list(st["bounds"]) != list(self.bounds):
            raise ValueError("snapshot bucket layout differs")
        self.counts = [int(c) for c in st["counts"]]
        self.sum = float(st["sum"])
        self.count = int(st["count"])


class MetricsRegistry:
    """Thread-safe name+labels -> metric table (get-or-create)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, _label_key(labels), **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def merge_from(self, other: "MetricsRegistry") -> None:
        """Fold another registry in (cross-engine / cross-shard rollup):
        same (name, labels) metrics add; new ones are copied."""
        for m in other.metrics():
            labels = dict(m.labels)
            if m.kind == "counter":
                mine = self.counter(m.name, **labels)
            elif m.kind == "gauge":
                mine = self.gauge(m.name, **labels)
            else:
                mine = self.histogram(m.name, bounds=m.bounds, **labels)
            mine.merge_from(m)

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able state: ``{"metrics": [{name, kind, labels, ...}]}``."""
        out = []
        for m in sorted(self.metrics(), key=lambda m: (m.name, m.labels)):
            out.append({"name": m.name, "kind": m.kind,
                        "labels": dict(m.labels), **m.state()})
        return {"metrics": out}

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, default=float)

    @classmethod
    def from_snapshot(cls, doc: dict) -> "MetricsRegistry":
        reg = cls()
        for m in doc["metrics"]:
            labels = dict(m["labels"])
            if m["kind"] == "counter":
                reg.counter(m["name"], **labels).load_state(m)
            elif m["kind"] == "gauge":
                reg.gauge(m["name"], **labels).load_state(m)
            else:
                reg.histogram(m["name"], bounds=m["bounds"],
                              **labels).load_state(m)
        return reg

    def to_prometheus(self) -> str:
        """Prometheus text exposition (one TYPE line per metric family,
        cumulative ``_bucket`` series with the ``le`` label)."""
        lines: list[str] = []
        typed: set[str] = set()
        for m in sorted(self.metrics(), key=lambda m: (m.name, m.labels)):
            pname = _prom_name(m.name)
            if m.kind in ("counter", "gauge"):
                if pname not in typed:
                    lines.append(f"# TYPE {pname} {m.kind}")
                    typed.add(pname)
                lines.append(f"{pname}{_prom_labels(m.labels)} "
                             f"{_fmt(m.value)}")
                continue
            if pname not in typed:
                lines.append(f"# TYPE {pname} histogram")
                typed.add(pname)
            cum = 0
            for i, b in enumerate(m.bounds):
                cum += m.counts[i]
                le = 'le="%s"' % _fmt(b)
                lines.append(
                    f"{pname}_bucket{_prom_labels(m.labels, le)} {cum}")
            cum += m.counts[-1]
            le_inf = 'le="+Inf"'
            lines.append(
                f"{pname}_bucket{_prom_labels(m.labels, le_inf)} {cum}")
            lines.append(f"{pname}_sum{_prom_labels(m.labels)} "
                         f"{_fmt(m.sum)}")
            lines.append(f"{pname}_count{_prom_labels(m.labels)} {m.count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))
