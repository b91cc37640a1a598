"""Per-query and build-side span tracing.

A *span* here is two :func:`obs.clock.now` timestamps; the serving
engines stamp them directly onto the request future (``AsyncResult``
already carries ``submitted_at`` / ``dispatched_at`` / ``completed_at``;
this PR adds ``device_done_at``), so tracing a query allocates nothing
beyond the future that exists anyway.  The derived spans:

    admission ............ submitted_at            (queue entry)
    queue wait + linger .. dispatched_at - submitted_at
    device compute ....... device_done_at - dispatched_at
                           (async dispatch -> device->host readback done;
                           includes the rerank stage, which runs inside
                           the same compiled program)
    extract .............. completed_at - device_done_at
    total ................ completed_at - submitted_at

Ordering invariant (pinned by tests/test_obs_querylog.py):
``submitted_at <= dispatched_at <= device_done_at <= completed_at``.

:class:`Sampler` decides which queries produce a query-log record.  It is
deterministic (a fractional accumulator, not an RNG): rate 1.0 takes
every query, rate 0.25 every 4th, rate 0.0 nothing — and the 0.0 path is
a single attribute compare, so an untraced engine pays no per-query work
and allocates nothing.

:func:`span` is the build-side helper: a context manager that observes
``<name>_ms`` on a registry histogram (no-op when the registry is None),
used by ``core/build.py`` (wave stages) and ``core/optimize.py``
(refine-sweep chunks).
"""
from __future__ import annotations

import contextlib
from typing import Optional

from . import clock
from .metrics import MetricsRegistry


class Sampler:
    """Deterministic fractional sampler.  ``take()`` returns True for
    ``rate`` of calls, evenly spaced.  Not thread-safe by design: each
    engine owns one and calls it from a single thread (the scheduler)."""

    __slots__ = ("rate", "_acc")

    def __init__(self, rate: float):
        self.rate = min(max(float(rate), 0.0), 1.0)
        self._acc = 0.0

    @property
    def active(self) -> bool:
        return self.rate > 0.0

    def take(self) -> bool:
        if self.rate <= 0.0:
            return False
        if self.rate >= 1.0:
            return True
        self._acc += self.rate
        if self._acc >= 1.0:
            self._acc -= 1.0
            return True
        return False


@contextlib.contextmanager
def span(registry: Optional[MetricsRegistry], name: str, **labels):
    """Time a block into ``registry.histogram(name + '_ms')``.  With no
    registry the body runs bare (two None checks of overhead)."""
    if registry is None:
        yield
        return
    t0 = clock.now()
    try:
        yield
    finally:
        registry.histogram(name + "_ms", **labels).observe(
            (clock.now() - t0) * 1e3)


def span_fields(result) -> dict:
    """The per-query span timings (ms) derivable from an ``AsyncResult``'s
    monotonic stamps — the ``spans`` object of a query-log record.  Absent
    stamps (sync engine, which has no dispatch pipeline) yield a partial
    dict."""
    out: dict = {}
    sub = getattr(result, "submitted_at", None)
    dis = getattr(result, "dispatched_at", None)
    dev = getattr(result, "device_done_at", None)
    com = getattr(result, "completed_at", None)
    if sub is not None and dis is not None:
        out["queue_wait_ms"] = (dis - sub) * 1e3
    if dis is not None and dev is not None:
        out["device_ms"] = (dev - dis) * 1e3
    if dev is not None and com is not None:
        out["extract_ms"] = (com - dev) * 1e3
    if sub is not None and com is not None:
        out["total_ms"] = (com - sub) * 1e3
    return out
