"""Typed failure vocabulary for the resilience subsystem.

Every way a request can fail to produce a search result maps to exactly
one exception type, so callers can route on ``except`` clauses instead of
string-matching messages:

- ``RequestValidationError`` — the query itself was malformed (NaN/Inf,
  wrong shape/dtype).  Raised at ``submit``; the request never reaches
  the admission queue, let alone a device batch.
- ``OverloadError`` — the bounded admission queue shed the request
  (either rejected at the door or evicted as the deadline-doomed victim).
- ``EngineCrashedError`` — a serving loop thread died; the watchdog
  fails every outstanding future with this instead of letting
  ``result()`` hang forever.

WAL errors live in :mod:`repro_torch.persist.wal` (they are persistence-layer
concerns), ``FaultInjected`` in :mod:`repro_torch.resilience.faults`.
"""
from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class for serving-resilience failures."""


class OverloadError(ResilienceError):
    """The admission queue was full and this request was shed.

    ``shed_at`` records which end lost: ``"submit"`` means the incoming
    request was rejected at the door, ``"queue"`` means it was admitted
    earlier and later evicted as the deadline-doomed victim.
    """

    def __init__(self, msg: str, *, depth: int = -1, capacity: int = -1,
                 shed_at: str = "submit"):
        super().__init__(msg)
        self.depth = depth
        self.capacity = capacity
        self.shed_at = shed_at


class EngineCrashedError(ResilienceError):
    """A serving loop thread died while this request was outstanding."""

    def __init__(self, msg: str, *, thread: str = "?"):
        super().__init__(msg)
        self.thread = thread


class RequestValidationError(ValueError):
    """The submitted query is malformed and was never enqueued."""
