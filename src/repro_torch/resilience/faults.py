"""Deterministic fault injection for chaos tests and the overload bench.

A :class:`FaultPlan` is a seeded list of rules, each bound to a named
*hook point* (``"scheduler.loop"``, ``"wal.append"``, ...).  Production
code calls :func:`fire` at those points; when no plan is installed the
call is a single global read + ``None`` check, so the hooks cost nothing
in normal operation.  When a plan is active, a matching rule can

- ``kill``  — raise :class:`FaultInjected` (simulates a thread crash /
  a process dying mid-write),
- ``delay`` — sleep for a fixed interval (simulates a slow device or a
  GC pause),
- ``call``  — run an arbitrary callable with the hook's context kwargs
  (corrupt a file, flip a byte, ...).

Rules trigger on the Nth visit to their point (``at=``, 1-based) and/or
with a seeded per-visit probability (``prob=``), so a chaos run is fully
reproducible from ``FaultPlan(seed=...)`` plus the schedule of hook
visits.  Install with ``with plan:`` (tests) or :func:`install`
(long-running processes); :meth:`FaultPlan.parse` builds a plan from the
CLI mini-language used by ``serve.py --faults``::

    scheduler.loop:kill@20;extract.loop:delay=0.05@3;wal.append:kill@7

Hook points currently wired in:

===================== ====================================================
``scheduler.loop``     top of each scheduler-loop iteration
``scheduler.dispatch`` just before a batch is padded + dispatched
``extract.loop``       top of each extract-loop iteration (before get)
``wal.append``         before a WAL record's bytes are written
``snapshot.mid_save``  between writing the tmp snapshot and the rename
``publish.swap``       inside ``DEGIndex.publish``, after the journal
                       record but before the epoch swap becomes visible
``scrub.audit``        before each scrubber audit chunk
``scrub.repair``       before the scrubber's repair stage
===================== ====================================================
"""
from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class FaultInjected(RuntimeError):
    """Raised by a ``kill`` rule.  Deliberate, not a bug."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"fault injected at {point!r} (visit {hit})")
        self.point = point
        self.hit = hit


@dataclass
class _Rule:
    point: str
    op: str                               # "kill" | "delay" | "call"
    at: Optional[int] = None              # fire on the Nth visit (1-based)
    prob: float = 0.0                     # or: per-visit probability
    arg: Any = None                       # delay seconds / callable
    times: Optional[int] = 1              # max fires (None = unlimited)
    hits: int = 0
    fired: int = 0


class FaultPlan:
    """A seeded, reproducible schedule of faults keyed by hook point."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._rules: List[_Rule] = []
        self._lock = threading.Lock()

    # -- construction -----------------------------------------------------
    def kill(self, point: str, *, at: Optional[int] = None,
             prob: float = 0.0, times: Optional[int] = 1) -> "FaultPlan":
        self._rules.append(_Rule(point, "kill", at=at, prob=prob,
                                 times=times))
        return self

    def delay(self, point: str, seconds: float, *, at: Optional[int] = None,
              prob: float = 0.0,
              times: Optional[int] = None) -> "FaultPlan":
        self._rules.append(_Rule(point, "delay", at=at, prob=prob,
                                 arg=float(seconds), times=times))
        return self

    def call(self, point: str, fn: Callable[..., None], *,
             at: Optional[int] = None, prob: float = 0.0,
             times: Optional[int] = 1) -> "FaultPlan":
        self._rules.append(_Rule(point, "call", at=at, prob=prob, arg=fn,
                                 times=times))
        return self

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Build a plan from ``point:op[=arg][@n][%p][*times];...``."""
        plan = cls(seed=seed)
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            try:
                point, action = part.split(":", 1)
                at = prob = None
                times: Optional[int] = None
                if "*" in action:
                    action, t = action.split("*", 1)
                    times = int(t)
                if "%" in action:
                    action, p = action.split("%", 1)
                    prob = float(p)
                if "@" in action:
                    action, n = action.split("@", 1)
                    at = int(n)
                if "=" in action:
                    op, arg = action.split("=", 1)
                else:
                    op, arg = action, None
                op = op.strip()
                if op == "kill":
                    plan.kill(point, at=at, prob=prob or 0.0,
                              times=times if times is not None else 1)
                elif op == "delay":
                    plan.delay(point, float(arg or 0.01), at=at,
                               prob=prob or 0.0, times=times)
                else:
                    raise ValueError(f"unknown fault op {op!r}")
            except ValueError as e:
                raise ValueError(
                    f"bad fault spec {part!r} "
                    "(want point:op[=arg][@n][%p][*times])") from e
        return plan

    # -- runtime ----------------------------------------------------------
    def fire(self, point: str, **ctx: Any) -> None:
        actions = []
        with self._lock:
            for r in self._rules:
                if r.point != point:
                    continue
                r.hits += 1
                if r.times is not None and r.fired >= r.times:
                    continue
                hit = (r.at is not None and r.hits == r.at) or \
                      (r.prob > 0.0 and self._rng.random() < r.prob)
                if hit:
                    r.fired += 1
                    actions.append((r, r.hits))
        for r, hit in actions:
            if r.op == "kill":
                raise FaultInjected(point, hit)
            if r.op == "delay":
                time.sleep(r.arg)
            elif r.op == "call":
                r.arg(**ctx)

    def counts(self) -> Dict[str, int]:
        """Fired-fault count per hook point (for test assertions)."""
        with self._lock:
            out: Dict[str, int] = {}
            for r in self._rules:
                out[r.point] = out.get(r.point, 0) + r.fired
            return out

    def __enter__(self) -> "FaultPlan":
        install(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        clear()


# Module-level active plan.  A plain global (not a threading.local): the
# serving loops run on their own threads and must see the plan installed
# by the test thread.
_ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> None:
    global _ACTIVE
    _ACTIVE = plan


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def fire(point: str, **ctx: Any) -> None:
    """Hook entry point.  No-op (one global read) when no plan is active."""
    plan = _ACTIVE
    if plan is not None:
        plan.fire(point, **ctx)


@contextlib.contextmanager
def clock_skew(offset_s: float):
    """Shift the serving clock by ``offset_s`` within the block.

    Patches ``repro_torch.obs.clock.now`` — the single time source for the
    serving path — so deadline math experiences a step change, the way a
    suspended VM or a long GC pause would look to the scheduler.
    """
    from repro_torch.obs import clock

    real = clock.now
    clock.now = lambda: real() + offset_s
    try:
        yield
    finally:
        clock.now = real
