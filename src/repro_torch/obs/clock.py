"""The one clock source for every span, deadline, and latency figure.

Before this module existed the serving stack mixed three clocks:
``QueryEngine.flush`` timed itself with the wall clock (``time.time`` —
not monotonic; an NTP step mid-flush produces a negative or wildly
wrong latency), the async scheduler used ``time.monotonic``, and the
bucket precompiler used ``time.perf_counter``.  Cross-clock arithmetic
is a silent bug factory: two timestamps are only subtractable when they
came from the *same* clock.

Rules (enforced by a grep in ``tests/test_torch_obs.py`` — calling
``time.time`` is banned under the ``serving/`` and ``obs/`` packages;
this docstring names it without the call parens for exactly that
reason):

* every duration, span timestamp, and deadline instant comes from
  :func:`now` — ``time.perf_counter``, the highest-resolution monotonic
  clock CPython offers.  Values are only meaningful as *differences*
  within one process;
* wall-clock time appears exactly once per query-log file — the
  ``t_wall_unix`` / ``clock_origin`` anchor pair in each record lets an
  offline reader reconstruct absolute times without any hot-path
  wall-clock reads (see ``obs/querylog.py``);
* human-facing timestamps (bench JSON, log file headers) use
  :func:`wall_iso`, which goes through ``datetime`` so the banned-call
  lint stays a plain-text grep.
"""
from __future__ import annotations

import datetime as _datetime
import time as _time

#: THE span/deadline clock: monotonic, high resolution, ns-quantized by
#: the OS.  Alias (not a wrapper) so the hot path pays zero extra frames.
now = _time.perf_counter


def wall_unix() -> float:
    """Wall-clock seconds since the epoch (for log-record anchors only —
    never subtract this from a :func:`now` value)."""
    return _datetime.datetime.now(_datetime.timezone.utc).timestamp()


def wall_iso() -> str:
    """ISO-8601 UTC wall timestamp for human-facing metadata."""
    return _datetime.datetime.now(_datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S%z")
