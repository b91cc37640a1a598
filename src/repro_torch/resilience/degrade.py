"""Graceful degradation ladder: step search quality down under pressure.

The graph-ANNS trade-off space is a ladder (recall/latency pareto — see
PAPERS.md, arxiv 2101.12631), so overload has a better answer than
"queue grows" or "shed everything": serve cheaper.  Each rung is a
complete :class:`~repro_torch.serving.buckets.ProgramConfig` derived from the
engine's base config:

====  ============  ====================================================
rung  name          change vs. previous rung
====  ============  ====================================================
0     ``base``      the engine's configured search program
1     ``slim-beam``  beam width L cut to ~3/4 (cost is ~linear in L)
2     ``hop-cap``    plus a hop budget of half the default allowance
                    (``(4L+64)/2`` — bounds worst-case walk tails
                    without truncating converged searches)
3     ``sq8``       plus sq8 traversal with a minimal 2k rerank — the
                    rerank touches only 2k exact rows per query, cheap
                    insurance that holds the recall@10 >= 0.95 floor the
                    overload bench enforces (a true no-rerank rung is
                    available via ``DegradePolicy(last_rung_rerank=None)``)
====  ============  ====================================================

:class:`LadderController` owns the transitions.  It observes the
admission-queue backlog once per flush and applies hysteresis: only
``down_after`` consecutive hot observations (backlog >= ``high_frac`` of
capacity) step down one rung, and only ``up_after`` consecutive cold
observations (backlog <= ``low_frac``) step back up — a single bursty
flush never flaps the ladder.  Every transition is reported through
``on_change(old, new, direction)`` so the engine can count it in the
metrics registry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from repro_torch.core.beam import default_beam_width, default_max_hops

# NOTE: ProgramConfig (serving/buckets.py) appears only in annotations —
# importing it here would close an import cycle (serving/__init__ pulls
# async_engine, which pulls this module).  ``dataclasses.replace`` works
# on the instances without naming the class.


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """Knobs for ladder construction and the hysteresis controller."""

    high_frac: float = 0.5        # backlog fraction of capacity = "hot"
    low_frac: float = 0.125       # backlog fraction of capacity = "cold"
    down_after: int = 3           # consecutive hot flushes to step down
    up_after: int = 8             # consecutive cold flushes to step up
    beam_frac: float = 0.75       # rung-1 L multiplier
    hop_frac: float = 0.5         # rung-2 budget as fraction of the
                                  # default hop allowance (4L+64)
    last_rung_codec: str = "sq8"
    last_rung_rerank: Optional[str] = "2k"   # "2k" | None (no rerank)
    max_rung: int = 3             # truncate the ladder (0 = never degrade)


@dataclasses.dataclass(frozen=True)
class LadderRung:
    """One degradation level: a compiled-program config plus an optional
    hop budget applied to every lane dispatched at this level."""

    name: str
    cfg: ProgramConfig
    hop_budget: Optional[int] = None


def build_ladder(base: ProgramConfig, degree: int,
                 policy: DegradePolicy = DegradePolicy()
                 ) -> List[LadderRung]:
    """Derive the degradation rungs from the engine's base program."""
    rungs = [LadderRung("base", base)]
    k = base.k
    base_l = base.beam_width if base.beam_width is not None else \
        default_beam_width(k, degree, 1)
    slim_l = max(k, int(base_l * policy.beam_frac))
    slim = dataclasses.replace(base, beam_width=slim_l)
    rungs.append(LadderRung("slim-beam", slim))
    # budget off the *default allowance* (4L+64), not L itself: a beam of
    # L needs ~L/expand_width hops just to fill, so a budget of L/2 would
    # truncate typical searches — the rung is meant to bound the
    # worst-case walk tail, not the converged common case
    budget = max(8, int(default_max_hops(slim_l) * policy.hop_frac))
    rungs.append(LadderRung("hop-cap", slim, hop_budget=budget))
    if base.codec == "float32":
        rerank = 2 * k if policy.last_rung_rerank == "2k" else None
        quant = dataclasses.replace(slim, codec=policy.last_rung_codec,
                                    rerank_k=rerank)
        rungs.append(LadderRung("sq8", quant, hop_budget=budget))
    return rungs[: policy.max_rung + 1]


class LadderController:
    """Hysteresis state machine mapping backlog observations to a rung.

    Not thread-safe by design: only the scheduler loop calls
    :meth:`observe` (once per flush, just after popping the batch), and
    only the scheduler reads :attr:`level`.
    """

    def __init__(self, n_rungs: int, capacity: int,
                 policy: DegradePolicy = DegradePolicy(),
                 on_change: Optional[Callable[[int, int, str], None]] = None):
        if capacity < 1:
            raise ValueError("LadderController needs a bounded queue "
                             "(capacity >= 1) to read pressure from")
        self.policy = policy
        self.n_rungs = max(1, n_rungs)
        self.high = max(1, int(capacity * policy.high_frac))
        self.low = int(capacity * policy.low_frac)
        self.on_change = on_change
        self.level = 0
        self._hot = 0
        self._cold = 0

    def observe(self, backlog: int) -> int:
        """Feed one backlog sample; returns the rung to dispatch at."""
        if backlog >= self.high:
            self._hot += 1
            self._cold = 0
        elif backlog <= self.low:
            self._cold += 1
            self._hot = 0
        else:                        # dead band: decay both streaks
            self._hot = 0
            self._cold = 0
        if self._hot >= self.policy.down_after and \
                self.level < self.n_rungs - 1:
            self._move(self.level + 1, "down")
            self._hot = 0
        elif self._cold >= self.policy.up_after and self.level > 0:
            self._move(self.level - 1, "up")
            self._cold = 0
        return self.level

    def _move(self, new: int, direction: str) -> None:
        old, self.level = self.level, new
        if self.on_change is not None:
            self.on_change(old, new, direction)

    def reset(self) -> None:
        self.level = 0
        self._hot = self._cold = 0
