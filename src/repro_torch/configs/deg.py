"""DEG hyperparameters from the paper (Table 3) keyed by dataset analogue,
the serving-side compressed-store presets, the query-engine presets and
the serving SLO presets.

The JAX package's ``hop_backend`` values map to the port's as
``"jnp"`` -> ``"composed"`` and ``"pallas"`` -> ``"fused"``; each preset
keeps its JAX name, so ``"multi-e4-fused"`` is the fused E=4 preset on
both sides."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.build import DEGParams

# paper Table 3 (d, k_ext, eps_ext, k_opt, eps_opt, i_opt)
DEG_PAPER_CONFIGS = {
    "audio": DEGParams(degree=20, k_ext=40, eps_ext=0.3, k_opt=20,
                       eps_opt=0.001, i_opt=5),
    "enron": DEGParams(degree=30, k_ext=60, eps_ext=0.3, k_opt=30,
                       eps_opt=0.001, i_opt=5),
    "sift1m": DEGParams(degree=30, k_ext=60, eps_ext=0.2, k_opt=30,
                        eps_opt=0.001, i_opt=5),
    "glove": DEGParams(degree=30, k_ext=30, eps_ext=0.2, k_opt=30,
                       eps_opt=0.001, i_opt=5),
    "bench-small": DEGParams(degree=16, k_ext=32, eps_ext=0.3, k_opt=16,
                             eps_opt=0.001, i_opt=5),
}


@dataclasses.dataclass(frozen=True)
class QuantPreset:
    """Serving-side store configuration (post-training; orthogonal to the
    build parameters).  ``codec`` is what the beam traverses, ``rerank_k``
    how many candidates the exact second stage re-scores (0 = auto 4*k,
    ignored for the exact codec), ``eps`` the beam's range slack (None =
    the engine's default)."""

    codec: str = "float32"
    rerank_k: int = 0
    eps: Optional[float] = None


# the exact baseline, the 2x half-precision store, two sq8 points trading
# rerank width for recall, and two pq points for the >= 8x tier.  pq's
# coarser per-row error distorts the beam's stopping rule, not only the
# final order, so its presets widen both knobs: eps=0.2 keeps candidates
# that exact distances would have admitted, and the wider exact second
# stage restores the order.
QUANT_PRESETS = {
    "exact": QuantPreset(),
    "fp16": QuantPreset(codec="fp16", rerank_k=20),
    "sq8-compact": QuantPreset(codec="sq8", rerank_k=20),
    "sq8-serving": QuantPreset(codec="sq8", rerank_k=40),
    "pq-compact": QuantPreset(codec="pq", rerank_k=80, eps=0.2),
    "pq-serving": QuantPreset(codec="pq", rerank_k=120, eps=0.2),
}


@dataclasses.dataclass(frozen=True)
class SearchPreset:
    """Query-engine configuration: beam entries expanded per hop
    (``expand_width``), the hop implementation (``hop_backend``), the
    per-lane visited-set size (None = auto: the beam-broadcast dedup unless
    the fused hop, which needs the filter, is selected) and the beam length
    (None = the engine heuristic)."""

    expand_width: int = 1
    hop_backend: str = "composed"
    visited_size: int | None = None
    beam_width: int | None = None


SEARCH_PRESETS = {
    "classic": SearchPreset(),
    "visited-e1": SearchPreset(expand_width=1, visited_size=1024),
    "multi-e2": SearchPreset(expand_width=2),
    "multi-e2-l64": SearchPreset(expand_width=2, beam_width=64),
    "multi-e4": SearchPreset(expand_width=4),
    "multi-e2-visited": SearchPreset(expand_width=2, visited_size=2048),
    "multi-e4-fused": SearchPreset(expand_width=4, hop_backend="fused"),
}


@dataclasses.dataclass(frozen=True)
class ServingPreset:
    """Continuous-batching scheduler configuration, as the JAX package
    keeps it for its async engine (not ported yet, ROADMAP A9); the sync
    ``serving.QueryEngine`` reads ``max_batch`` and ``bucket_floor``.

    ``max_batch`` bounds one flush; batches are padded to power-of-two
    buckets from ``bucket_floor`` up (``serving/buckets.py``).
    ``deadline_ms`` is the default per-request SLO (None = no deadline):
    a request whose deadline minus ``slack_ms`` (plus the measured flush
    latency) is near forces a flush; one whose deadline has already
    expired at dispatch is searched under ``partial_hops`` expansions and
    returned flagged partial instead of being dropped.  ``linger_ms`` is
    the max time the scheduler holds an underfull batch waiting for
    coalescing."""

    max_batch: int = 64
    bucket_floor: int = 8
    deadline_ms: float | None = 50.0
    slack_ms: float = 3.0
    linger_ms: float = 2.0
    partial_hops: int = 8
    pipeline_depth: int = 2


# SLO presets of the serving front end: interactive trades batch occupancy
# for latency, throughput the reverse; ci-quick is the deterministic smoke
# configuration
SLO_PRESETS = {
    "interactive": ServingPreset(max_batch=32, bucket_floor=4,
                                 deadline_ms=15.0, linger_ms=1.0,
                                 partial_hops=6),
    "balanced": ServingPreset(),
    "throughput": ServingPreset(max_batch=128, bucket_floor=16,
                                deadline_ms=None, linger_ms=5.0),
    "ci-quick": ServingPreset(max_batch=16, bucket_floor=4,
                              deadline_ms=500.0, linger_ms=1.0),
}
