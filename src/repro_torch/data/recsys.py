"""Criteo-like categorical click stream (synthetic, reproducible).

Generates batches matching the recsys ``forward`` input contract:
``sparse (B, F) int32`` per-field ids, ``dense (B, n_dense) float32``,
``label (B,) float32`` and (DIN) ``hist (B, S) int32`` with ragged -1
padding.  Ids follow a Zipf distribution (real CTR traffic is heavy-tailed,
which is what makes the embedding gather the hot path).  Labels come from a
planted logistic model over a low-rank embedding of the ids, so training
actually reduces the BCE loss (integration tests rely on this).
"""
from __future__ import annotations

import numpy as np


class CriteoLikeStream:
    def __init__(self, cfg, seed: int = 0, zipf_a: float = 1.3):
        self.cfg = cfg
        self.seed = seed
        self.zipf_a = zipf_a
        rng = np.random.default_rng(seed ^ 0x5EED)
        # planted model: a secret scalar weight per (field, bucket-of-64)
        self._w = {
            f: rng.normal(0, 1, size=64).astype(np.float32)
            for f in range(cfg.n_sparse)
        }
        self._wd = rng.normal(0, 0.3, size=max(cfg.n_dense, 1)
                              ).astype(np.float32)

    def _ids(self, rng, vocab: int, size) -> np.ndarray:
        """Zipf-ish ids in [0, vocab): rank = zipf sample clipped."""
        z = rng.zipf(self.zipf_a, size=size)
        return ((z - 1) % vocab).astype(np.int32)

    def batch(self, step: int, batch_size: int) -> dict:
        """Deterministic in (seed, step) — the fault-tolerance contract."""
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, step))
        out = {}
        sparse = np.stack(
            [self._ids(rng, v, batch_size) for v in cfg.vocab_sizes], axis=1)
        out["sparse"] = sparse
        logit = np.zeros(batch_size, np.float32)
        for f in range(cfg.n_sparse):
            logit += self._w[f][sparse[:, f] % 64]
        if cfg.n_dense:
            dense = rng.gamma(2.0, 2.0, size=(batch_size, cfg.n_dense)
                              ).astype(np.float32)
            out["dense"] = dense
            logit += np.log1p(dense) @ self._wd[: cfg.n_dense]
        if cfg.kind == "din":
            S = cfg.seq_len
            hist = self._ids(rng, cfg.vocab_sizes[cfg.item_field],
                             (batch_size, S))
            lengths = rng.integers(1, S + 1, size=batch_size)
            mask = np.arange(S)[None, :] >= lengths[:, None]
            hist[mask] = -1
            out["hist"] = hist
        p = 1.0 / (1.0 + np.exp(-(logit - logit.mean())))
        out["label"] = (rng.uniform(size=batch_size) < p).astype(np.float32)
        return out

    def batches(self, batch_size: int, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch(step, batch_size)
            step += 1
