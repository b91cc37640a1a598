"""Sharded, deterministic host data pipeline, ported from
``src/repro/data/pipeline.py`` (numpy in both packages, so the batches are
byte-equal).

``ShardedPipeline`` wraps any ``batch_fn(step) -> global batch`` and

* slices each host's shard of the global batch (``host_id/num_hosts``,
  given explicitly: 0 of 1 by default, where the JAX package reads
  ``jax.process_index()``);
* prefetches ahead on a background thread;
* is deterministic in ``(seed, step)``: a restart at step k replays the
  identical stream, which is what makes checkpoint-resume exact.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.train.tree import tree_map


def host_shard(batch: Any, host_id: int, num_hosts: int) -> Any:
    """Slice the leading dim of every array leaf to this host's shard."""
    if num_hosts <= 1:
        return batch

    def slc(x):
        b = x.shape[0]
        if b % num_hosts:
            raise ValueError(f"batch {b} does not split over {num_hosts} "
                             "hosts")
        per = b // num_hosts
        return x[host_id * per: (host_id + 1) * per]

    return tree_map(slc, batch)


class ShardedPipeline:
    def __init__(self, batch_fn: Callable[[int], Any], *,
                 host_id: Optional[int] = None,
                 num_hosts: Optional[int] = None,
                 prefetch: int = 2):
        self.batch_fn = batch_fn
        self.host_id = host_id if host_id is not None else 0
        self.num_hosts = num_hosts if num_hosts is not None else 1
        self.prefetch = prefetch
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._next_step = 0

    def __call__(self, step: int) -> Any:
        """Random access (the train_loop contract)."""
        return host_shard(self.batch_fn(step), self.host_id, self.num_hosts)

    # -- streaming with prefetch -----------------------------------------
    def start(self, start_step: int = 0) -> "ShardedPipeline":
        self._next_step = start_step
        self._stop.clear()

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put((step, self(step)), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def get(self) -> tuple[int, Any]:
        return self._q.get()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def lm_synthetic_batch_fn(vocab: int, batch: int, seq: int, seed: int = 0):
    """Deterministic synthetic LM stream (markov-ish for a learnable signal)."""

    def fn(step: int) -> dict:
        rng = np.random.default_rng((seed, step))
        toks = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64)
        # plant bigram structure: with p=.5 the next token = (t*7+3) % vocab
        flip = rng.uniform(size=(batch, seq)) < 0.5
        nxt = (toks[:, :-1] * 7 + 3) % vocab
        toks[:, 1:][flip] = nxt[flip]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    return fn
