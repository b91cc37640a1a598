"""Epoch-published index snapshots: reads that stay coherent while writers
mutate the index.

The port updates its device buffers in place: ``GraphBuilder.device_graph``
copies dirty rows into the cached adjacency (``index_copy_``) and
``DEGIndex._put_rows`` writes rows of the vector buffer.  A serving flush
that searched those buffers while a writer inserted, refined or repaired
could read a half-applied edge swap.  Epochs close that window:

* writers mutate the live index under its mutation lock and call
  ``DEGIndex.publish()`` at batch boundaries; ``publish`` captures an
  immutable :class:`PublishedEpoch` (a cloned graph and vector buffer, the
  quarantine set and a medoid outside it) and swaps it in;
* readers ``acquire()`` the current epoch once a flush and search only its
  buffers, so every lane of a flush sees one graph, stamped with
  ``epoch`` and ``builder_gen``: a replay against the same epoch is
  bit-identical;
* an epoch is refcounted and retired when the last flush holding it
  releases it, never under a reader.

Readers never wait on writers and writers never wait on readers:
``acquire`` and ``release`` are a refcount under a small lock.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.obs import clock
from repro_torch.obs.metrics import EPOCH_RETIRED_LAG_MS

from .search import SearchResult


class PublishedEpoch:
    """One immutable published generation of a ``DEGIndex``.

    It has the ``search_batch`` / ``medoid`` / ``dim`` / ``device`` surface
    the serving buckets use on the index, so ``buckets.dispatch`` takes
    either.  Its tensors are clones: no later mutation of the index
    touches them."""

    __slots__ = ("epoch", "graph", "vectors", "n", "medoid_id", "metric",
                 "params", "quarantine", "builder_gen", "published_at",
                 "superseded_at", "refs", "_stores", "_lock")

    def __init__(self, *, epoch: int, graph, vectors: torch.Tensor, n: int,
                 medoid_id: int, metric: str, params, quarantine=(),
                 builder_gen: int = -1):
        self.epoch = int(epoch)
        self.graph = graph               # DEGraph of cloned tensors
        self.vectors = vectors           # cloned device vector buffer
        self.n = int(n)
        self.medoid_id = int(medoid_id)
        self.metric = metric
        self.params = params
        self.quarantine = tuple(int(q) for q in quarantine)
        self.builder_gen = int(builder_gen)
        self.published_at = clock.now()
        self.superseded_at: Optional[float] = None
        self.refs = 0                    # guarded by the owning manager
        self._stores: dict = {}          # codec -> store, built on demand
        self._lock = threading.Lock()

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def medoid(self) -> int:
        return self.medoid_id

    def store_for(self, codec: str):
        """The compressed store over this epoch's own vectors, encoded on
        first use and kept for the epoch's lifetime (the degrade ladder's
        last rung traverses sq8)."""
        from repro_torch.quant.store import make_store

        with self._lock:
            st = self._stores.get(codec)
            if st is None:
                st = make_store(self.vectors, codec, n=self.n)
                self._stores[codec] = st
        return st

    def search_batch(self, queries: np.ndarray, seed_ids=None, exclude=None,
                     *, k: int, eps: float = 0.1, beam_width=None,
                     quantized=None, rerank_k=None, expand_width=None,
                     visited_size=None, hop_backend=None,
                     hop_budget=None) -> SearchResult:
        """``DEGIndex.search_batch`` over this epoch's buffers: the same
        defaults and the same path (one ``beam_search`` launch a call on
        the card under l2)."""
        from .build import search_view

        return search_view(
            self, self.graph, self.vectors, queries, seed_ids, exclude, k=k,
            eps=eps, beam_width=beam_width, quantized=quantized,
            rerank_k=rerank_k, expand_width=expand_width,
            visited_size=visited_size, hop_backend=hop_backend,
            hop_budget=hop_budget)

    def nbytes(self) -> int:
        """Device bytes the epoch holds: its graph, its vectors and the
        stores built over them."""
        total = sum(t.numel() * t.element_size() for t in (
            self.graph.adjacency, self.graph.weights, self.vectors))
        for st in list(self._stores.values()):
            for t in (st.data, st.scale, st.codebooks):
                if t is not None:
                    total += t.numel() * t.element_size()
        return int(total)


class EpochManager:
    """The refcounted publish / acquire / release / retire state machine.

    * ``publish(ep)`` swaps the current epoch; the one it supersedes is
      retired at once if no flush holds it, else when its last reader
      releases it;
    * ``acquire()`` hands the current epoch to a flush (refcount + 1);
    * ``release(ep)`` drops a flush's reference; a superseded epoch whose
      count reaches 0 is retired (its tensors become collectable), and its
      supersede-to-retire lag goes to the ``epoch_retired_lag_ms``
      histogram of the owner's registry."""

    def __init__(self, owner=None):
        self._lock = threading.Lock()
        self._owner = owner              # DEGIndex, for its registry
        self.current: Optional[PublishedEpoch] = None
        self.live: dict[int, PublishedEpoch] = {}
        self.retired_total = 0

    @property
    def next_epoch(self) -> int:
        with self._lock:
            return 0 if self.current is None else self.current.epoch + 1

    def publish(self, ep: PublishedEpoch) -> None:
        with self._lock:
            old = self.current
            self.current = ep
            self.live[ep.epoch] = ep
            if old is not None:
                old.superseded_at = clock.now()
                if old.refs == 0:
                    self._retire_locked(old)

    def acquire(self) -> PublishedEpoch:
        with self._lock:
            ep = self.current
            if ep is None:
                raise RuntimeError("no epoch published yet")
            ep.refs += 1
            return ep

    def release(self, ep: PublishedEpoch) -> None:
        with self._lock:
            ep.refs -= 1
            if ep.refs <= 0 and ep is not self.current:
                self._retire_locked(ep)

    def live_epochs(self) -> list[int]:
        with self._lock:
            return sorted(self.live)

    def _retire_locked(self, ep: PublishedEpoch) -> None:
        if self.live.pop(ep.epoch, None) is None:
            return                       # already retired
        self.retired_total += 1
        metrics = getattr(self._owner, "metrics", None)
        if metrics is not None and ep.superseded_at is not None:
            lag_ms = (clock.now() - ep.superseded_at) * 1e3
            metrics.histogram(EPOCH_RETIRED_LAG_MS).observe(lag_ms)
