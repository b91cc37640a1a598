"""Graph containers for the Dynamic Exploration Graph.

Two layers, as in the JAX package:

* :class:`DEGraph` — the device-side even-regular graph: one dense
  ``(capacity, d) int32`` adjacency tensor plus a matching ``float32``
  weight tensor.  Every search hop is a fixed-shape gather.
* :class:`GraphBuilder` — the mutable host-side (numpy) twin used by the
  incremental construction (Alg. 3).  The numpy rows are the source of
  truth.

Buffer ownership: the builder owns a device cache of both buffers.  Every
mutator records the touched rows, and :meth:`GraphBuilder.device_graph`
re-syncs the cache by copying only the dirty rows in place
(``index_copy_``), so per-wave sync cost is O(rows touched).  Because the
copy is in place, a :class:`DEGraph` from ``device_graph()`` sees the rows
of every later sync: hold no twin across a sync, or take ``freeze()``.

Every host write also advances a mutation generation
(:attr:`GraphBuilder.generation`): equal generations imply equal content.
Epoch publishing (``core/epoch.py``) stamps it on each published snapshot.
Where the JAX package deletes a dropped cache's buffers, so that a stale
twin raises on use, torch has no such call: :meth:`GraphBuilder._drop_cache`
drops the references, and a twin still held keeps its tensors.

Slots that are transiently unused hold ``INVALID`` (= -1).  A valid DEG has
no ``INVALID`` entries among its first ``n`` rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

INVALID = -1

# a full re-upload beats the row copy once more than capacity / this
# fraction of the rows are dirty
_FULL_SYNC_FRACTION = 4


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Round up to a power of two (>= floor)."""
    p = floor
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class DEGraph:
    """Device-side even-regular graph."""

    adjacency: torch.Tensor       # (capacity, d) int32, INVALID-padded
    weights: torch.Tensor         # (capacity, d) float32
    n: int                        # number of active vertices

    @property
    def capacity(self) -> int:
        return self.adjacency.shape[0]

    @property
    def degree(self) -> int:
        return self.adjacency.shape[1]

    @property
    def device(self) -> torch.device:
        return self.adjacency.device

    def to_builder(self) -> "GraphBuilder":
        b = GraphBuilder.__new__(GraphBuilder)
        b.adjacency = self.adjacency.cpu().numpy().copy()
        b.weights = self.weights.cpu().numpy().copy()
        b.n = int(self.n)
        b.device = self.device
        b._init_device_state()
        return b


class GraphBuilder:
    """Mutable host-side graph for construction."""

    def __init__(self, capacity: int, degree: int, device="cuda"):
        if degree < 4 or degree % 2 != 0:
            raise ValueError(f"DEG degree must be even and >= 4, got {degree}")
        if capacity < degree + 1:
            raise ValueError("capacity must be at least degree + 1")
        self.adjacency = np.full((capacity, degree), INVALID, dtype=np.int32)
        self.weights = np.zeros((capacity, degree), dtype=np.float32)
        self.n = 0
        self.device = torch.device(device)
        self._init_device_state()

    def _init_device_state(self) -> None:
        self._dev_adj = None          # device cache of adjacency/weights
        self._dev_w = None
        self._dirty: set[int] = set() # host rows ahead of the device cache
        # mutation generation: advanced by every host write (bulk loads and
        # capacity growth too), stamped on each published epoch
        self._gen = 0
        self._dev_sync_gen = -1       # generation the device cache matches

    # -- basic accessors -------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.adjacency.shape[0]

    @property
    def degree(self) -> int:
        return self.adjacency.shape[1]

    def neighbors(self, v: int) -> np.ndarray:
        row = self.adjacency[v]
        return row[row != INVALID]

    def neighbor_weights(self, v: int) -> np.ndarray:
        row = self.adjacency[v]
        return self.weights[v][row != INVALID]

    def vertex_degree(self, v: int) -> int:
        return int((self.adjacency[v] != INVALID).sum())

    @property
    def generation(self) -> int:
        """Monotonic mutation counter of the host graph; equal generations
        imply equal content under the index's mutation lock."""
        return self._gen

    def device_generation(self) -> int:
        """The generation the device cache matches, or -1 when there is no
        cache or it has dirty rows: ``device_generation() == generation``
        iff ``device_graph()`` right now would copy nothing."""
        if self._dev_adj is None:
            return -1
        return self._dev_sync_gen if not self._dirty else -1

    def edge_slot(self, u: int, v: int) -> int:
        """Slot of ``v`` in ``u``'s row, or -1."""
        row = self.adjacency[u]
        s = int(np.argmax(row == v))
        return s if row[s] == v else -1

    def has_edge(self, u: int, v: int) -> bool:
        return self.edge_slot(u, v) >= 0

    def edge_weight(self, u: int, v: int) -> float:
        s = self.edge_slot(u, v)
        if s < 0:
            raise KeyError(f"no edge ({u}, {v})")
        return float(self.weights[u, s])

    # -- device sync -----------------------------------------------------
    def mark_dirty(self, *rows: int) -> None:
        """Record host-side row writes for the next ``device_graph()``.
        Mutators call this themselves; a caller that writes ``adjacency``
        or ``weights`` directly must too."""
        self._gen += 1
        if self._dev_adj is not None:
            self._dirty.update(int(r) for r in rows)

    def invalidate_device(self) -> None:
        """Drop the device cache entirely (bulk host rewrites)."""
        self._gen += 1
        self._drop_cache()
        self._dirty = set()

    def _drop_cache(self) -> None:
        """Release the cached device buffers.  A ``device_graph()`` twin
        still held keeps its own references (torch cannot delete a tensor
        under its holder); holders that must outlive a sync use
        ``freeze()``."""
        self._dev_adj = self._dev_w = None

    def _upload(self) -> None:
        # torch.tensor copies, so a CPU twin never aliases the numpy rows
        self._dev_adj = torch.tensor(self.adjacency, device=self.device)
        self._dev_w = torch.tensor(self.weights, device=self.device)

    def device_graph(self) -> DEGraph:
        """The device twin of the current host graph.

        The first call (or one after ``invalidate_device`` / ``grow``)
        uploads the whole buffers; afterwards only the dirty rows are copied
        into the cache in place, unless at least 1/_FULL_SYNC_FRACTION of
        the rows are dirty, when one full upload is cheaper."""
        if (self._dev_adj is None
                or tuple(self._dev_adj.shape) != self.adjacency.shape):
            self._upload()
            self._dev_sync_gen = self._gen
        elif self._dirty:
            rows = np.fromiter(self._dirty, dtype=np.int64)
            if rows.size * _FULL_SYNC_FRACTION >= self.capacity:
                self._upload()
            else:
                idx = torch.from_numpy(rows).to(self.device)
                self._dev_adj.index_copy_(
                    0, idx, torch.from_numpy(self.adjacency[rows]).to(self.device))
                self._dev_w.index_copy_(
                    0, idx, torch.from_numpy(self.weights[rows]).to(self.device))
            self._dev_sync_gen = self._gen
        self._dirty = set()
        return DEGraph(adjacency=self._dev_adj, weights=self._dev_w, n=self.n)

    # -- mutation --------------------------------------------------------
    def _free_slot(self, v: int) -> int:
        s = self.edge_slot(v, INVALID)
        if s < 0:
            raise RuntimeError(f"vertex {v} already has degree {self.degree}")
        return s

    def add_edge(self, u: int, v: int, w: float) -> None:
        if u == v:
            raise ValueError(f"self loop at {u}")
        if self.has_edge(u, v):
            raise ValueError(f"duplicate edge ({u}, {v})")
        su, sv = self._free_slot(u), self._free_slot(v)
        self.adjacency[u, su] = v
        self.weights[u, su] = w
        self.adjacency[v, sv] = u
        self.weights[v, sv] = w
        self.mark_dirty(u, v)

    def remove_edge(self, u: int, v: int) -> float:
        w = None
        for a, b in ((u, v), (v, u)):
            s = self.edge_slot(a, b)
            if s < 0:
                raise KeyError(f"no edge ({a}, {b})")
            w = float(self.weights[a, s])
            self.adjacency[a, s] = INVALID
            self.weights[a, s] = 0.0
        self.mark_dirty(u, v)
        return w

    def replace_edges(self, v_rows: np.ndarray, v_slots: np.ndarray,
                      bs: np.ndarray, ns: np.ndarray, w_vb: np.ndarray,
                      w_vn: np.ndarray) -> np.ndarray:
        """Vectorized Alg. 3 edge swaps: for every pair t, the edge
        (bs[t], ns[t]) becomes (v_rows[t], bs[t]) + (v_rows[t], ns[t]),
        written into ``v_rows[t]``'s row at slots ``v_slots[t]`` and
        ``v_slots[t] + 1``.

        Contract (the device-extension apply in ``core/build.py``): the
        claimed edges are pairwise distinct, so every write lands in a
        distinct (row, slot); ``v_rows`` are fresh vertices whose target
        slots are empty.  Pairs whose edge is absent (a stale claim) are
        skipped; the returned bool mask says which pairs were applied."""
        m = len(bs)
        if m == 0:
            return np.zeros(0, dtype=bool)
        idx = np.arange(m)
        rows_b = self.adjacency[bs]
        s1 = np.argmax(rows_b == ns[:, None], axis=1)
        ok = rows_b[idx, s1] == ns
        rows_n = self.adjacency[ns]
        s2 = np.argmax(rows_n == bs[:, None], axis=1)
        ok &= rows_n[idx, s2] == bs
        bs, ns, s1, s2 = bs[ok], ns[ok], s1[ok], s2[ok]
        v_r, v_s = v_rows[ok], v_slots[ok]
        w_b, w_n = w_vb[ok], w_vn[ok]
        self.adjacency[bs, s1] = v_r
        self.weights[bs, s1] = w_b
        self.adjacency[ns, s2] = v_r
        self.weights[ns, s2] = w_n
        self.adjacency[v_r, v_s] = bs
        self.weights[v_r, v_s] = w_b
        self.adjacency[v_r, v_s + 1] = ns
        self.weights[v_r, v_s + 1] = w_n
        self.mark_dirty(*bs, *ns, *v_r)
        return ok

    def clear_vertex(self, v: int) -> None:
        """Reset one row to the empty state (deletion compaction); the row
        is marked dirty, so the next ``device_graph()`` copies it."""
        self.adjacency[v] = INVALID
        self.weights[v] = 0.0
        self.mark_dirty(v)

    def load(self, adjacency: np.ndarray, weights: np.ndarray,
             n: int) -> None:
        """Bulk-load a stored graph."""
        self.adjacency[: adjacency.shape[0]] = adjacency
        self.weights[: weights.shape[0]] = weights
        self.n = int(n)
        self.invalidate_device()

    def add_vertex(self) -> int:
        if self.n >= self.capacity:
            raise RuntimeError("capacity exhausted; grow() first")
        v = self.n
        self.n += 1
        self._gen += 1                 # n is part of the graph content
        return v

    def grow(self, new_capacity: int) -> None:
        if new_capacity <= self.capacity:
            return
        d = self.degree
        adj = np.full((new_capacity, d), INVALID, dtype=np.int32)
        w = np.zeros((new_capacity, d), dtype=np.float32)
        adj[: self.capacity] = self.adjacency
        w[: self.capacity] = self.weights
        self.adjacency, self.weights = adj, w
        self.invalidate_device()

    # -- snapshot / rollback (Alg. 4 step 6 "revert all changes") --------
    def snapshot(self, vertices) -> dict:
        """Copies of the rows of ``vertices``, for :meth:`restore`."""
        vs = sorted(set(int(v) for v in vertices))
        return {
            "vs": vs,
            "adj": self.adjacency[vs].copy(),
            "w": self.weights[vs].copy(),
        }

    def restore(self, snap: dict) -> None:
        """Write back the rows a :meth:`snapshot` copied; the rows are
        marked dirty for the next ``device_graph()``."""
        self.adjacency[snap["vs"]] = snap["adj"]
        self.weights[snap["vs"]] = snap["w"]
        self.mark_dirty(*snap["vs"])

    # -- conversion ------------------------------------------------------
    def freeze(self) -> DEGraph:
        """An independent device snapshot, safe to hold across later
        mutations."""
        g = self.device_graph()
        return DEGraph(adjacency=g.adjacency.clone(),
                       weights=g.weights.clone(), n=g.n)

    # -- stats used by Alg. 5 ----------------------------------------------
    def longest_edge_slot(self, v: int) -> int:
        row = self.adjacency[v]
        w = np.where(row != INVALID, self.weights[v], -np.inf)
        return int(np.argmax(w))

    def average_neighbor_distance(self) -> float:
        """Eq. (4) over the whole graph (active vertices only)."""
        if self.n == 0:
            return 0.0
        adj = self.adjacency[: self.n]
        w = self.weights[: self.n]
        valid = adj != INVALID
        denom = np.maximum(valid.sum(axis=1), 1)
        per_vertex = (w * valid).sum(axis=1) / denom
        return float(per_vertex.mean())


def complete_graph(vectors: np.ndarray, degree: int, capacity: int,
                   metric_name: str = "l2", device="cuda") -> GraphBuilder:
    """The smallest possible DEG_d: the complete graph K_{d+1} (Sec. 5.1).

    Edge weights come from the expanded ``metric.cross`` form, the formula
    the JAX package uses, so the bootstrap weights match it."""
    from .distances import get_metric

    metric = get_metric(metric_name)
    k = degree + 1
    if vectors.shape[0] < k:
        raise ValueError(f"need at least {k} vectors for DEG_{degree}")
    b = GraphBuilder(capacity, degree, device)
    pts = torch.as_tensor(np.ascontiguousarray(vectors[:k], np.float32),
                          device=b.device)
    dmat = metric.cross(pts, pts).cpu().numpy()
    for _ in range(k):
        b.add_vertex()
    for i in range(k):
        for j in range(i + 1, k):
            b.add_edge(i, j, float(dmat[i, j]))
    return b
