"""Navigable-Small-World baseline (Malkov et al. 2014, paper Sec. 3).

Incremental, undirected, *non-regular*: each new vertex connects to the best
``f`` search results; no edges are ever removed, so hubs form — exactly the
failure mode DEG's regularity eliminates.  To keep the dense array layout we
cap the per-vertex degree at ``max_degree`` and, when a vertex is full, its
longest edge is displaced (a mild concession; the hub statistics remain).
Rows carry ``INVALID`` slots, which the beam engine skips.  Every insert is
one single-lane search on the device against the graph so far.
"""
from __future__ import annotations

import numpy as np
import torch

from ..build import np_pair_dist
from ..graph import DEGraph, INVALID
from ..search import range_search


class NSWIndex:
    def __init__(self, dim: int, f: int = 10, max_degree: int = 48,
                 k_search: int = 40, eps: float = 0.2, metric: str = "l2",
                 capacity: int = 1024, device="cuda"):
        self.dim, self.f, self.max_degree = dim, f, max_degree
        self.k_search, self.eps, self.metric = k_search, eps, metric
        self.device = torch.device(device)
        self.vectors = np.zeros((capacity, dim), dtype=np.float32)
        self.adjacency = np.full((capacity, max_degree), INVALID, np.int32)
        self.weights = np.zeros((capacity, max_degree), np.float32)
        self.n = 0

    def frozen(self) -> DEGraph:
        """A device copy of the graph so far."""
        return DEGraph(adjacency=torch.tensor(self.adjacency,
                                              device=self.device),
                       weights=torch.tensor(self.weights, device=self.device),
                       n=self.n)

    def _dev_vectors(self) -> torch.Tensor:
        return torch.tensor(self.vectors, device=self.device)

    def _connect(self, u: int, v: int, w: float) -> None:
        for a, b in ((u, v), (v, u)):
            row = self.adjacency[a]
            if (row == b).any():
                continue
            free = np.nonzero(row == INVALID)[0]
            if free.size:
                s = free[0]
            else:
                s = int(np.argmax(self.weights[a]))     # displace longest
                old = int(row[s])
                if old != INVALID:                       # drop back-edge
                    back = np.nonzero(self.adjacency[old] == a)[0]
                    if back.size:
                        self.adjacency[old, back[0]] = INVALID
                        self.weights[old, back[0]] = 0.0
            self.adjacency[a, s] = b
            self.weights[a, s] = w

    def add(self, points: np.ndarray) -> None:
        points = np.atleast_2d(np.asarray(points, np.float32))
        for p in points:
            v = self.n
            if v >= self.vectors.shape[0]:
                raise RuntimeError("capacity exhausted")
            self.vectors[v] = p
            if v == 0:
                self.n = 1
                continue
            if v <= self.f:
                nbrs = list(range(v))
            else:
                res = range_search(
                    self.frozen(), self._dev_vectors(),
                    torch.as_tensor(p[None], device=self.device),
                    torch.zeros((1, 1), dtype=torch.int32,
                                device=self.device),
                    k=self.k_search, eps=self.eps, metric=self.metric)
                nbrs = [int(x) for x in res.ids.cpu().numpy()[0]
                        if x != INVALID][: self.f]
            ds = np_pair_dist(self.metric, p, self.vectors[nbrs])
            self.n = v + 1
            for u, w in zip(nbrs, ds):
                self._connect(v, int(u), float(w))

    def search(self, queries: np.ndarray, k: int, eps: float = 0.1,
               beam_width=None):
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                            device=self.device)
        seeds = torch.zeros((q.shape[0], 1), dtype=torch.int32,
                            device=self.device)
        return range_search(self.frozen(), self._dev_vectors(), q, seeds,
                            k=k, eps=eps, beam_width=beam_width,
                            metric=self.metric)
