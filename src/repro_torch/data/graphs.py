"""Graph data, ported from ``src/repro/data/graphs.py``: CSR containers,
synthetic generators, and a real neighbor sampler (GraphSAGE-style fanout
sampling) for the ``minibatch_lg`` shape.

The generators are the JAX package's numpy code: at a seed they give the
same arrays.  The sampler takes an explicit ``torch.Generator`` and runs
on the device of its tensors, in two parts: :func:`draw_hops` makes the
draws (``randint(0, 2**30)`` of shape ``(nf, f)`` a hop) and
:func:`expand_hops` turns given draws into the subgraph, uniform with
replacement from CSR rows via ``row_ptr[v] + r % max(deg[v], 1)``;
isolated nodes fall back to self-loops.  Subgraphs have static shapes:
``B*(1+f1+f1*f2)`` nodes and ``B*(f1+f1*f2)`` child->parent edges, ready
for ``models.egnn.egnn_forward``.  ``row_ptr`` stays int64 (the JAX
package runs it as int32 with x64 off; no shape here reaches 2**31).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    row_ptr: np.ndarray      # (N+1,) int64
    col_idx: np.ndarray      # (E,) int32
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.col_idx.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr)


def random_power_law_graph(n: int, avg_degree: int, seed: int = 0,
                           alpha: float = 1.6) -> CSRGraph:
    """Synthetic power-law graph (reddit/ogb stand-in for smoke tests)."""
    rng = np.random.default_rng(seed)
    w = rng.pareto(alpha, size=n) + 1.0
    p = w / w.sum()
    n_edges = n * avg_degree
    src = rng.choice(n, size=n_edges, p=p)
    dst = rng.integers(0, n, size=n_edges)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(row_ptr[1:], src, 1)
    row_ptr = np.cumsum(row_ptr)
    return CSRGraph(row_ptr=row_ptr, col_idx=dst.astype(np.int32), n_nodes=n)


def random_geometric_graph(n: int, k: int, dim: int = 3, seed: int = 0,
                           device="cuda"):
    """kNN graph over random coordinates (cora/molecule stand-in), the
    exact neighbors taken on ``device``.  Returns (CSRGraph, coords (n,
    dim))."""
    from repro_torch.core.distances import exact_knn_batched

    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(n, dim)).astype(np.float32)
    _, ids = exact_knn_batched(coords, coords, k + 1, tile=4096,
                               device=device)
    dst = ids[:, 1:].reshape(-1).astype(np.int32)
    row_ptr = np.arange(0, n * k + 1, k, dtype=np.int64)
    return CSRGraph(row_ptr=row_ptr, col_idx=dst, n_nodes=n), coords


@dataclasses.dataclass(frozen=True)
class GraphTensors:
    """A CSR graph's arrays as tensors on one device, what the sampler
    reads: ``row_ptr`` (N+1,) int64, ``col_idx`` (E,) int32, ``deg`` (N,)
    int64."""
    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    deg: torch.Tensor
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.col_idx.shape[0])


def graph_tensors(graph: CSRGraph, device="cuda") -> GraphTensors:
    row_ptr = torch.as_tensor(graph.row_ptr, dtype=torch.int64).to(device)
    return GraphTensors(
        row_ptr=row_ptr,
        col_idx=torch.as_tensor(graph.col_idx, dtype=torch.int32).to(device),
        deg=row_ptr[1:] - row_ptr[:-1], n_nodes=graph.n_nodes)


def draw_hops(n_seeds: int, fanouts: Sequence[int],
              generator: torch.Generator, device="cuda") -> list:
    """The sampler's draws: for each hop, ``randint(0, 2**30)`` of shape
    (frontier, fanout) from ``generator``."""
    out, nf = [], n_seeds
    for f in fanouts:
        out.append(torch.randint(0, 1 << 30, (nf, f), generator=generator,
                                 device=device, dtype=torch.int64))
        nf *= f
    return out


def expand_hops(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                deg: torch.Tensor, seeds: torch.Tensor, draws: list):
    """The subgraph that ``draws`` (:func:`draw_hops`' layout) pick from
    ``seeds`` (B,): (nodes (n_sub,) int32, edges (2, n_edge) int32).

    Layout: nodes = [seeds | hop1 | hop2 | ...]; every sampled neighbor
    adds one edge (child -> parent index *within the subgraph*)."""
    dev = seeds.device
    frontier = seeds.long()
    frontier_off, total = 0, frontier.shape[0]
    nodes, edges_src, edges_dst = [frontier], [], []
    last = max(col_idx.shape[0] - 1, 0)
    for r in draws:
        nf, f = r.shape
        d = deg[frontier]
        off = r % torch.clamp_min(d, 1)[:, None]
        # an isolated node's row may start past the last edge: clamp the
        # read, whose value the self-loop replaces
        at = torch.clamp(row_ptr[frontier][:, None] + off, max=last)
        if col_idx.shape[0]:
            nbr = col_idx[at.reshape(-1)].long()
        else:
            nbr = torch.zeros(nf * f, dtype=torch.int64, device=dev)
        isolated = (d == 0)[:, None].expand(nf, f).reshape(-1)
        nbr = torch.where(isolated, frontier.repeat_interleave(f), nbr)
        edges_src.append(total + torch.arange(nf * f, device=dev))
        edges_dst.append((frontier_off + torch.arange(nf, device=dev))
                         .repeat_interleave(f))
        nodes.append(nbr)
        frontier_off = total
        total += nf * f
        frontier = nbr
    edges = torch.stack([torch.cat(edges_src), torch.cat(edges_dst)])
    return torch.cat(nodes).to(torch.int32), edges.to(torch.int32)


def sample_neighbors(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                     deg: torch.Tensor, seeds: torch.Tensor,
                     generator: torch.Generator,
                     fanouts: Sequence[int]):
    """Fanout sampling on the device of ``seeds``: (nodes (n_sub,), edges
    (2, n_edge)), :func:`expand_hops` of :func:`draw_hops`' draws."""
    draws = draw_hops(seeds.shape[0], fanouts, generator, seeds.device)
    return expand_hops(row_ptr, col_idx, deg, seeds, draws)


@functools.lru_cache(maxsize=4)
def _seed0_coords(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.normal(size=(n, 3)).astype(np.float32)


def subgraph_batch(graph, feats: torch.Tensor, labels: torch.Tensor,
                   seeds, generator: Optional[torch.Generator],
                   fanouts: Sequence[int],
                   coords: Optional[torch.Tensor] = None,
                   draws: Optional[list] = None) -> dict:
    """Assemble an EGNN-ready batch from a sampled subgraph, on the device
    of ``feats`` (N, F): ``graph`` a :class:`CSRGraph` or
    :class:`GraphTensors`, ``labels`` (N,), ``seeds`` (B,).  The draws
    come from ``generator`` unless ``draws`` gives them.  Features and
    coordinates are gathered on that device (no ``coords``: the seed-0
    normal coordinates the JAX package uses); only the seeds get labels,
    every other node -1."""
    dev = feats.device
    if isinstance(graph, CSRGraph):
        graph = graph_tensors(graph, dev)
    seeds = torch.as_tensor(seeds).to(dev).long()
    if draws is None:
        draws = draw_hops(seeds.shape[0], fanouts, generator, dev)
    nodes, edges = expand_hops(graph.row_ptr, graph.col_idx, graph.deg,
                               seeds, draws)
    at = nodes.long()
    if coords is None:
        coords = torch.from_numpy(_seed0_coords(graph.n_nodes)).to(dev)
    lab = torch.full((at.shape[0],), -1, dtype=torch.int32, device=dev)
    lab[: seeds.shape[0]] = labels[seeds].to(torch.int32)  # supervise seeds
    return {"feats": feats[at], "coords": coords[at], "edges": edges,
            "labels": lab}


def partition_edges_by_dst(edges: np.ndarray, n_nodes_pad: int,
                           n_shards: int,
                           edge_valid: np.ndarray | None = None):
    """Reorder edges so shard ``s`` holds exactly the edges whose dst lies in
    its node range [s*Nl, (s+1)*Nl) — the data-layout contract of
    ``models.egnn.make_sharded_loss``.  Per-shard blocks are padded to equal
    size with invalid self-edges.  Returns (edges (2, E_pad), valid (E_pad,)).
    """
    edges = np.asarray(edges)
    if edge_valid is None:
        edge_valid = np.ones(edges.shape[1], bool)
    Nl = n_nodes_pad // n_shards
    owner = edges[1] // Nl
    blocks = []
    max_e = 0
    for s in range(n_shards):
        sel = np.nonzero((owner == s) & edge_valid)[0]
        blocks.append(edges[:, sel])
        max_e = max(max_e, sel.size)
    out = np.zeros((2, n_shards * max_e), dtype=np.int32)
    valid = np.zeros(n_shards * max_e, bool)
    for s, blk in enumerate(blocks):
        lo = s * max_e
        out[:, lo: lo + blk.shape[1]] = blk
        # padding edges: self-loop on the shard's first node, masked out
        out[:, lo + blk.shape[1]: lo + max_e] = s * Nl
        valid[lo: lo + blk.shape[1]] = True
    return out, valid


def subgraph_shapes(batch_nodes: int, fanouts: Sequence[int]) -> tuple[int, int]:
    """Static (n_sub_nodes, n_sub_edges) for given batch/fanouts."""
    total, frontier, n_edges = batch_nodes, batch_nodes, 0
    for f in fanouts:
        n_edges += frontier * f
        frontier *= f
        total += frontier
    return total, n_edges
