"""E(n)-Equivariant Graph Neural Network (Satorras et al., arXiv:2102.09844),
ported from ``src/repro/models/egnn.py``.

Message passing gathers node rows at the edges' ends and sums messages
into their destinations over an edge-index array.  Three input layouts
map to the four GNN shapes:

* :func:`egnn_forward`: one (possibly huge) graph, nodes (N, F), coords
  (N, 3), edges (2, E) of (src, dst).  Used by full_graph_sm and
  ogb_products and by the sampled minibatch_lg subgraphs
  (``data/graphs.py::subgraph_batch`` emits exactly this layout);
* :func:`egnn_forward_batched`: B small graphs (the molecule shape), run
  as one graph of ``B * N`` nodes whose edges are offset by ``b * N``: no
  edge joins two graphs, so every sum stays inside its own graph;
* :func:`make_sharded_loss`: the halo-sharded loss on ``torch.distributed``.

Parameters are the JAX package's nested dict (``encoder``, ``layers``
with each leaf stacked on a leading ``n_layers`` axis, ``decoder``) of
float32 tensors; compute casts them to ``cfg.dtype`` at each use and the
logits come back as float32.  The stacked layers run in a Python loop
where the JAX package scans them.  Float32 products run with TF32 off.
``node_shard_axes`` only constrains a sharded layout in the JAX package;
it is kept so configs cross over one to one, and does nothing here.

Every sum on the path adds in a fixed order, so that two runs on a card
give the same bits: a gather is ``t[idx]`` (advanced indexing, never
``index_select``), whose backward is ``index_put_(accumulate=True)``, and
each of a layer's three segment sums over ``dst`` (the coordinate
message, the in-degree, the node message) is that same
``index_put_(accumulate=True)`` (:func:`segment_sum`).  On a CUDA tensor
``index_put_`` with ``accumulate=True`` sorts the indices with a stable
sort and adds the values of each index in edge order, with no atomics;
``index_select``'s backward and ``index_add_`` add with atomics, in an
order that changes from run to run.  On the CPU every one adds in edge
order.  So the forward's sums and the backward of ``h[src]``, ``h[dst]``,
``x[src]`` and ``x[dst]`` are each the same on every run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.distances import _no_tf32
from repro_torch.train.tree import tree_map

from .layers import abs_p, apply_mlp_tower, dense_init, mlp_tower


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 1433          # input feature dim (dataset-dependent)
    d_edge: int = 0             # optional edge attribute dim
    n_classes: int = 40
    coord_agg: str = "mean"
    dtype: object = torch.float32
    # kept for configs that cross over from the JAX package, where it
    # constrains the node arrays' sharding; nothing on one process
    node_shard_axes: object = None


def _towers(cfg: EGNNConfig) -> dict:
    h = cfg.d_hidden
    return {"phi_e": [2 * h + 1 + cfg.d_edge, h, h],
            "phi_x": [h, h, 1],
            "phi_h": [2 * h, h, h]}


def _abs_tower(sizes, lead=()) -> dict:
    n = len(sizes) - 1
    return {f"w{i}": abs_p(*lead, sizes[i], sizes[i + 1]) for i in range(n)} \
        | {f"b{i}": abs_p(*lead, sizes[i + 1]) for i in range(n)}


def abstract_params(cfg: EGNNConfig) -> dict:
    """The parameter tree's shapes as ``meta`` tensors."""
    h = cfg.d_hidden
    return {
        "encoder": abs_p(cfg.d_feat, h),
        "layers": {name: _abs_tower(sizes, (cfg.n_layers,))
                   for name, sizes in _towers(cfg).items()},
        "decoder": _abs_tower([h, h, cfg.n_classes]),
    }


def init_params(cfg: EGNNConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters drawn from ``generator`` (on ``device``) in the
    JAX package's shapes, scales and order: each layer's ``phi_e``,
    ``phi_x`` and ``phi_h`` towers, stacked, then the encoder and the
    decoder; float32, zero biases."""
    h = cfg.d_hidden
    layers = [{name: mlp_tower(generator, sizes, device=device)
               for name, sizes in _towers(cfg).items()}
              for _ in range(cfg.n_layers)]
    stacked = {name: {k: torch.stack([lay[name][k] for lay in layers])
                      for k in layers[0][name]} for name in layers[0]}
    return {
        "encoder": dense_init(generator, (cfg.d_feat, h), device=device),
        "layers": stacked,
        "decoder": mlp_tower(generator, [h, h, cfg.n_classes],
                             device=device),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``F.silu`` in float32; in a narrower dtype the
    logistic as the JAX package's lowering computes it, ``x * (1 / (1 +
    exp(-x)))`` with every op rounded to that dtype (``F.silu`` rounds
    once, which moves a third of bfloat16 messages by an ulp)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def segment_sum(v: torch.Tensor, seg: torch.Tensor,
                n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(v, seg, num_segments=n)``: rows of ``v``
    added into ``n`` rows by ``seg`` (int64), each row's terms in edge
    order (see the module docstring)."""
    out = v.new_zeros((n,) + tuple(v.shape[1:]))
    return out.index_put_((seg,), v, accumulate=True)


def _cat_parts(parts: list) -> torch.Tensor:
    """``torch.cat(parts, -1)``, emptying ``parts`` so that only the
    result holds the memory."""
    out = torch.cat(parts, dim=-1)
    parts.clear()
    return out


def _same(t: torch.Tensor) -> torch.Tensor:
    """The one-process halo: the rows themselves, through one view node,
    so that the gathers' gradients meet before the rest of ``t``'s, as
    they do behind the sharded loss's all-gather."""
    return t.view_as(t)


def _egnn_layer(lp: dict, h, x, src, dst, seg, n_out: int, ev, cfg,
                edge_attr=None, halo: Callable = _same):
    """One layer.  ``h`` (n_out, F) and ``x`` (n_out, 3) are the rows this
    process owns, ``halo`` gives the rows the edges index (all of them),
    ``src`` / ``dst`` (E,) index those, and the sums go into ``seg`` (E,)
    of ``n_out`` rows; ``ev`` is the edges' validity in the compute dtype,
    or None."""
    h_full, x_full = halo(h), halo(x)
    rel = x_full[dst] - x_full[src]                            # (E, 3)
    d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
    feats = [h_full[dst], h_full[src], d2]
    if edge_attr is not None:
        feats.append(edge_attr.to(h.dtype))
    del h_full, x_full
    # the gathers die once concatenated, and the (E, 2F + 1) input inside
    # the tower: an ogb_products layer holds no two of them at once
    m = apply_mlp_tower(lp["phi_e"], _cat_parts(feats), act=silu,
                        final_act=silu)                        # (E, F)
    if ev is not None:
        m = m * ev[:, None]
    # coordinate update (equivariant): x_d += agg_e rel * phi_x(m)
    cw = apply_mlp_tower(lp["phi_x"], m, act=silu)           # (E, 1)
    if ev is not None:
        cw = cw * ev[:, None]
    coord_msg = segment_sum(rel * cw, seg, n_out)
    if cfg.coord_agg == "mean":
        deg = segment_sum(torch.ones_like(cw[:, 0]) if ev is None else ev,
                          seg, n_out)
        coord_msg = coord_msg / torch.clamp_min(deg[:, None], 1.0)
    x = x + coord_msg
    agg = segment_sum(m, seg, n_out)                           # (N, F)
    upd = apply_mlp_tower(lp["phi_h"], torch.cat([h, agg], dim=-1),
                          act=silu)
    return h + upd, x


def _layer(params: dict, i: int) -> dict:
    return tree_map(lambda t: t[i], params["layers"])


def _edges(edges: torch.Tensor):
    return edges[0].long(), edges[1].long()


def _valid(edge_valid, cfg: EGNNConfig):
    return None if edge_valid is None else edge_valid.to(cfg.dtype)


def _encode(params: dict, feats, coords, cfg: EGNNConfig):
    _no_tf32()
    dt = cfg.dtype
    return feats.to(dt) @ params["encoder"].to(dt), coords.to(dt)


def _layers(params, h, x, edges, cfg, edge_attr, edge_valid):
    src, dst = _edges(edges)
    ev = _valid(edge_valid, cfg)
    n = h.shape[0]
    for i in range(cfg.n_layers):
        h, x = _egnn_layer(_layer(params, i), h, x, src, dst, dst, n, ev,
                           cfg, edge_attr)
    return h, x


def egnn_forward(params: dict, feats: torch.Tensor, coords: torch.Tensor,
                 edges: torch.Tensor, cfg: EGNNConfig, edge_attr=None,
                 edge_valid=None):
    """Returns (node logits (N, n_classes) float32, final coords (N, 3))."""
    h, x = _encode(params, feats, coords, cfg)
    h, x = _layers(params, h, x, edges, cfg, edge_attr, edge_valid)
    logits = apply_mlp_tower(params["decoder"], h, act=silu)
    return logits.to(torch.float32), x


def _one_graph(feats, coords, edges, edge_valid):
    """B graphs of N nodes as one of B * N: node ids offset by ``b * N``."""
    B, N = feats.shape[:2]
    off = (torch.arange(B, device=edges.device) * N).to(edges.dtype)
    e = (edges + off[:, None, None]).permute(1, 0, 2).reshape(2, -1)
    if edge_valid is None:
        edge_valid = torch.ones(edges[:, 0].shape, dtype=torch.bool,
                                device=edges.device)
    return (feats.reshape(B * N, -1), coords.reshape(B * N, -1), e,
            edge_valid.reshape(-1))


def egnn_forward_batched(params, feats, coords, edges, cfg: EGNNConfig,
                         edge_valid=None):
    """feats (B, N, F), coords (B, N, 3), edges (B, 2, E) of per-graph
    node ids -> (logits (B, N, n_classes), coords (B, N, 3)).  A missing
    ``edge_valid`` is all valid, as the JAX package's vmap sets it."""
    B, N = feats.shape[:2]
    f, c, e, ev = _one_graph(feats, coords, edges, edge_valid)
    logits, x = egnn_forward(params, f, c, e, cfg, edge_valid=ev)
    return logits.reshape(B, N, -1), x.reshape(B, N, -1)


def _nll_terms(logits: torch.Tensor, labels: torch.Tensor, n_classes: int):
    """(sum of the masked NLL, number of labels kept): labels < 0 are
    masked out, the rest clipped into [0, n_classes) before the take."""
    labels = labels.long()
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, 0, n_classes - 1)
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.sum((lse - true) * mask), torch.sum(mask)


def loss_fn(params: dict, batch: dict, cfg: EGNNConfig):
    """Node classification cross-entropy (full-graph or sampled), or
    graph classification over mean-pooled logits when ``batch["feats"]``
    is (B, N, F)."""
    if batch["feats"].ndim == 3:
        logits, _ = egnn_forward_batched(params, batch["feats"],
                                         batch["coords"], batch["edges"], cfg,
                                         batch.get("edge_valid"))
        logits = torch.mean(logits, dim=1)       # graph-level: mean pool
    else:
        logits, _ = egnn_forward(params, batch["feats"], batch["coords"],
                                 batch["edges"], cfg,
                                 edge_valid=batch.get("edge_valid"))
    num, den = _nll_terms(logits, batch["labels"], cfg.n_classes)
    loss = num / torch.clamp_min(den, 1.0)
    return loss, {"nll": loss}


def node_embeddings(params, feats, coords, edges, cfg: EGNNConfig,
                    edge_valid=None) -> torch.Tensor:
    """Penultimate node embeddings (N, d_hidden) float32: what DEG indexes
    for molecule retrieval."""
    h, x = _encode(params, feats, coords, cfg)
    h, _ = _layers(params, h, x, edges, cfg, None, edge_valid)
    return h.to(torch.float32)


# ---------------------------------------------------------------------------
# the halo-sharded loss: dst-partitioned edges on torch.distributed
# ---------------------------------------------------------------------------
def make_sharded_loss(cfg: EGNNConfig, mesh, shard_axes) -> Callable:
    """Locality-aware distributed EGNN loss over the ranks of
    ``shard_axes`` on ``mesh``: ``loss_fn(params, batch) -> (loss,
    {"nll": loss})``, with every rank passing the same global batch
    (``feats`` (N, F), ``coords`` (N, 3), ``edges`` (2, E), ``edge_valid``
    (E,), ``labels`` (N,)) and getting the same loss.

    The data-layout contract (``data.graphs.partition_edges_by_dst``):
    rank ``s`` owns node rows ``[s*Nl, (s+1)*Nl)`` and the ``s``-th of
    the edge blocks, exactly the edges whose dst lies in its rows.  Then
    every sum is local (over ``clamp(dst - s*Nl, 0, Nl-1)``), and the only
    collective a layer makes is one all-gather of ``h`` and one of ``x``
    for the src-side halo, whose backward is a reduce-scatter.  The
    masked NLL's numerator and denominator are summed over the group with
    the cotangent passed through unchanged, and each replicated
    parameter's gradient is summed over the group once, so the gradients
    are ``loss_fn``'s, not the world size times them."""
    from repro_torch.distributed.collectives import (all_gather_rows, block,
                                                     psum_forward, replicated)
    from repro_torch.launch.mesh import lazy_groups

    groups = lazy_groups(mesh, tuple(shard_axes))

    def loss(params, batch):
        ag, = groups()

        def halo(t):
            return all_gather_rows(t, ag)

        feats, coords = block(batch["feats"], ag), block(batch["coords"], ag)
        labels = block(batch["labels"], ag)
        src, dst = _edges(block(batch["edges"], ag, 1))
        ev = _valid(block(batch["edge_valid"], ag), cfg)
        n_local = feats.shape[0]
        seg = torch.clamp(dst - ag.index * n_local, 0, n_local - 1)
        p = tree_map(lambda t: replicated(t, ag), params)
        h, x = _encode(p, feats, coords, cfg)
        for i in range(cfg.n_layers):
            h, x = _egnn_layer(_layer(p, i), h, x, src, dst, seg, n_local,
                               ev, cfg, halo=halo)
        logits = apply_mlp_tower(p["decoder"], h, act=silu).to(
            torch.float32)
        num, den = _nll_terms(logits, labels, cfg.n_classes)
        num, den = psum_forward(num, ag), psum_forward(den, ag)
        out = num / torch.clamp_min(den, 1.0)
        return out, {"nll": out}

    return loss
