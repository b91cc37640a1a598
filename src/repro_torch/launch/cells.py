"""Cell programs, the port of ``src/repro/launch/cells.py``: one (step
function, meta-tensor arguments, placements) per (architecture x input
shape x mesh) cell.

``build_cell(arch, shape, mesh)`` returns a :class:`CellProgram` whose
``args`` are tensors on the ``meta`` device (shapes and dtypes, no
memory: the 91 GB DLRM table or the 141 B-parameter Mixtral build on any
host), whose ``in_specs`` / ``out_specs`` are ``distributed.sharding.Spec``
trees, and whose ``fn`` runs the cell on real tensors of those shapes
over a ``DeviceMesh``.  ``mesh`` may be a ``launch.mesh.AbstractMesh``
(the production ``(16, 16)`` and ``(2, 16, 16)`` shapes without their
ranks): the step factories resolve their process groups at the first
call, so a cell builds there and runs only over a ``DeviceMesh``.  JAX's
``jitted()`` and ``lower()`` have no counterpart; their role in the port
is :meth:`CellProgram.placements`, the DTensor placements of every
argument.

Shape policy, as the JAX package's: dims that must divide the mesh are
padded here the way the data pipeline pads them at run time (edge lists
to the device count with an ``edge_valid`` mask, node counts to the DP
axes, or to every axis under ``nodeshard``, recsys tables to the "model"
axis, retrieval candidates to the DP size).  The padding constants are
part of ``meta``.

Beyond the 40 assigned cells, the ``deg-ann`` pseudo-architecture runs the
paper's own technique at production scale: the sharded-DEG search step
(``distributed/index.py``) over a 16.7 M-vector index.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.collectives import (make_sharded_lookup,
                                                 sharded_brute_topk)
from repro_torch.distributed.sharding import Spec
from repro_torch.launch.mesh import axis_names, axis_size, mesh_devices
from repro_torch.launch.mesh import batch_axes as mesh_batch_axes
from repro_torch.models.layers import abs_p
from repro_torch.train import tree as T


def _pad_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


@dataclasses.dataclass
class CellProgram:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple                   # argument trees of meta tensors
    in_specs: tuple               # Spec trees, one per argument
    out_specs: Any                # Spec tree of the result
    donate: tuple = ()
    meta: dict = dataclasses.field(default_factory=dict)

    def placements(self, mesh) -> tuple:
        """Every argument's DTensor placements on ``mesh``: a tree of
        placement tuples per argument, in ``in_specs``' structure."""
        return tuple(SH.named(mesh, s) for s in self.in_specs)

    def arg_bytes(self) -> list:
        """The bytes each argument tree holds."""
        return [sum(t.numel() * t.element_size() for t in T.leaves(a))
                for a in self.args]


# ===========================================================================
# LM family
# ===========================================================================
def _lm_cfg(model, mesh, seq_shard: bool = False):
    """The config adapted to the mesh: the activation-batch axes (and
    optionally sequence parallelism), MoE dispatch groups = DP shards."""
    dp = mesh_batch_axes(mesh)
    cfg = dataclasses.replace(
        model, act_batch_axes=dp,
        act_seq_axis="model" if seq_shard else None)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe_groups=axis_size(mesh, dp), moe_shard_axes=dp,
            moe=dataclasses.replace(cfg.moe, shard_hidden=True))
    return cfg


def _lm_train(spec, cell, mesh, model, *, seq_shard=False,
              microbatches=1) -> CellProgram:
    from repro_torch.models import transformer as TT
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.steps import make_train_step

    cfg = _lm_cfg(model, mesh, seq_shard=seq_shard)
    B, S = cell["global_batch"], cell["seq_len"]
    params = TT.abstract_params(cfg)
    opt = adamw(1e-4, weight_decay=0.1)
    opt_state = opt.init(params)
    batch = {"tokens": abs_p(B, S, dtype=torch.int32),
             "labels": abs_p(B, S, dtype=torch.int32)}
    step = make_train_step(functools.partial(_lm_loss, cfg=cfg), opt,
                           microbatches=microbatches)
    pspec = SH.lm_param_specs(cfg, mesh)
    ospec = SH.opt_state_specs(pspec, opt_state)
    bspec = SH.lm_batch_specs(mesh)
    mspec = {"loss": Spec(), "nll": Spec(), "aux": Spec()}
    return CellProgram(
        arch=spec.name, shape=cell.name, kind=cell.kind, fn=step,
        args=(params, opt_state, batch),
        in_specs=(pspec, ospec, bspec),
        out_specs=((pspec, ospec), mspec),
        donate=(0, 1),
        meta={"family": "lm", "tokens": B * S, "cfg": cfg})


def _lm_loss(params, batch, *, cfg):
    from repro_torch.models import transformer as TT

    return TT.loss_fn(params, batch, cfg)


def _lm_prefill(spec, cell, mesh, model, *, seq_shard=False) -> CellProgram:
    from repro_torch.models import transformer as TT

    cfg = _lm_cfg(model, mesh, seq_shard=seq_shard)
    B, S = cell["global_batch"], cell["seq_len"]
    params = TT.abstract_params(cfg)
    tokens = abs_p(B, S, dtype=torch.int32)
    fn = functools.partial(_prefill_fn, cfg=cfg, max_len=S)
    pspec = SH.lm_param_specs(cfg, mesh)
    bspec = Spec(SH.dp_axes(mesh), None)
    cspec = SH.lm_cache_specs(cfg, mesh, B)
    return CellProgram(
        arch=spec.name, shape=cell.name, kind=cell.kind, fn=fn,
        args=(params, tokens),
        in_specs=(pspec, bspec),
        out_specs=(Spec(SH.dp_axes(mesh), None), cspec),
        meta={"family": "lm", "tokens": B * S, "cfg": cfg})


def _prefill_fn(params, tokens, *, cfg, max_len):
    from repro_torch.models import transformer as TT

    return TT.serve_prefill(params, tokens, max_len=max_len, cfg=cfg)


def _lm_decode(spec, cell, mesh, model, *, seq_shard=False) -> CellProgram:
    from repro_torch.models import transformer as TT

    cfg = _lm_cfg(model, mesh)
    B, S = cell["global_batch"], cell["seq_len"]
    dp = mesh_batch_axes(mesh)
    if B % axis_size(mesh, dp) != 0:    # long_500k: batch 1 is unshardable
        cfg = dataclasses.replace(cfg, act_batch_axes=None)
    if cfg.moe is not None and B % cfg.moe_groups != 0:
        cfg = dataclasses.replace(cfg, moe_groups=1, moe_shard_axes=None)
    params = TT.abstract_params(cfg)
    cache = TT.abstract_cache(cfg, B, S)
    token = abs_p(B, 1, dtype=torch.int32)
    fn = functools.partial(_decode_fn, cfg=cfg)
    pspec = SH.lm_param_specs(cfg, mesh)
    cspec = SH.lm_cache_specs(cfg, mesh, B)
    b = SH._maybe(B, mesh, SH.dp_axes(mesh))
    return CellProgram(
        arch=spec.name, shape=cell.name, kind=cell.kind, fn=fn,
        args=(params, cache, token),
        in_specs=(pspec, cspec, Spec(b, None)),
        out_specs=(Spec(b, None), cspec),
        donate=(1,),
        meta={"family": "lm", "tokens": B, "context": S, "cfg": cfg})


def _decode_fn(params, cache, token, *, cfg):
    from repro_torch.models import transformer as TT

    return TT.serve_decode_step(params, cache, token, cfg=cfg)


# ===========================================================================
# EGNN family
# ===========================================================================
def _egnn_train_full(spec, cell, mesh, model, *, gnn_bf16=False,
                     gnn_node_all_axes=False,
                     gnn_halo=False) -> CellProgram:
    from repro_torch.models import egnn as E
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.steps import make_train_step

    cfg = model
    if gnn_bf16:
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    if gnn_node_all_axes:
        cfg = dataclasses.replace(cfg,
                                  node_shard_axes=tuple(axis_names(mesh)))
    dev = mesh_devices(mesh)
    dp = SH.dp_axes(mesh)
    dp_n = axis_size(mesh, dp)
    if cell.kind == "minibatch":
        from repro_torch.data.graphs import subgraph_shapes

        n_nodes, n_edges = subgraph_shapes(cell["batch_nodes"],
                                           cell["fanouts"])
    else:
        n_nodes, n_edges = cell["n_nodes"], cell["n_edges"]
    n_pad = _pad_up(n_nodes, dev if gnn_node_all_axes else dp_n)
    e_pad = _pad_up(n_edges, dev)
    params = E.abstract_params(cfg)
    opt = adamw(1e-3)
    opt_state = opt.init(params)
    batch = {
        "feats": abs_p(n_pad, cfg.d_feat),
        "coords": abs_p(n_pad, 3),
        "edges": abs_p(2, e_pad, dtype=torch.int32),
        "edge_valid": abs_p(e_pad, dtype=torch.bool),
        "labels": abs_p(n_pad, dtype=torch.int32),
    }
    if gnn_halo:
        loss = E.make_sharded_loss(cfg, mesh, tuple(axis_names(mesh)))
    else:
        loss = functools.partial(_egnn_loss, cfg=cfg)
    step = make_train_step(loss, opt)
    pspec = SH.egnn_param_specs(params)
    ospec = SH.opt_state_specs(pspec, opt_state)
    edge_ax = tuple(axis_names(mesh))
    node_ax = edge_ax if gnn_node_all_axes else dp
    bspec = {
        "feats": Spec(node_ax, None), "coords": Spec(node_ax, None),
        "edges": Spec(None, edge_ax), "edge_valid": Spec(edge_ax),
        "labels": Spec(node_ax),
    }
    mspec = {"loss": Spec(), "nll": Spec()}
    return CellProgram(
        arch=spec.name, shape=cell.name, kind=cell.kind, fn=step,
        args=(params, opt_state, batch),
        in_specs=(pspec, ospec, bspec),
        out_specs=((pspec, ospec), mspec),
        donate=(0, 1),
        meta={"family": "gnn", "cfg": cfg, "n_nodes": n_nodes,
              "n_edges": n_edges, "n_nodes_pad": n_pad, "n_edges_pad": e_pad})


def _egnn_loss(params, batch, *, cfg):
    from repro_torch.models import egnn as E

    return E.loss_fn(params, batch, cfg)


def _egnn_train_molecule(spec, cell, mesh, model) -> CellProgram:
    from repro_torch.models import egnn as E
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.steps import make_train_step

    cfg = model
    B, n, e = cell["batch"], cell["n_nodes"], cell["n_edges"]
    params = E.abstract_params(cfg)
    opt = adamw(1e-3)
    opt_state = opt.init(params)
    batch = {
        "feats": abs_p(B, n, cfg.d_feat),
        "coords": abs_p(B, n, 3),
        "edges": abs_p(B, 2, e, dtype=torch.int32),
        "edge_valid": abs_p(B, e, dtype=torch.bool),
        "labels": abs_p(B, dtype=torch.int32),
    }
    step = make_train_step(functools.partial(_egnn_loss, cfg=cfg), opt)
    pspec = SH.egnn_param_specs(params)
    ospec = SH.opt_state_specs(pspec, opt_state)
    dp = SH.dp_axes(mesh)
    bspec = {"feats": Spec(dp, None, None), "coords": Spec(dp, None, None),
             "edges": Spec(dp, None, None), "edge_valid": Spec(dp, None),
             "labels": Spec(dp)}
    mspec = {"loss": Spec(), "nll": Spec()}
    return CellProgram(
        arch=spec.name, shape=cell.name, kind=cell.kind, fn=step,
        args=(params, opt_state, batch),
        in_specs=(pspec, ospec, bspec),
        out_specs=((pspec, ospec), mspec),
        donate=(0, 1),
        meta={"family": "gnn", "cfg": cfg, "batch": B})


# ===========================================================================
# RecSys family
# ===========================================================================
def _recsys_cfg(model, mesh):
    return dataclasses.replace(model, table_pad_to=axis_size(mesh, "model"))


def _recsys_batch_abs(cfg, B: int) -> dict:
    b = {"sparse": abs_p(B, cfg.n_sparse, dtype=torch.int32),
         "label": abs_p(B)}
    if cfg.n_dense:
        b["dense"] = abs_p(B, cfg.n_dense)
    if cfg.kind == "din":
        b["hist"] = abs_p(B, cfg.seq_len, dtype=torch.int32)
    return b


def _recsys_train(spec, cell, mesh, model) -> CellProgram:
    from repro_torch.launch.train import mlperf_label
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw, partitioned, sgd
    from repro_torch.train.steps import make_train_step

    cfg = _recsys_cfg(model, mesh)
    B = cell["batch"]
    params = R.abstract_params(cfg)
    # the MLPerf DLRM split: stateless SGD on the embedding tables, AdamW
    # on the dense towers
    opt = partitioned(mlperf_label, {"embed": sgd(0.05),
                                     "dense": adamw(1e-3)})
    opt_state = opt.init(params)
    batch = _recsys_batch_abs(cfg, B)
    lookup = make_sharded_lookup(mesh, table_axis="model",
                                 batch_axes=SH.dp_axes(mesh))
    step = make_train_step(functools.partial(_recsys_loss, cfg=cfg,
                                             lookup=lookup), opt)
    pspec = SH.recsys_param_specs(cfg, mesh)
    ospec = SH.opt_state_specs(pspec, opt_state)
    bspec = SH.recsys_batch_specs(cfg, mesh, B)
    mspec = {"loss": Spec(), "bce": Spec()}
    return CellProgram(
        arch=spec.name, shape=cell.name, kind=cell.kind, fn=step,
        args=(params, opt_state, batch),
        in_specs=(pspec, ospec, bspec),
        out_specs=((pspec, ospec), mspec),
        donate=(0, 1),
        meta={"family": "recsys", "cfg": cfg, "batch": B})


def _recsys_loss(params, batch, *, cfg, lookup):
    from repro_torch.models import recsys as R

    return R.loss_fn(params, batch, cfg, lookup_fn=lookup)


def _recsys_serve(spec, cell, mesh, model) -> CellProgram:
    from repro_torch.models import recsys as R

    cfg = _recsys_cfg(model, mesh)
    B = cell["batch"]
    params = R.abstract_params(cfg)
    batch = _recsys_batch_abs(cfg, B)
    del batch["label"]
    dp = SH.dp_axes(mesh)
    lookup = make_sharded_lookup(mesh, table_axis="model", batch_axes=dp)
    fn = functools.partial(_recsys_fwd, cfg=cfg, lookup=lookup)
    pspec = SH.recsys_param_specs(cfg, mesh)
    bspec = SH.recsys_batch_specs(cfg, mesh, B)
    del bspec["label"]
    return CellProgram(
        arch=spec.name, shape=cell.name, kind=cell.kind, fn=fn,
        args=(params, batch),
        in_specs=(pspec, bspec),
        out_specs=Spec(dp),
        meta={"family": "recsys", "cfg": cfg, "batch": B})


def _recsys_fwd(params, batch, *, cfg, lookup):
    from repro_torch.models import recsys as R

    return R.forward(params, batch, cfg, lookup_fn=lookup)


def _recsys_retrieval(spec, cell, mesh, model) -> CellProgram:
    from repro_torch.models import recsys as R

    cfg = _recsys_cfg(model, mesh)
    B, N = cell["batch"], cell["n_candidates"]
    dp = SH.dp_axes(mesh)
    dp_t = (dp,) if isinstance(dp, str) else dp
    N_pad = _pad_up(N, axis_size(mesh, dp_t))
    params = R.abstract_params(cfg)
    batch = _recsys_batch_abs(cfg, B)
    del batch["label"]
    cands = abs_p(N_pad, cfg.embed_dim)
    lookup = make_sharded_lookup(mesh, table_axis="model", batch_axes=None)
    scorer = sharded_brute_topk(mesh, k=100, shard_axes=dp_t,
                                batch_axes=None, metric="ip")
    fn = functools.partial(_retrieval_fn, cfg=cfg, lookup=lookup,
                           scorer=scorer)
    pspec = SH.recsys_param_specs(cfg, mesh)
    bspec = SH.recsys_batch_specs(cfg, mesh, B)
    del bspec["label"]
    bspec = T.tree_map(lambda s: Spec(*([None] * len(s))), bspec)
    return CellProgram(
        arch=spec.name, shape=cell.name, kind=cell.kind, fn=fn,
        args=(params, batch, cands),
        in_specs=(pspec, bspec, Spec(dp, None)),
        out_specs=(Spec(None, None), Spec(None, None)),
        meta={"family": "recsys", "cfg": cfg, "batch": B,
              "n_candidates": N, "n_candidates_pad": N_pad})


def _retrieval_fn(params, batch, candidates, *, cfg, lookup, scorer):
    from repro_torch.models import recsys as R

    u = R.user_embedding(params, batch, cfg, lookup_fn=lookup)
    return scorer(u, candidates)


# ===========================================================================
# DEG (the paper's technique at production scale: extra cells)
# ===========================================================================
DEG_CELLS = {
    # 16.7M vectors (2^24), dim 128, degree 30, sharded over "model".
    # est_hops: the JAX package's estimate of the search length at 1M
    # vectors a shard, for its roofline's rescaling of the search loop
    "search_16m": dict(n_total=1 << 24, dim=128, degree=30, batch=4096,
                       k=10, beam=64, kind="deg_search", est_hops=48),
    "explore_16m": dict(n_total=1 << 24, dim=128, degree=30, batch=4096,
                        k=100, beam=128, kind="deg_explore", exclude=16,
                        est_hops=130),
    "build_wave_16m": dict(n_total=1 << 24, dim=128, degree=30, batch=4096,
                           k=60, beam=90, kind="deg_search", est_hops=90),
}


def _deg_cell(shape_name: str, mesh, *, deg_bf16=False) -> CellProgram:
    from repro_torch.distributed.index import make_sharded_search

    c = DEG_CELLS[shape_name]
    S = axis_size(mesh, "model")
    Ns = c["n_total"] // S
    dp = SH.dp_axes(mesh)
    excl = c.get("exclude", 0)
    fn = make_sharded_search(mesh, k=c["k"], eps=0.1, beam_width=c["beam"],
                             batch_axes=dp, exclude_width=excl)
    vdt = torch.bfloat16 if deg_bf16 else torch.float32
    args = [
        abs_p(S, Ns, c["degree"], dtype=torch.int32),     # adjacency
        abs_p(S, Ns, c["dim"], dtype=vdt),                # vectors
        abs_p(S, dtype=torch.int32),                      # n
        abs_p(S, dtype=torch.int32),                      # seeds
        abs_p(c["batch"], c["dim"], dtype=vdt),           # queries
    ]
    in_specs = [Spec("model", None, None), Spec("model", None, None),
                Spec("model"), Spec("model"), Spec(dp, None)]
    if excl:
        args.append(abs_p(c["batch"], excl, dtype=torch.int32))
        in_specs.append(Spec(dp, None))
    return CellProgram(
        arch="deg-ann", shape=shape_name, kind=c["kind"], fn=fn,
        args=tuple(args), in_specs=tuple(in_specs),
        out_specs=(Spec(dp, None), Spec(dp, None)),
        meta={"family": "deg", **c, "n_shards": S, "n_per_shard": Ns})


# ===========================================================================
# dispatch + variants
# ===========================================================================
# Each variant is a named, orthogonal change applied on top of the baseline
# cell.
VARIANTS = {
    "": {},
    # LM: sequence parallelism (layer-boundary activations over "model")
    "seqpar": {"seq_shard": True},
    # EGNN: bf16 features / messages
    "bf16msgs": {"gnn_bf16": True},
    # EGNN: node arrays over every mesh axis instead of the DP axes only
    "nodeshard": {"gnn_node_all_axes": True},
    "bf16msgs+nodeshard": {"gnn_bf16": True, "gnn_node_all_axes": True},
    # EGNN: dst-partitioned edges and the halo loss
    # (models.egnn.make_sharded_loss)
    "halo": {"gnn_bf16": True, "gnn_node_all_axes": True, "gnn_halo": True},
    # DEG: bf16 vector payload (the beam_search kernel's bfloat16 rows)
    "bf16vecs": {"deg_bf16": True},
    # LM train: gradient accumulation over 4 microbatches
    "microbatch4": {"microbatches": 4},
    "seqpar+microbatch4": {"seq_shard": True, "microbatches": 4},
    # DEG: the JAX package's name for bf16 with top_k beam merges; the
    # same cell here
    "bf16vecs+topk": {"deg_bf16": True},
}


def build_cell(arch: str, shape: str, mesh, variant: str = "", *,
               model=None) -> CellProgram:
    """The cell ``(arch, shape)`` under ``variant`` on ``mesh``.  ``model``
    replaces the architecture's published config (its ``reduced()`` one,
    for a run on real tensors at a small width); a skipped cell raises
    :class:`SkippedCell`."""
    opts = VARIANTS[variant]
    if arch == "deg-ann":
        return _deg_cell(shape, mesh, **opts)
    spec = get_arch(arch)
    cell = spec.cell(shape)
    if shape in spec.skip:
        raise SkippedCell(spec.skip[shape])
    if spec.family == "lm":
        model = model or spec.model
        if cell.kind == "train":
            return _lm_train(spec, cell, mesh, model, **opts)
        if cell.kind == "prefill":
            return _lm_prefill(spec, cell, mesh, model, **opts)
        if cell.kind in ("decode", "long_decode"):
            return _lm_decode(spec, cell, mesh, model, **opts)
    if spec.family == "gnn":
        model = model or spec.model_for(cell.name)
        if cell.kind == "molecule":
            return _egnn_train_molecule(spec, cell, mesh, model)
        return _egnn_train_full(spec, cell, mesh, model, **opts)
    if spec.family == "recsys":
        model = model or spec.model
        if cell.kind == "recsys_train":
            return _recsys_train(spec, cell, mesh, model)
        if cell.kind == "recsys_serve":
            return _recsys_serve(spec, cell, mesh, model)
        if cell.kind == "retrieval":
            return _recsys_retrieval(spec, cell, mesh, model)
    raise ValueError(f"no cell builder for {arch}/{shape} ({cell.kind})")


class SkippedCell(Exception):
    """Raised for assigned cells documented as inapplicable (spec.skip)."""
