"""Carry state between the JAX package and the port as numpy arrays.

:func:`graph_from_numpy` / :func:`index_from_numpy` turn a JAX
``DEGIndex``'s state (adjacency, weights, n, vectors, params) into the
port's, so both packages search the same graph; :func:`store_from_numpy`
does the same for a compressed store's codes, so both search the same
codes whatever their encoders do; :func:`sharded_from_numpy` turns a
``ShardedDEG``'s stacked arrays and per-shard indexes into the port's, so
both packages search the same sub-DEGs; :func:`recsys_model_from_numpy`
turns a recsys parameter dict into a ``RecsysModel`` with the same
weights, :func:`lm_model_from_numpy` does the same for an LM's parameter
dict (a ``TransformerModel``) and :func:`lm_cache_from_numpy` for its KV
cache, :func:`egnn_params_from_numpy` turns an EGNN parameter dict into
the port's, and :func:`opt_state_from_numpy` an optimizer state of
``repro.train.optimizer`` into the port's, so both packages take the same
train steps.  The ``*_to_numpy`` functions bring the port's tensors back, so
tests compare with ``np.testing`` and never tensor against array.
Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.beam import BeamState
from repro_torch.core.build import DEGIndex, DEGParams
from repro_torch.core.graph import DEGraph, GraphBuilder
from repro_torch.core.search import SearchResult
from repro_torch.distributed.index import ShardedDEG
from repro_torch.models.recsys import RecsysConfig, RecsysModel
from repro_torch.models.transformer import TransformerConfig, TransformerModel
from repro_torch.quant.store import VectorStore
from repro_torch.train.tree import tree_map

# the JAX package's hop_backend values -> the port's
HOP_BACKEND = {"jnp": "composed", "pallas": "fused",
               "composed": "composed", "fused": "fused"}


def graph_from_numpy(adjacency, weights, n, device="cuda") -> DEGraph:
    return DEGraph(
        adjacency=torch.tensor(np.asarray(adjacency, np.int32), device=device),
        weights=torch.tensor(np.asarray(weights, np.float32), device=device),
        n=int(n))


def params_from_dict(params: dict) -> DEGParams:
    """``DEGParams`` from a JAX ``dataclasses.asdict(DEGParams)``; fields
    the port does not have are an error, not silently dropped."""
    p = dict(params)
    if "hop_backend" in p:
        p["hop_backend"] = HOP_BACKEND[p["hop_backend"]]
    names = {f.name for f in dataclasses.fields(DEGParams)}
    unknown = sorted(set(p) - names)
    if unknown:
        raise ValueError(f"DEGParams has no field(s) {unknown}")
    return DEGParams(**p)


def index_from_numpy(vectors, adjacency, weights, n, params: dict,
                     device="cuda", quarantine=()) -> DEGIndex:
    """A port ``DEGIndex`` holding the given graph and vector rows, and the
    scrubber's ``quarantine`` set of a JAX index."""
    vectors = np.asarray(vectors, np.float32)
    adjacency = np.asarray(adjacency, np.int32)
    p = params_from_dict(params)
    idx = DEGIndex(vectors.shape[1], p, capacity=adjacency.shape[0],
                   device=device)
    idx.vectors[: vectors.shape[0]] = vectors
    idx._put_rows(vectors, 0)
    idx.builder = GraphBuilder(adjacency.shape[0], p.degree, device)
    idx.builder.load(adjacency, np.asarray(weights, np.float32), int(n))
    idx.quarantine = {int(q) for q in quarantine}
    return idx


def store_from_numpy(data, scale, codec: str, codebooks=None,
                     device="cuda") -> VectorStore:
    """A port store from a JAX ``VectorStore``'s arrays.  The JAX package
    keeps a scale of ones beside every codec; the port keeps one for sq8
    only, so any other codec's ``scale`` is dropped."""
    t = functools.partial(torch.tensor, device=device)
    return VectorStore(
        data=t(np.asarray(data)), codec=codec,
        scale=t(np.asarray(scale, np.float32)) if codec == "sq8" else None,
        codebooks=(None if codebooks is None
                   else t(np.asarray(codebooks, np.float32))))


def sharded_from_numpy(adjacency, vectors, n, seeds, params: dict,
                       shards=(), *, codec: str = "float32", codes=None,
                       scales=None, codebooks=None,
                       device="cuda") -> ShardedDEG:
    """A port ``ShardedDEG`` from a JAX one's stacked arrays and codec
    state, with ``shards`` its sub-DEGs as dicts of ``vectors``,
    ``adjacency``, ``weights`` and ``n`` (a JAX ``DEGIndex``'s
    ``vectors``, ``builder.adjacency``, ``builder.weights`` and ``n``).
    No shards gives a ``ShardedDEG`` that only searches."""
    def t(x, dtype=None):
        return None if x is None else torch.tensor(
            np.asarray(x, dtype), device=device)

    return ShardedDEG(
        shards=[index_from_numpy(params=params, device=device, **sh)
                for sh in shards],
        adjacency=t(adjacency, np.int32), vectors=t(vectors, np.float32),
        n=t(n, np.int32), seeds=t(seeds, np.int32),
        params=params_from_dict(params), codec=codec, codes=t(codes),
        scales=t(scales, np.float32), codebooks=t(codebooks, np.float32))


def sharded_to_numpy(sd: ShardedDEG) -> dict:
    """The stacked arrays, codec state and params (a dict) of a port
    ``ShardedDEG`` (``scales`` ones beside fp16 and pq, as the JAX
    package keeps them): ``sharded_from_numpy(**d)`` gives back a
    ``ShardedDEG`` that searches alike."""
    out = {name: getattr(sd, name) for name in (
        "adjacency", "vectors", "n", "seeds", "codes", "scales",
        "codebooks")}
    out = {k: None if v is None else v.cpu().numpy() for k, v in out.items()}
    out["codec"] = sd.codec
    out["params"] = dataclasses.asdict(sd.params)
    return out


def recsys_model_from_numpy(params: dict, cfg: RecsysConfig,
                            device="cuda") -> RecsysModel:
    """A ``RecsysModel`` holding the JAX package's recsys parameters
    (``init_params``' nested dict, leaves as numpy arrays) as float32
    tensors on ``device``, frozen."""
    def t(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    return RecsysModel(cfg, {
        name: ({k: t(x) for k, x in v.items()} if isinstance(v, dict)
               else t(v))
        for name, v in params.items()})


def lm_model_from_numpy(params: dict, cfg: TransformerConfig,
                        device="cuda") -> TransformerModel:
    """A ``TransformerModel`` holding the JAX package's LM parameters
    (``init_params``' nested dict with the stacked ``layers``, leaves as
    numpy arrays) as float32 tensors on ``device``, frozen."""
    def t(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    return TransformerModel(cfg, {
        name: ({k: t(x) for k, x in v.items()} if isinstance(v, dict)
               else t(v))
        for name, v in params.items()})


def lm_cache_from_numpy(cache: dict, dtype=torch.bfloat16,
                        device="cuda") -> dict:
    """A JAX LM cache (``k`` and ``v`` lists of (B, slots, Hkv, Dh)
    arrays, ``pos`` a scalar) as the port's: tensors of ``dtype`` (the
    config's; bfloat16 values pass through float32 exactly) and ``pos`` a
    host int."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device).to(dtype)

    return {"k": [t(a) for a in cache["k"]], "v": [t(a) for a in cache["v"]],
            "pos": int(np.asarray(cache["pos"]))}


def lm_cache_to_numpy(cache: dict) -> dict:
    """The port's LM cache as numpy: ``k`` and ``v`` as float32 arrays (a
    bfloat16 value exactly), ``pos`` as JAX's int32 scalar."""
    def a(x):
        return x.detach().to(torch.float32).cpu().numpy()

    return {"k": [a(x) for x in cache["k"]], "v": [a(x) for x in cache["v"]],
            "pos": np.int32(cache["pos"])}


def egnn_params_from_numpy(params: dict, device="cuda") -> dict:
    """The JAX package's EGNN parameters (``init_params``' nested dict of
    stacked layers, leaves as numpy arrays) as the port's: the same nested
    dict of float32 tensors on ``device``."""
    return tree_map(lambda v: torch.tensor(np.asarray(v, np.float32),
                                           device=device), params)


def egnn_params_to_numpy(params: dict) -> dict:
    """The port's EGNN parameters as the JAX package's nested dict of
    float32 numpy arrays."""
    return tree_map(lambda t: t.detach().to(torch.float32).cpu().numpy(),
                    params)


def opt_state_from_numpy(state, device="cuda"):
    """A JAX optimizer state (``opt.init`` / ``opt.update``'s tree with
    numpy leaves) as the port's: the same nested dicts with tensors of the
    same dtypes on ``device``; a ``None`` leaf (a leaf ``partitioned``
    masked out of this optimizer) is absent, and a dict left empty too."""
    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: walk(v) for k, v in node.items()}
            return {k: v for k, v in out.items()
                    if v is not None and not (isinstance(v, dict) and not v)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return torch.tensor(np.asarray(node), device=device)

    return walk(state)


def opt_state_to_numpy(state, like=None):
    """The port's optimizer state with numpy leaves.  With ``like`` (the
    JAX state it stands for, or any tree of that structure) the result has
    ``like``'s structure, ``None`` where ``like`` has ``None``, so that the
    JAX optimizer takes it."""
    if like is None:
        return tree_map(lambda t: t.detach().cpu().numpy(), state)

    def walk(node, ref):
        if ref is None:
            return None
        if isinstance(ref, dict):
            node = node or {}
            return {k: walk(node.get(k), v) for k, v in ref.items()}
        if isinstance(ref, (list, tuple)):
            return type(ref)(walk(node[i], v) for i, v in enumerate(ref))
        return node.detach().cpu().numpy()

    return walk(state, like)


def store_to_numpy(store: VectorStore) -> dict:
    """data, scale (ones for every codec but sq8, as the JAX package keeps
    them), codec and codebooks (None but for pq)."""
    scale = (store.scale.cpu().numpy() if store.scale is not None
             else np.ones((store.dim,), np.float32))
    return {"data": store.data.cpu().numpy(), "scale": scale,
            "codec": store.codec,
            "codebooks": (None if store.codebooks is None
                          else store.codebooks.cpu().numpy())}


def graph_to_numpy(graph: DEGraph) -> dict:
    return {"adjacency": graph.adjacency.cpu().numpy(),
            "weights": graph.weights.cpu().numpy(), "n": int(graph.n)}


def beam_state_to_numpy(state: BeamState) -> dict:
    out = {f.name: getattr(state, f.name)
           for f in dataclasses.fields(BeamState)}
    return {k: None if v is None else v.cpu().numpy() for k, v in out.items()}


def result_to_numpy(res: SearchResult) -> dict:
    out = {f.name: getattr(res, f.name)
           for f in dataclasses.fields(SearchResult)}
    return {k: None if v is None else v.cpu().numpy() for k, v in out.items()}
