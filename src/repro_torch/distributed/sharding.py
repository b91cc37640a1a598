"""Per-architecture placement rules, the port of
``src/repro/distributed/sharding.py``.

Layout for the production mesh ``("pod",) + ("data", "model")``:

* **LM transformers**: batch over the DP axes ``("pod", "data")``;
  parameters FSDP-sharded over ``"data"`` on the d_model axis and
  tensor-parallel over ``"model"`` on heads / FFN hidden / vocab.  MoE
  experts use expert-TP: every device holds every expert but a 1/TP slice
  of each expert's hidden dim.
* **KV caches (decode)**: cache length over ``"model"`` (sequence-parallel
  decode), batch over the DP axes.
* **EGNN**: parameters replicated; edge arrays over every axis, node
  arrays over ``"data"``.
* **RecSys**: embedding-table rows over ``"model"``, dense towers
  replicated, batch over the DP axes.

A rule returns a tree of :class:`Spec` with the structure of the matching
``abstract_params`` / ``abstract_cache`` / batch / optimizer-state tree.
A ``Spec`` holds, for each tensor dim, a mesh axis name, a tuple of names
(the dim split over their product, in row-major order) or None, as JAX's
``PartitionSpec`` does.  :func:`placements` turns one into the DTensor
placements of a mesh.  The rules read only a mesh's dim names and sizes,
so they take a ``DeviceMesh`` or a ``launch.mesh.AbstractMesh`` alike.
"""
from __future__ import annotations

from typing import Any

from repro_torch.launch.mesh import axis_names, axis_size, mesh_devices
from repro_torch.train import tree as T


class Spec:
    """One tensor's placement, immutable: per dim an axis name, a tuple of
    names, or None (replicated along that dim).  ``Spec()`` is a
    scalar's.  It iterates and indexes as the tuple of its entries, and is
    not a tuple itself, so that the tree walks of ``train/tree.py`` take
    it for a leaf."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        object.__setattr__(self, "dims", tuple(
            tuple(d) if isinstance(d, list) else d for d in dims))

    def __setattr__(self, name, value):
        raise AttributeError("Spec is immutable")

    def __iter__(self):
        return iter(self.dims)

    def __len__(self) -> int:
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, Spec) and self.dims == other.dims

    def __hash__(self) -> int:
        return hash(self.dims)

    def __repr__(self) -> str:
        return f"Spec{self.dims!r}"


def dp_axes(mesh) -> Any:
    axes = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    return axes if len(axes) > 1 else axes[0]


def _divisible(n: int, mesh, axis) -> bool:
    if axis is None:
        return True
    return n % axis_size(mesh, axis) == 0


def _maybe(n: int, mesh, axis):
    """Shard along ``axis`` only if the dim divides evenly."""
    return axis if _divisible(n, mesh, axis) else None


# ---------------------------------------------------------------------------
# LM transformer
# ---------------------------------------------------------------------------
def lm_param_specs(cfg, mesh) -> dict:
    """Spec tree matching ``models.transformer.abstract_params(cfg)``."""
    D, Dh = cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.n_heads * Dh, cfg.n_kv_heads * Dh
    fsdp = "data" if "data" in axis_names(mesh) else None

    def mat(rows: int, cols: int, row_ax, col_ax):
        return Spec(None, _maybe(rows, mesh, row_ax),
                    _maybe(cols, mesh, col_ax))

    layers = {
        "attn_norm": Spec(None, None),
        "mlp_norm": Spec(None, None),
        "wq": mat(D, Hq, fsdp, "model"),
        "wk": mat(D, Hkv, fsdp, "model"),
        "wv": mat(D, Hkv, fsdp, "model"),
        "wo": mat(Hq, D, "model", fsdp),
    }
    if cfg.moe is None:
        layers |= {
            "w_gate": mat(D, cfg.d_ff, fsdp, "model"),
            "w_up": mat(D, cfg.d_ff, fsdp, "model"),
            "w_down": mat(cfg.d_ff, D, "model", fsdp),
        }
    else:
        F = cfg.moe.d_ff_expert
        layers |= {
            "router": Spec(None, _maybe(D, mesh, fsdp), None),
            "we_gate": Spec(None, None, _maybe(D, mesh, fsdp),
                            _maybe(F, mesh, "model")),
            "we_up": Spec(None, None, _maybe(D, mesh, fsdp),
                          _maybe(F, mesh, "model")),
            "we_down": Spec(None, None, _maybe(F, mesh, "model"),
                            _maybe(D, mesh, fsdp)),
        }
    p = {
        "embed": Spec(_maybe(cfg.vocab, mesh, "model"), None),
        "final_norm": Spec(None),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        p["head"] = Spec(None, _maybe(cfg.vocab, mesh, "model"))
    return p


def lm_batch_specs(mesh) -> dict:
    b = dp_axes(mesh)
    return {"tokens": Spec(b, None), "labels": Spec(b, None)}


def lm_cache_specs(cfg, mesh, batch: int) -> dict:
    """KV-cache specs matching ``transformer.abstract_cache``: cache length
    over "model" on the full-attention layers (ring caches are small),
    batch over the DP axes when it divides, else replicated."""
    b = _maybe(batch, mesh, dp_axes(mesh))
    ks, vs = [], []
    for i in range(cfg.n_layers):
        seq_ax = "model" if cfg.layer_window(i) is None else None
        ks.append(Spec(b, seq_ax, None, None))
        vs.append(Spec(b, seq_ax, None, None))
    return {"k": ks, "v": vs, "pos": Spec()}


# ---------------------------------------------------------------------------
# EGNN
# ---------------------------------------------------------------------------
def egnn_param_specs(params_tree) -> Any:
    return T.tree_map(lambda _: Spec(), params_tree)


def egnn_batch_specs(mesh, kind: str, dims: dict) -> dict:
    all_ax = tuple(axis_names(mesh))        # edges spread over every device
    if kind == "molecule":
        b = dp_axes(mesh)
        return {"feats": Spec(b, None, None), "coords": Spec(b, None, None),
                "edges": Spec(b, None, None), "labels": Spec(b, None)}
    edge_ax = all_ax if dims["n_edges"] % mesh_devices(mesh) == 0 else None
    return {
        "feats": Spec(None, None),          # node arrays replicated
        "coords": Spec(None, None),
        "edges": Spec(None, edge_ax),
        "labels": Spec(None),
    }


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------
def recsys_param_specs(cfg, mesh) -> dict:
    """Row-shard the stacked embedding table (and DeepFM's first-order
    weights) over "model"; the towers replicated."""
    from repro_torch.models import recsys as R

    def spec(path, leaf):
        if path[0] == "table":
            return Spec(_maybe(leaf.shape[0], mesh, "model"), None)
        if path[0] == "fm_w":
            return Spec(_maybe(leaf.shape[0], mesh, "model"))
        return Spec(*([None] * leaf.dim()))

    return T.map_with_path(spec, R.abstract_params(cfg))


def recsys_batch_specs(cfg, mesh, batch: int) -> dict:
    b = _maybe(batch, mesh, dp_axes(mesh))
    s = {"sparse": Spec(b, None), "label": Spec(b)}
    if cfg.n_dense:
        s["dense"] = Spec(b, None)
    if cfg.kind == "din":
        s["hist"] = Spec(b, None)
    return s


# ---------------------------------------------------------------------------
# generic helpers
# ---------------------------------------------------------------------------
def placements(mesh, spec: Spec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where the mesh dim names tensor dim d, else
    ``Replicate()``.  A tuple of axes on one dim must follow the mesh's
    dim order (DTensor splits a dim over mesh dims in that order), and a
    mesh dim may shard one tensor dim only: anything else raises
    ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_names(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"{spec}: mesh has no dim(s) {missing} "
                             f"(has {names})")
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"{spec}: axes {axes} of dim {d} are not in the "
                             f"mesh's dim order {tuple(names)}")
        for p in pos:
            if not isinstance(out[p], Replicate):
                raise ValueError(f"{spec}: mesh dim {names[p]!r} shards "
                                 "two tensor dims")
            out[p] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree) -> Any:
    """Spec tree -> tree of DTensor placement tuples (``placements``)."""
    return T.tree_map(lambda s: placements(mesh, s), spec_tree)


def _prune_to(specs, tree) -> Any:
    """The leaves of the full parameter-spec tree present in ``tree`` (a
    subtree that ``train.optimizer.partitioned`` masked: absent leaves
    are left out)."""
    spec_map = dict(T.leaves_with_path(specs))
    return T.map_with_path(lambda path, _: spec_map[path], tree)


def opt_state_specs(param_specs, opt_state_tree) -> Any:
    """Optimizer-state specs: moment leaves inherit the matching parameter
    spec; counts and scalars replicate.  Handles the adamw / sgd /
    partitioned state dicts."""

    def build(st):
        if isinstance(st, dict):
            out = {}
            for k, v in st.items():
                if k in ("mu", "nu", "mom"):
                    out[k] = _prune_to(param_specs, v)
                elif isinstance(v, dict):
                    out[k] = build(v)
                else:
                    out[k] = T.tree_map(lambda _: Spec(), v)
            return out
        return T.tree_map(lambda _: Spec(), st)

    return build(opt_state_tree)
