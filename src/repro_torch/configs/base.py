"""Config system: one ArchSpec per assigned architecture, ported from
``src/repro/configs/base.py`` (``ShapeCell``, ``ArchSpec``, the LM,
recsys and GNN shapes).

An ArchSpec bundles the model config, the architecture family (which picks
the train/serve step implementations), the assigned input shapes, and a
``reduced()`` factory for CPU smoke tests.  ``skip`` documents assigned
cells that are inapplicable, which are reported, not silently dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) cell."""
    name: str
    kind: str           # train | prefill | decode | long_decode |
                        # full_graph | minibatch | molecule |
                        # recsys_train | recsys_serve | retrieval
    dims: dict

    def __getitem__(self, k):
        return self.dims[k]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                       # 'lm' | 'gnn' | 'recsys'
    model: Any                        # family-specific config object
    shapes: tuple                     # tuple[ShapeCell, ...]
    reduced: Callable[[], Any]        # small config for smoke tests
    skip: dict = dataclasses.field(default_factory=dict)  # shape -> reason
    notes: str = ""
    # per-shape model overrides (e.g. EGNN d_feat differs per dataset)
    shape_overrides: dict = dataclasses.field(default_factory=dict)

    def cell(self, shape_name: str) -> ShapeCell:
        for c in self.shapes:
            if c.name == shape_name:
                return c
        raise KeyError(f"{self.name} has no shape {shape_name}")

    def model_for(self, shape_name: str):
        ov = self.shape_overrides.get(shape_name)
        if not ov:
            return self.model
        return dataclasses.replace(self.model, **ov)


LM_SHAPES = (
    ShapeCell("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeCell("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeCell("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeCell("long_500k", "long_decode", dict(seq_len=524288, global_batch=1)),
)

RECSYS_SHAPES = (
    ShapeCell("train_batch", "recsys_train", dict(batch=65536)),
    ShapeCell("serve_p99", "recsys_serve", dict(batch=512)),
    ShapeCell("serve_bulk", "recsys_serve", dict(batch=262144)),
    ShapeCell("retrieval_cand", "retrieval",
              dict(batch=1, n_candidates=1_000_000)),
)

GNN_SHAPES = (
    ShapeCell("full_graph_sm", "full_graph",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)),
    ShapeCell("minibatch_lg", "minibatch",
              dict(n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
                   fanouts=(15, 10), d_feat=602, n_classes=41)),
    ShapeCell("ogb_products", "full_graph",
              dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                   n_classes=47)),
    ShapeCell("molecule", "molecule",
              dict(n_nodes=30, n_edges=64, batch=128, d_feat=16,
                   n_classes=16)),
)
