"""EGNN architecture spec (arXiv:2102.09844): 4 layers, d_hidden 64, E(n),
ported from ``src/repro/configs/gnn_archs.py``."""
from __future__ import annotations

from repro_torch.models.egnn import EGNNConfig

from .base import ArchSpec, GNN_SHAPES

EGNN = ArchSpec(
    name="egnn", family="gnn",
    model=EGNNConfig(name="egnn", n_layers=4, d_hidden=64, d_feat=1433,
                     n_classes=7),
    shapes=GNN_SHAPES,
    reduced=lambda: EGNNConfig(name="egnn-reduced", n_layers=2, d_hidden=16,
                               d_feat=24, n_classes=5),
    shape_overrides={
        "full_graph_sm": dict(d_feat=1433, n_classes=7),
        "minibatch_lg": dict(d_feat=602, n_classes=41),
        "ogb_products": dict(d_feat=100, n_classes=47),
        "molecule": dict(d_feat=16, n_classes=16),
    },
    notes=("message passing via jax.ops.segment_sum over an edge index "
           "(assignment: GNN regime = scatter message passing); "
           "minibatch_lg uses the real fanout sampler in data/graphs.py"))
