"""Architecture registry over the ported families (LM, GNN and recsys):
``get_arch(name)`` resolves an ``--arch`` id.  The DEG presets live in
``configs/deg.py``."""
from __future__ import annotations

from .base import ArchSpec, ShapeCell
from .gnn_archs import EGNN
from .lm_archs import (GEMMA3_12B, GRANITE_3_2B, MIXTRAL_8X22B, PHI3_MINI,
                       QWEN3_MOE)
from .recsys_archs import DCN_V2, DEEPFM, DIN, DLRM_MLPERF

_ARCHS = {
    s.name: s for s in (
        PHI3_MINI, GRANITE_3_2B, GEMMA3_12B, QWEN3_MOE, MIXTRAL_8X22B,
        EGNN, DCN_V2, DEEPFM, DIN, DLRM_MLPERF,
    )
}


def get_arch(name: str) -> ArchSpec:
    try:
        return _ARCHS[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; available: {sorted(_ARCHS)}") from None


def list_archs() -> list[str]:
    return sorted(_ARCHS)


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) cell of the ported architectures: the JAX
    registry's 40."""
    return [(name, cell.name) for name in list_archs()
            for cell in _ARCHS[name].shapes]


__all__ = ["ArchSpec", "ShapeCell", "get_arch", "list_archs", "all_cells"]
