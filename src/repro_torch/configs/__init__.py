"""Architecture registry over the ported families (recsys so far):
``get_arch(name)`` resolves an ``--arch`` id.  The DEG presets live in
``configs/deg.py``."""
from __future__ import annotations

from .base import ArchSpec, ShapeCell
from .recsys_archs import DCN_V2, DEEPFM, DIN, DLRM_MLPERF

_ARCHS = {s.name: s for s in (DCN_V2, DEEPFM, DIN, DLRM_MLPERF)}


def get_arch(name: str) -> ArchSpec:
    try:
        return _ARCHS[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; available: {sorted(_ARCHS)}") from None


def list_archs() -> list[str]:
    return sorted(_ARCHS)


__all__ = ["ArchSpec", "ShapeCell", "get_arch", "list_archs"]
