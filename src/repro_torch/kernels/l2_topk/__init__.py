from .ops import l2_topk
from .ref import l2_topk_ref

__all__ = ["l2_topk", "l2_topk_ref"]
