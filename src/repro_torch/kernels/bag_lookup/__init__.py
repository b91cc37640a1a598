from .ops import bag_lookup
from .ref import bag_lookup_ref

__all__ = ["bag_lookup", "bag_lookup_ref"]
