from .ops import bag_lookup, bag_lookup_bwd
from .ref import bag_lookup_bwd_ref, bag_lookup_ref

__all__ = ["bag_lookup", "bag_lookup_bwd", "bag_lookup_bwd_ref",
           "bag_lookup_ref"]
