from .ops import Order, bag_lookup, bag_lookup_bwd, bwd_order, table_grad
from .ref import (bag_lookup_bwd_ref, bag_lookup_ref, bwd_order_ref,
                  grad_w_ref, table_grad_ref)

__all__ = ["Order", "bag_lookup", "bag_lookup_bwd", "bag_lookup_bwd_ref",
           "bag_lookup_ref", "bwd_order", "bwd_order_ref", "grad_w_ref",
           "table_grad", "table_grad_ref"]
