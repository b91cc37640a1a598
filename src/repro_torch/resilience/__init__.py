"""Deterministic fault injection (``faults.py``, copied from the JAX
package): the hook points the WAL and the snapshot writer fire.  Numpy and
the standard library only, so ``persist/wal.py`` imports it freely."""
from .faults import FaultInjected, FaultPlan, clock_skew
from .faults import active as active_faults
from .faults import clear as clear_faults
from .faults import fire as fire_fault
from .faults import install as install_faults

__all__ = [
    "FaultInjected", "FaultPlan", "clock_skew",
    "fire_fault", "install_faults", "clear_faults", "active_faults",
]
