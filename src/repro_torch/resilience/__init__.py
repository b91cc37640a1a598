"""Serving and persistence resilience: typed failures (``errors.py``),
query validation at admission (``validate.py``) and deterministic fault
injection (``faults.py``), all copied from the JAX package, plus the
graceful-degradation ladder (``degrade.py``, over the port's beam
defaults).  The package imports numpy and the standard library only, so
``persist/wal.py`` and the scheduler import its fault hooks and error
types freely; the degradation ladder, which reads the beam defaults, is
imported explicitly by the async engine."""
from .errors import (EngineCrashedError, OverloadError, RequestValidationError,
                     ResilienceError)
from .faults import FaultInjected, FaultPlan, clock_skew
from .faults import active as active_faults
from .faults import clear as clear_faults
from .faults import fire as fire_fault
from .faults import install as install_faults
from .validate import validate_query

__all__ = [
    "ResilienceError", "OverloadError", "EngineCrashedError",
    "RequestValidationError", "FaultInjected", "FaultPlan", "clock_skew",
    "fire_fault", "install_faults", "clear_faults", "active_faults",
    "validate_query",
]
