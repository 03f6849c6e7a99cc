"""The volunteer runtime's failure handling and elasticity."""
from .fault import FailureInjector, retry
from .elastic import grow_islands, shrink_islands
from .straggler import StragglerMonitor

__all__ = ["FailureInjector", "retry", "grow_islands", "shrink_islands",
           "StragglerMonitor"]
