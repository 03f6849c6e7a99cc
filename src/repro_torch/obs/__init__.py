"""Observability of the port: the on-device counter ledger."""
from .counters import AGE_BINS, ObsCounters, harvest, init_obs

__all__ = ["AGE_BINS", "ObsCounters", "harvest", "init_obs"]
