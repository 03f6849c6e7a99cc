"""repro-lint passes. Each module exposes ``run(project) -> [Finding]``."""
from . import donation, locks, obs, purity, registry, rng  # noqa: F401

__all__ = ["donation", "locks", "obs", "purity", "registry", "rng"]
