"""Synthetic LM data and its sharded, prefetching loader."""
from .synthetic import SyntheticLM, make_batch_specs
from .pipeline import ShardedLoader

__all__ = ["SyntheticLM", "ShardedLoader", "make_batch_specs"]
