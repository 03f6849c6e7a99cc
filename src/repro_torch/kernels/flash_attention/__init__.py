from . import flash_attention, ops, ref

__all__ = ["flash_attention", "ops", "ref"]
