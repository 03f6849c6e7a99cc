from . import ops, ref, rwkv6

__all__ = ["ops", "ref", "rwkv6"]
