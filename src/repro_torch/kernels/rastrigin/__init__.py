from . import f15, ref

__all__ = ["f15", "ref"]
