from . import ref, trap

__all__ = ["ref", "trap"]
