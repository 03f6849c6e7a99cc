"""Operator-kernel table: ``(op, genome_kind, impl) -> callable``.

Ops, batched over a leading island axis (the reference vmaps its
per-island callables; here one call serves every island):

* ``"generation"``: ``fn(rng, pop, fitness, pop_size, cfg, genome) ->
  new_pop`` with rng (I, 2) key words, pop (I, n, L), fitness (I, n),
  pop_size (I,).
* ``"generation_eval"``: ``fn(..., genome, fused) -> (new_pop,
  raw_fitness)``, the problem's fitness fused in.

The impl names mean what they mean in the reference: ``jnp`` is the
classic path (``core.ga.next_generation_jnp``, registered by
:mod:`repro_torch.core.ga`), ``pallas`` the hand-written untiled kernel,
routed to the tiled one for large islands, ``pallas_tiled`` the tiled
kernel (both their plain version for CPU tensors) and ``pallas_ref``
always the plain version. :mod:`.ops` fills the kernel entries. Register
a custom impl with::

    @register_kernel("generation", "binary", "my_impl")
    def my_generation(rng, pop, fitness, pop_size, cfg, genome): ...

and select it with ``EAConfig(impl="my_impl")``: every driver dispatches
through this table.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

KERNELS: Dict[Tuple[str, str, str], Callable] = {}


def register_kernel(op: str, genome_kind: str, impl: str):
    """Decorator: register ``fn`` as the ``op`` kernel for ``(genome_kind,
    impl)``. Registering again overwrites (the last wins), so tests and
    other packages can shadow the built-ins."""
    def deco(fn: Callable) -> Callable:
        KERNELS[(op, genome_kind, impl)] = fn
        return fn
    return deco


def has_kernel(op: str, genome_kind: str, impl: str) -> bool:
    return (op, genome_kind, impl) in KERNELS


def get_kernel(op: str, genome_kind: str, impl: str) -> Callable:
    key = (op, genome_kind, impl)
    if key in KERNELS:
        return KERNELS[key]
    have = sorted({i for (o, g, i) in KERNELS if o == op and g == genome_kind})
    raise KeyError(f"no {op!r} kernel for genome {genome_kind!r} impl "
                   f"{impl!r}; registered impls: {have}")


def available_impls(op: str = "generation",
                    genome_kind: str = "binary") -> List[str]:
    return sorted({i for (o, g, i) in KERNELS
                   if o == op and g == genome_kind})


def registered_kernels() -> List[Tuple[str, str, str]]:
    return sorted(KERNELS)
