"""The binary problems of the island model: trap, onemax, royal road.

Each is a :class:`Problem` whose ``evaluate(consts, pop)`` maps an
``(n, L)`` population to ``(n,)`` f32 fitness (maximised), with the same
``fused`` spec dict as the reference, so the generation kernel can fold the
fitness in. ``make_trap(impl="pallas")`` evaluates through the trap kernel
(its plain version for CPU tensors); any other impl through the plain
version. The float problems (rastrigin, F15, sphere) come with the float
slice of the port.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, Optional

import torch

from .. import rand
from ..kernels.trap import ref as trap_ref
from ..kernels.trap import trap as trap_kernel
from .types import GenomeSpec

FLOAT_TODO = ("float problems are not ported yet (ROADMAP, Queue B item 2, "
              "float half)")


@dataclasses.dataclass(frozen=True)
class Problem:
    """A fitness-maximisation problem; ``optimum`` (if known) enables
    success detection at fitness >= optimum - eps."""

    name: str
    genome: GenomeSpec
    evaluate: Callable[[Any, torch.Tensor], torch.Tensor] = \
        dataclasses.field(compare=False)
    consts: Any = dataclasses.field(default=None, compare=False)
    optimum: Optional[float] = None
    fused: Optional[Dict[str, Any]] = dataclasses.field(default=None,
                                                        compare=False)

    def init_population(self, key: torch.Tensor, n: int) -> torch.Tensor:
        """(..., n, L) random genomes from a key of shape (..., 2)."""
        if self.genome.kind != "binary":
            raise NotImplementedError(FLOAT_TODO)
        return rand.keyed_bernoulli(key, 0.5, (n, self.genome.length)).to(
            torch.int8)


def trap_fitness_ref(consts: Dict[str, float],
                     pop: torch.Tensor) -> torch.Tensor:
    """Plain trap fitness: (n, n_traps*l) -> (n,) f32."""
    l = int(consts["l"])
    return trap_ref.trap_fitness(pop, n_traps=pop.shape[-1] // l, l=l,
                                 a=float(consts["a"]), b=float(consts["b"]),
                                 z=float(consts["z"]))


def make_trap(n_traps: int = 40, l: int = 4, a: float = 1.0, b: float = 2.0,
              z: float = 3.0, impl: str = "jnp") -> Problem:
    consts = {"a": float(a), "b": float(b), "z": float(z), "l": int(l)}
    if impl == "pallas":
        evaluate = partial(trap_kernel.trap_fitness, n_traps=n_traps)
    else:
        evaluate = trap_fitness_ref
    return Problem(
        name=f"trap{n_traps}x{l}",
        genome=GenomeSpec("binary", n_traps * l),
        evaluate=evaluate,
        consts=consts,
        optimum=n_traps * b,
        fused=dict(consts, eval="trap"),
    )


def onemax_fitness_ref(consts, pop: torch.Tensor) -> torch.Tensor:
    return pop.to(torch.float32).sum(-1)


def make_onemax(length: int = 128) -> Problem:
    return Problem(
        name=f"onemax{length}",
        genome=GenomeSpec("binary", length),
        evaluate=onemax_fitness_ref,
        consts=None,
        optimum=float(length),
        fused={"eval": "onemax"},
    )


def royal_road_fitness_ref(consts: Dict[str, int],
                           pop: torch.Tensor) -> torch.Tensor:
    """R1 royal road: each fully set block of ``r`` bits scores ``r``."""
    r = consts["r"]
    u = pop.reshape(*pop.shape[:-1], -1, r).to(torch.float32).sum(-1)
    return float(r) * (u >= r - 0.5).to(torch.float32).sum(-1)


def make_royal_road(n_blocks: int = 16, r: int = 8) -> Problem:
    consts = {"r": int(r)}
    return Problem(
        name=f"royalroad{n_blocks}x{r}",
        genome=GenomeSpec("binary", n_blocks * r),
        evaluate=royal_road_fitness_ref,
        consts=consts,
        optimum=float(n_blocks * r),
        fused={"eval": "royal_road", "r": int(r)},
    )


_REGISTRY: Dict[str, Callable[..., Problem]] = {
    "trap": make_trap,
    "onemax": make_onemax,
    "royal_road": make_royal_road,
}


def make_problem(name: str, **kwargs) -> Problem:
    if name in ("rastrigin", "f15", "sphere"):
        raise NotImplementedError(f"{name}: " + FLOAT_TODO)
    if name not in _REGISTRY:
        raise KeyError(f"unknown problem {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
