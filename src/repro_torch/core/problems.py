"""The problems of the island model: trap, onemax and royal road on binary
genomes; rastrigin, sphere and CEC2010-F15 on float genomes.

Each is a :class:`Problem` whose ``evaluate(consts, pop)`` maps an
``(n, L)`` population to ``(n,)`` f32 fitness (maximised), with the same
``fused`` spec dict as the reference, so the generation kernels can fold
the fitness in. ``make_trap(impl="pallas")`` and ``make_f15(impl="pallas")``
evaluate through their kernels (the plain versions for CPU tensors); any
other impl through the plain version.

F15's constants (shift ``o``, permutation ``perm``, rotations ``M``) come
from ``jax.random`` and LAPACK's QR in the reference, which the port does
not reproduce. They are handed over as numpy arrays; the reference's
default set, ``make_f15_consts(jax.random.key(2010), 1000, 50)``, ships as
``data/f15_d1000_m50.npz`` (written by ``tests/test_torch_f15.py
--regen``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from .. import convert, rand
from .._device import resolve_device
from ..kernels.rastrigin import f15 as f15_kernel
from ..kernels.rastrigin import ref as f15_ref
from ..kernels.rastrigin.ref import rastrigin_terms
from ..kernels.trap import ref as trap_ref
from ..kernels.trap import trap as trap_kernel
from ..kernels.trap.ref import ordered_sum
from .types import GenomeSpec

F15_DEFAULT_CONSTS = Path(__file__).resolve().parent / "data" / \
    "f15_d1000_m50.npz"


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
        """(..., n, L) random genomes from a key of shape (..., 2): fair
        bits, or f32 uniform in the genome's bounds."""
        g = self.genome
        if g.kind == "binary":
            return rand.keyed_bernoulli(key, 0.5, (n, g.length)).to(
                torch.int8)
        return rand.keyed_uniform(key, (n, g.length), g.low, g.high)


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


def rastrigin_fitness_ref(consts, pop: torch.Tensor) -> torch.Tensor:
    """Minus the separable Rastrigin sum, in the grouped f32 order."""
    return -ordered_sum(rastrigin_terms(pop))


def make_rastrigin(dim: int = 20, bound: float = 5.12) -> Problem:
    return Problem(
        name=f"rastrigin{dim}",
        genome=GenomeSpec("float", dim, -bound, bound),
        evaluate=rastrigin_fitness_ref,
        consts=None,
        optimum=0.0,
        fused={"eval": "rastrigin"},
    )


def sphere_fitness_ref(consts, pop: torch.Tensor) -> torch.Tensor:
    return -ordered_sum(pop * pop)


def make_sphere(dim: int = 30, bound: float = 5.12) -> Problem:
    return Problem(
        name=f"sphere{dim}",
        genome=GenomeSpec("float", dim, -bound, bound),
        evaluate=sphere_fitness_ref,
        consts=None,
        optimum=0.0,
        fused={"eval": "sphere"},
    )


def default_f15_consts() -> Dict[str, np.ndarray]:
    """The reference's default F15 constants (D = 1000, m = 50) as numpy
    arrays."""
    with np.load(F15_DEFAULT_CONSTS) as data:
        return {k: data[k] for k in ("o", "perm", "M")}


def f15_fitness_ref(consts: Dict[str, torch.Tensor],
                    pop: torch.Tensor) -> torch.Tensor:
    return -f15_ref.f15(consts, pop)


def f15_fitness_kernel(consts: Dict[str, torch.Tensor],
                       pop: torch.Tensor) -> torch.Tensor:
    return -f15_kernel.f15(consts, pop)


def make_f15(consts: Optional[Mapping[str, Any]] = None, dim: int = 1000,
             group: int = 50, impl: str = "jnp",
             shared_rotation: bool = False, *, device=None) -> Problem:
    """CEC2010-F15, D/m-group shifted and m-rotated Rastrigin, maximised
    as -F15. ``consts`` are the reference's ``o``, ``perm`` and ``M`` as
    numpy arrays (``M`` may hold one matrix under ``shared_rotation``);
    without them only the shipped default (D = 1000, m = 50, one rotation
    per group) is available. The constants live on ``device``: the card
    unless the caller says otherwise."""
    if dim % group:
        raise ValueError("dim must be divisible by group size")
    if consts is None:
        if (dim, group, shared_rotation) != (1000, 50, False):
            raise ValueError(
                f"no F15 constants for dim={dim}, group={group}, "
                f"shared_rotation={shared_rotation}: the port does not "
                "rebuild the reference's jax.random and QR constants; hand "
                "them over with consts={'o', 'perm', 'M'} as numpy arrays")
        consts = default_f15_consts()
    n_groups = dim // group
    arrays = dict(consts)
    if shared_rotation:
        arrays["M"] = np.broadcast_to(np.asarray(arrays["M"])[:1],
                                      (n_groups, group, group))
    tensors = convert.f15_consts_from_numpy(arrays, resolve_device(device))
    if tuple(tensors["M"].shape) != (n_groups, group, group) \
            or tuple(tensors["o"].shape) != (dim,) \
            or tuple(tensors["perm"].shape) != (dim,):
        raise ValueError(f"F15 consts do not fit dim={dim}, group={group}")
    return Problem(
        name=f"f15_d{dim}m{group}",
        genome=GenomeSpec("float", dim, -5.0, 5.0),
        evaluate=f15_fitness_kernel if impl == "pallas" else f15_fitness_ref,
        consts=tensors,
        optimum=0.0,
        fused={"eval": "f15", "m": int(group), "n_groups": int(n_groups)},
    )


_REGISTRY: Dict[str, Callable[..., Problem]] = {
    "trap": make_trap,
    "onemax": make_onemax,
    "royal_road": make_royal_road,
    "rastrigin": make_rastrigin,
    "f15": make_f15,
    "sphere": make_sphere,
}


def make_problem(name: str, **kwargs) -> Problem:
    if name not in _REGISTRY:
        raise KeyError(f"unknown problem {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
