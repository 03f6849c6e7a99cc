"""Plain PyTorch GA generation: the version beside the CUDA kernels.

A port of ``repro.kernels.ga.common``, batched over a leading island axis
(the reference gets that axis from ``vmap``). Every random decision is a
pure function of ``(seed words, salt, counter)`` through
:mod:`repro_torch.rand`, so this version, the CUDA kernels and the
reference draw the same bits. The pipeline:

* :func:`selection_plan` - elite indices (iterative masked argmax, ties to
  the lowest index), tournament or roulette parents, two-point cuts and the
  crossover gate, as five ``(I, n)`` vectors aligned with output rows;
* :func:`child_tile_math` - crossover (two-point, uniform, or blend for
  float genomes) and mutation (bit flip, or gaussian noise and the clip to
  the bounds) of each gene, drawn with counter ``(r - elite) * L + c``;
* :func:`fused_fitness` - the optional trap / royal_road / onemax /
  rastrigin / sphere / f15 fitness of the new rows;
* :func:`generation_math` - the three composed.

Every f32 sum has a fixed order, which the kernels follow: the roulette
prefix sum is the segmented scan of :func:`prefix_sum` (left to right
inside segments of :data:`SCAN_SEGMENT` lanes, each segment's carry added
once per lane), the trap, rastrigin and sphere row sums
and the F15 group sums are
:func:`repro_torch.kernels.trap.ref.ordered_sum`, and the F15 rotation is
the left-to-right sum of :mod:`repro_torch.kernels.rastrigin.ref`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ... import rand
from ..rastrigin import ref as f15_ref
from ..rastrigin.ref import rastrigin_terms
from ..trap.ref import ordered_sum, trap_scores

NEG_INF = float("-inf")
# The roulette scan's segment: lanes summed left to right before a carry
# (plan_rows.cuh's SCAN_SEGMENT).
SCAN_SEGMENT = 64

# Draw-site stream salts: the protocol shared with the kernel and the
# reference (repro/kernels/ga/common.py).
SALT_SELECT_A = 0xA1
SALT_SELECT_B = 0xB2
SALT_CROSSOVER = 0xC3
SALT_CROSSOVER_GATE = 0xD4
SALT_MUTATE = 0xE5
SALT_MUTATE_NOISE = 0xF6


@dataclasses.dataclass(frozen=True)
class GenerationSpec:
    """Static description of one generation step (hashable)."""

    kind: str
    length: int
    elite: int
    selection: str
    tournament_k: int
    crossover: str
    crossover_rate: float
    mutation_rate: float
    mutation_sigma: float
    low: float = -5.0
    high: float = 5.0
    blend_alpha: float = 0.5
    fused_eval: Optional[Tuple[Tuple[str, Any], ...]] = None

    def __post_init__(self):
        if self.kind not in ("binary", "float"):
            raise ValueError(f"unknown genome kind {self.kind!r}")
        if self.selection not in ("tournament", "roulette"):
            raise ValueError(f"unknown selection {self.selection!r}")
        if self.crossover not in ("two_point", "uniform", "blend"):
            raise ValueError(f"unknown crossover {self.crossover!r}")
        if self.crossover == "blend" and self.kind != "float":
            raise ValueError("blend crossover requires float genome")

    @property
    def eval_spec(self) -> Optional[Dict[str, Any]]:
        return dict(self.fused_eval) if self.fused_eval is not None else None


def spec_needs_consts(spec: GenerationSpec) -> bool:
    """True when the fused eval reads array constants (f15's shift,
    permutation and rotation stack)."""
    return spec.fused_eval is not None and spec.eval_spec["eval"] == "f15"


def f15_consts(eval_spec: Dict[str, Any],
               consts: Optional[Dict[str, torch.Tensor]]
               ) -> Dict[str, torch.Tensor]:
    """The fused f15 eval's ``o``, ``perm`` and ``M``; raise when they are
    missing or ``M`` is not the spec's (n_groups, m, m)."""
    if consts is None:
        raise ValueError("fused f15 evaluation needs problem consts "
                         "(o, perm, M)")
    m = int(eval_spec["m"])
    shape = (int(eval_spec["n_groups"]), m, m)
    if tuple(consts["M"].shape) != shape:
        raise ValueError(f"f15 spec wants M of shape {shape}, consts have "
                         f"{tuple(consts['M'].shape)}")
    return consts


class SelectionPlan(NamedTuple):
    """Per-output-row decisions, each ``(I, n)`` int32. Rows [0, elite)
    carry the elite index with gate and cuts 0."""

    idx_a: torch.Tensor
    idx_b: torch.Tensor
    cut1: torch.Tensor
    cut2: torch.Tensor
    gate: torch.Tensor


def _seed_view(seed: torch.Tensor):
    """(I, 2) seed words -> k0, k1 of shape (I, 1, 1)."""
    return seed[:, 0].reshape(-1, 1, 1), seed[:, 1].reshape(-1, 1, 1)


def _tournament(k0, k1, masked: torch.Tensor, maxval: torch.Tensor,
                n_children: int, k: int, salt: int) -> torch.Tensor:
    """(I, n_children) winners of size-k tournaments (ties to the first
    candidate)."""
    n_isl = masked.shape[0]
    cand = rand.randint(k0, k1, (n_children, k), maxval, salt).long()
    cand_f = torch.gather(masked, 1, cand.reshape(n_isl, -1))
    win = cand_f.reshape(n_isl, n_children, k).argmax(-1, keepdim=True)
    return torch.gather(cand, 2, win)[..., 0]


def prefix_sum(w: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum over the last axis in the segmented order.

    Lanes fall into segments ``[64 s, 64 s + 64)`` from lane 0. ``local[j]``
    is the left-to-right f32 sum of ``w`` from its segment's first lane
    through ``j``; ``cum[j] = carry_s + local[j]`` with ``carry_0 = 0`` and
    ``carry_{s+1} = cum[64 s + 63]``: the reference's ``cb + carry`` with a
    segment of 64 in place of its block of 4096. Up to 64 lanes it is the
    left-to-right scan. For weights >= 0 the result never decreases: f32
    rounding is monotone, and a segment's first lane adds its weight to
    the previous segment's last ``cum``."""
    n = w.shape[-1]
    n_seg = -(-n // SCAN_SEGMENT)
    x = torch.nn.functional.pad(w, (0, n_seg * SCAN_SEGMENT - n))
    x = x.reshape(*w.shape[:-1], n_seg, SCAN_SEGMENT)
    local = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for j in range(SCAN_SEGMENT):
        acc = acc + x[..., j]
        local[..., j] = acc
    carry = torch.empty_like(acc)
    c = torch.zeros_like(acc[..., 0])
    for s in range(n_seg):
        carry[..., s] = c
        c = c + local[..., s, -1]
    cum = carry[..., None] + local
    return cum.reshape(*w.shape[:-1], -1)[..., :n]


def masked_fitness(fitness: torch.Tensor,
                   pop_size: torch.Tensor) -> torch.Tensor:
    """(I, n) fitness with -inf on the lanes at or past each island's
    ``pop_size``."""
    lanes = torch.arange(fitness.shape[-1], device=fitness.device)
    return torch.where(lanes < pop_size[:, None], fitness, NEG_INF)


def roulette_cdf(masked: torch.Tensor) -> torch.Tensor:
    """The (I, n) roulette CDF of masked fitness: weight ``(v - lo) +
    1e-6`` on each finite lane (``lo`` the island's smallest finite value)
    and exactly 0 elsewhere, summed in the segmented order of
    :func:`prefix_sum`."""
    valid = torch.isfinite(masked)
    finite = torch.where(valid, masked, 0.0)
    lo = torch.where(valid, masked, float("inf")).amin(-1, keepdim=True)
    return prefix_sum(torch.where(valid, finite - lo + 1e-6, 0.0))


def _roulette(k0, k1, masked: torch.Tensor, maxval: torch.Tensor,
              n_children: int, salt: int) -> torch.Tensor:
    """(I, n_children) fitness-proportional parents by inverse CDF; padded
    lanes weigh exactly 0 and the final clamp keeps draws in range."""
    cum = roulette_cdf(masked)
    u = rand.uniform(k0, k1, (n_children, 1), salt)[..., 0] * cum[:, -1:]
    idx = (cum[:, None, :] <= u[:, :, None]).sum(-1).to(torch.int32)
    return torch.minimum(idx, maxval[:, :, 0] - 1)


def selection_plan(seed: torch.Tensor, fitness: torch.Tensor,
                   pop_size: torch.Tensor, spec: GenerationSpec,
                   n: int) -> SelectionPlan:
    """All per-row randomness of one generation for every island."""
    k0, k1 = _seed_view(seed)
    dev = fitness.device
    lanes = torch.arange(n, device=dev)
    masked = masked_fitness(fitness, pop_size)
    maxval = torch.clamp(pop_size, min=1).to(torch.int64).reshape(-1, 1, 1)
    n_children = n - spec.elite
    n_isl = fitness.shape[0]

    elite_idx = []
    tmp = masked
    for _ in range(spec.elite):
        idx = tmp.argmax(-1)
        elite_idx.append(idx)
        tmp = torch.where(lanes == idx[:, None], NEG_INF, tmp)

    if spec.selection == "tournament":
        ia = _tournament(k0, k1, masked, maxval, n_children,
                         spec.tournament_k, SALT_SELECT_A)
        ib = _tournament(k0, k1, masked, maxval, n_children,
                         spec.tournament_k, SALT_SELECT_B)
    else:
        ia = _roulette(k0, k1, masked, maxval, n_children, SALT_SELECT_A)
        ib = _roulette(k0, k1, masked, maxval, n_children, SALT_SELECT_B)

    zeros = torch.zeros((n_isl, n_children), dtype=torch.int32, device=dev)
    if spec.crossover == "two_point":
        cuts = rand.randint(k0, k1, (n_children, 2), spec.length + 1,
                            SALT_CROSSOVER)
        c1, c2 = cuts.amin(-1), cuts.amax(-1)
    else:
        c1 = c2 = zeros
    gate = rand.bernoulli(k0, k1, (n_children, 1), spec.crossover_rate,
                          SALT_CROSSOVER_GATE)[..., 0].to(torch.int32)

    ez = torch.zeros((n_isl, spec.elite), dtype=torch.int32, device=dev)
    e = (torch.stack(elite_idx, -1).to(torch.int32) if spec.elite else ez)

    def cat(a, b):
        return torch.cat([a, b.to(torch.int32)], dim=1)

    return SelectionPlan(idx_a=cat(e, ia), idx_b=cat(e, ib),
                         cut1=cat(ez, c1), cut2=cat(ez, c2),
                         gate=cat(ez, gate))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return rand.const(x, torch.float32, like.device)


def child_tile_math(seed: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                    cut1: torch.Tensor, cut2: torch.Tensor,
                    gate: torch.Tensor, spec: GenerationSpec) -> torch.Tensor:
    """Crossover + mutation of the whole (I, n, L) f32 parent tiles.
    Elite rows (row < elite) pass parent A through; float child rows are
    clipped to the genome's bounds. The blend ``pa + u * (pb - pa)`` and
    the mutation ``kid + noise * sigma`` are fused multiply-adds, as XLA
    compiles them in the reference and as the kernel computes them."""
    k0, k1 = _seed_view(seed)
    n, length = pa.shape[1], pa.shape[2]
    off = (-spec.elite, 0)
    rows = torch.arange(n, device=pa.device)[:, None]
    is_child = rows >= spec.elite

    if spec.crossover == "two_point":
        pos = torch.arange(length, device=pa.device)
        inside = (pos >= cut1[..., None]) & (pos < cut2[..., None])
        kids = torch.where(inside, pb, pa)
    elif spec.crossover == "uniform":
        take = rand.bernoulli(k0, k1, (n, length), 0.5, SALT_CROSSOVER, off,
                              length)
        kids = torch.where(take, pb, pa)
    else:  # blend (float only, checked in GenerationSpec)
        a = spec.blend_alpha
        u = rand.fma(rand.uniform(k0, k1, (n, length), SALT_CROSSOVER, off,
                                  length), _f32(1.0 + 2.0 * a, pa),
                     _f32(-a, pa))
        kids = rand.fma(u, pb - pa, pa)
    kids = torch.where(gate[..., None] != 0, kids, pa)

    hits = rand.bernoulli(k0, k1, (n, length), spec.mutation_rate,
                          SALT_MUTATE, off, length) & is_child
    if spec.kind == "binary":
        return torch.where(hits, 1.0 - kids, kids)
    noise = rand.normal(k0, k1, (n, length), SALT_MUTATE_NOISE, off, length)
    kids = torch.where(hits, rand.fma(noise, _f32(spec.mutation_sigma, pa),
                                      kids), kids)
    return torch.where(is_child, torch.clamp(kids, spec.low, spec.high), kids)


def fused_fitness(popf: torch.Tensor, spec: Dict[str, Any],
                  consts: Optional[Dict[str, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Fitness of (..., n, L) f32 genes -> (..., n), maximised. ``consts``
    carries f15's ``o``, ``perm`` and ``M`` on the genes' device; the other
    evals ignore it."""
    kind = spec["eval"]
    lead = popf.shape[:-1]
    if kind == "trap":
        l = int(spec["l"])
        u = popf.reshape(*lead, -1, l).sum(-1)
        return ordered_sum(trap_scores(u, l=l, a=float(spec["a"]),
                                       b=float(spec["b"]),
                                       z=float(spec["z"])))
    if kind == "royal_road":
        r = int(spec["r"])
        u = popf.reshape(*lead, -1, r).sum(-1)
        return float(r) * (u >= r - 0.5).to(torch.float32).sum(-1)
    if kind == "onemax":
        return popf.sum(-1)
    if kind == "rastrigin":
        return -ordered_sum(rastrigin_terms(popf))
    if kind == "sphere":
        return -ordered_sum(popf * popf)
    if kind == "f15":
        return -f15_ref.f15(f15_consts(spec, consts), popf)
    raise ValueError(f"unknown fused eval {kind!r}")


def generation_math(seed: torch.Tensor, pop: torch.Tensor,
                    fitness: torch.Tensor, pop_size: torch.Tensor,
                    spec: GenerationSpec,
                    consts: Optional[Dict[str, torch.Tensor]] = None):
    """One GA generation for every island.

    seed (I, 2) words, pop (I, n, L), fitness (I, n) f32, pop_size (I,)
    int32 -> new pop (I, n, L) in ``pop.dtype``, plus the (I, n) raw fused
    fitness when ``spec.fused_eval`` is set (``consts`` for f15). Slots
    [0, elite) hold the elite of the valid lanes; lanes >= pop_size are
    computed but inert."""
    n_isl, n, length = pop.shape
    if length != spec.length:
        raise ValueError(f"population has {length} genes, spec {spec.length}")
    plan = selection_plan(seed, fitness, pop_size, spec, n)
    popf = pop.to(torch.float32)
    pa = torch.gather(popf, 1, plan.idx_a.long()[..., None].expand(-1, -1,
                                                                   length))
    pb = torch.gather(popf, 1, plan.idx_b.long()[..., None].expand(-1, -1,
                                                                   length))
    kids = child_tile_math(seed, pa, pb, plan.cut1, plan.cut2, plan.gate,
                           spec)
    new_pop = kids.to(pop.dtype)
    if spec.fused_eval is not None:
        return new_pop, fused_fitness(kids, spec.eval_spec, consts)
    return new_pop
