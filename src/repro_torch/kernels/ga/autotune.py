"""Rows-per-block autotune for the tiled generation kernel.

After ``repro/kernels/ga/autotune.py``, whose API it keeps
(:func:`best_tiles`, :func:`load_cache`, :func:`save_cache`,
:func:`cache_summary`, :data:`CANDIDATES`). The CUDA kernel
(``csrc/generation_tiled.cu``) covers whole rows and does not tile genes,
so its one knob is the number of output rows a block takes, and
:func:`best_tiles` returns ``(rows, L)``:

* on the card, a timed sweep of :data:`CANDIDATES` on synthetic data of
  the caller's shape, island count and spec (the fused eval decides how
  many threads sum each row) picks the fastest: CUDA events around
  back-to-back launches of the child kernel alone, after a warm-up call,
  with the card held busy while the host enqueues them, so that the
  events time the kernel and not the host's launch rate;
* on the CPU, where the wrapper runs the plain version and no time means
  anything, a heuristic picks the smallest candidate that gives each of the
  block's threads at least four genes.

The result is the same bits for every candidate (the kernel is
tiling-invariant), so the sweep changes only speed. The sweep launches the
kernels through :func:`.tiling.launch_plan` and :func:`.tiling.launch_child`,
so it adds nothing to ``LAUNCHES``. Results are cached as JSON under
``build/repro_torch/autotune_ga.json`` at the root of the checkout, keyed on
the card's name (``torch.cuda.get_device_name()``, or ``"cpu"``) and then
on the genome kind, island count, shape, crossover and fused eval. Each
entry records the kernel library it was swept with (the hash in
:func:`.._build.library_path`): an entry of other sources is swept again.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ... import _build

# rows per block of the tiled kernel
CANDIDATES: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
THREADS = 256           # the kernel's block size (generation_tiled.cu)
GENES_PER_THREAD = 4    # the heuristic's least work per thread
SWEEP_CALLS = 10
# the card's head start before a timed sweep: a spin of this many clock
# cycles (at least 1 ms on an H100) outlasts the host's enqueue of the calls
HEAD_START_CYCLES = 2_000_000
# (cache path, card, shape) -> tiles already read or swept in this process:
# the wrapper asks on every call, and the file is read once
_CHOSEN: Dict[Tuple[str, str, str], Tuple[int, int]] = {}


CACHE_PATH = _build.BUILD_DIR / "autotune_ga.json"


def device_kind() -> str:
    """The name the cache is keyed on: the card's, or ``"cpu"``."""
    return (torch.cuda.get_device_name() if torch.cuda.is_available()
            else "cpu")


def load_cache(path: Optional[Path] = None) -> Dict[str, dict]:
    path = Path(path or CACHE_PATH)
    if not path.exists():
        return {}
    try:
        return json.loads(path.read_text())
    except (json.JSONDecodeError, OSError):
        return {}


def save_cache(cache: Dict[str, dict], path: Optional[Path] = None) -> Path:
    path = Path(path or CACHE_PATH)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cache, indent=2, sort_keys=True) + "\n")
    return path


def shape_key(n: int, length: int, kind: str, n_islands: int = 1,
              spec=None) -> str:
    what = ("" if spec is None else
            f" {spec.crossover} {(spec.eval_spec or {}).get('eval')}")
    return f"{kind} {int(n_islands)}x{int(n)}x{int(length)}{what}"


def library_tag() -> str:
    """The kernel library's source hash, which each cache entry records."""
    return _build.library_path().stem.rsplit("-", 1)[-1]


def heuristic_rows(length: int) -> int:
    """The smallest candidate whose rows give every thread of a block at
    least :data:`GENES_PER_THREAD` genes (the largest when none does)."""
    for rows in CANDIDATES:
        if rows * length >= THREADS * GENES_PER_THREAD:
            return rows
    return CANDIDATES[-1]


def _time_candidates(n: int, length: int, kind: str, n_islands: int,
                     spec) -> Dict[int, float]:
    """Milliseconds per child-kernel launch for each candidate that the
    card's shared memory holds, on a synthetic population of the caller's
    shape under ``spec`` (without one: tournament, two-point or blend, no
    fused eval)."""
    from .common import GenerationSpec
    from .generation import max_smem_bytes
    from .tiling import PLAN_FIELDS, launch_child, launch_plan, max_rows

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(n * 7919 + length)
    shape = (n_islands, n, length)
    if kind == "binary":
        pop = (torch.rand(shape, generator=gen) < 0.5).to(torch.int8)
    else:
        pop = torch.rand(shape, generator=gen) * 10 - 5
    if spec is None:
        spec = GenerationSpec(
            kind=kind, length=length, elite=2, selection="tournament",
            tournament_k=2,
            crossover="two_point" if kind == "binary" else "blend",
            crossover_rate=0.9, mutation_rate=1.0 / length,
            mutation_sigma=0.3)
    seed, size, pop, fit = [t.to(dev) for t in (
        torch.arange(2 * n_islands, dtype=torch.int64).reshape(-1, 2),
        torch.full((n_islands,), n, dtype=torch.int32), pop,
        torch.randn(n_islands, n, generator=gen))]
    plan = torch.empty((PLAN_FIELDS, n_islands, n), dtype=torch.int32,
                       device=dev)
    launch_plan(seed, size, fit, spec, plan)
    new_pop = torch.empty_like(pop)
    fit_out = (None if spec.eval_spec is None else
               torch.empty((n_islands, n), dtype=torch.float32, device=dev))

    def call(rows):
        launch_child(seed, pop, plan, spec, rows, new_pop, fit_out)

    fit_rows = max_rows(length, spec, max_smem_bytes(dev.index or 0))
    times = {}
    for rows in (r for r in CANDIDATES if r <= fit_rows):
        call(rows)                                          # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HEAD_START_CYCLES)
        start.record()
        for _ in range(SWEEP_CALLS):
            call(rows)
        end.record()
        end.synchronize()
        times[rows] = start.elapsed_time(end) / SWEEP_CALLS
    return times


def best_tiles(n: int, length: int, kind: str = "float", *,
               n_islands: int = 1, spec=None,
               cache_path: Optional[Path] = None,
               force: bool = False) -> Tuple[int, int]:
    """(rows per block, L) for ``n_islands`` (n, L) populations of
    ``kind``, generated under ``spec`` when given: from this process's
    earlier answer or the cache file when they hold the key for this
    kernel library, else swept (card) or chosen by the heuristic (CPU) and
    written to the cache; ``force`` sweeps again."""
    key = device_kind()
    skey = shape_key(n, length, kind, n_islands, spec)
    memo = (str(Path(cache_path or CACHE_PATH)), key, skey)
    if memo in _CHOSEN and not force:
        return _CHOSEN[memo]
    cache = load_cache(cache_path)
    entries = cache.setdefault(key, {})
    entry = entries.get(skey)
    lib = library_tag()
    if entry is not None and entry.get("library") == lib and not force:
        _CHOSEN[memo] = int(entry["tile_pop"]), int(entry["tile_len"])
        return _CHOSEN[memo]

    if torch.cuda.is_available():
        times = _time_candidates(n, length, kind, n_islands, spec)
        entry = {"tile_pop": min(times, key=times.get),
                 "tile_len": int(length), "timed": True, "library": lib,
                 "sweep_ms": {str(r): t for r, t in sorted(times.items())}}
    else:
        entry = {"tile_pop": heuristic_rows(length), "tile_len": int(length),
                 "timed": False, "library": lib}
    entries[skey] = entry
    try:
        save_cache(cache, cache_path)
    except OSError:
        pass   # a read-only checkout: the choice still applies, uncached
    _CHOSEN[memo] = int(entry["tile_pop"]), int(entry["tile_len"])
    return _CHOSEN[memo]


def cache_summary(path: Optional[Path] = None) -> Dict[str, object]:
    """The cache in brief: its path, and per card and shape the rows per
    block and whether they were timed."""
    p = Path(path or CACHE_PATH)
    return {"path": str(p),
            "entries": {dev: {shape: {k: v[k] for k in
                                      ("tile_pop", "tile_len", "timed")
                                      if k in v}
                              for shape, v in shapes.items()}
                        for dev, shapes in load_cache(p).items()}}
