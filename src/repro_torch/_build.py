"""Build the port's CUDA kernels and bind them with ctypes.

Every ``kernels/*/csrc/*.cu`` (with the ``*.cuh`` headers it includes) is
compiled by ``nvcc`` for ``sm_90a`` into an object, all sources at once in
parallel, and the objects are linked into one shared library under
``build/repro_torch/`` at the root of the checkout. The library's name
carries a hash of the sources, headers and flags, so an edit rebuilds and
an unchanged tree reuses the last build. The build
runs at first use, never on import; it needs ``nvcc`` (``$CUDA_HOME/bin``,
``/usr/local/cuda/bin`` or ``PATH``).

Each C entry point takes its pointers and the CUDA stream as ``void*``
(declared ``c_void_p`` here, so no pointer is cut to 32 bits), launches on
that stream without synchronising, and returns ``cudaGetLastError()``;
:func:`check` raises when that is not 0. ``--use_fast_math`` is not used:
IEEE division and rounding are part of the parity with the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent
REPO_ROOT = PKG_DIR.parents[1]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (all return a cudaError_t as int)
SIGNATURES: Dict[str, List] = {
    # pop, out, n_rows, n_traps, l, group, a, b, z, l_minus_z, stream
    "trap_fitness_launch": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P],
    # pop, fitness, seed, seed_stride, pop_size, new_pop, fit_out,
    # n_islands, n, L, elite, selection, tournament_k, crossover,
    # crossover_rate, mutation_rate, eval_kind, trap_l, trap_group, a, b, z,
    # l_minus_z, royal_r, stream
    "generation_launch": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                          _I, _I, _I, _I, _F,
                          _F, _I, _I, _I, _F, _F, _F, _F,
                          _I, _P],
    "generation_smem_bytes": [_I, _I],
    "generation_max_smem_bytes": [],
    # pop, fitness, seed, seed_stride, pop_size, o, perm, M, new_pop,
    # fit_out, n_islands, n, L, elite, selection, tournament_k, crossover,
    # crossover_rate, mutation_rate, sigma, low, high, blend_scale, alpha,
    # eval_kind, sum_group, m, n_groups, k_group, stream
    "generation_float_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I,
                                _F, _F, _F, _F, _F, _F, _F,
                                _I, _I, _I, _I, _I, _P],
    "generation_float_smem_bytes": [_I, _I, _I],
    # pop, o, perm, M, out, n_rows, D, m, G, k_group, stream
    "f15_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # fitness, seed, seed_stride, pop_size, masked, cum, plan, n_islands, n,
    # L, elite, selection, tournament_k, crossover, crossover_rate, stream
    "selection_plan_launch": [_P, _P, _I, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _I, _I, _F, _P],
    # pop, plan, seed, seed_stride, new_pop, fit_out, float_genes,
    # n_islands, n, L, elite, rows, crossover, mutation_rate, sigma, low,
    # high, blend_scale, alpha, eval_kind, sum_group, trap_l, trap_group, a,
    # b, z, l_minus_z, royal_r, stream
    "generation_tiled_launch": [_P, _P, _P, _I, _P, _P, _I,
                                _I, _I, _I, _I, _I, _I, _F, _F, _F,
                                _F, _F, _F, _I, _I, _I, _I, _F,
                                _F, _F, _F, _I, _P],
    # rows, L, float_genes, eval_kind, sum_group
    "generation_tiled_smem_bytes": [_I, _I, _I, _I, _I],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_LOG: List[str] = []


def sources() -> List[Path]:
    return sorted(PKG_DIR.glob("kernels/*/csrc/*.cu"))


def headers() -> List[Path]:
    return sorted(PKG_DIR.glob("kernels/*/csrc/*.cuh"))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources() + headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libreprotorch-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source in parallel and link one library; return its
    path. The compiler's resource report goes to :data:`BUILD_LOG`."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}-{target.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
