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
import time
from concurrent.futures import ThreadPoolExecutor
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
    # n, L, elite
    "generation_smem_bytes": [_I, _I, _I],
    "generation_max_smem_bytes": [],
    # pop, fitness, seed, seed_stride, pop_size, o, perm, M, new_pop,
    # fit_out, n_islands, n, L, elite, selection, tournament_k, crossover,
    # crossover_rate, mutation_rate, sigma, low, high, blend_scale, alpha,
    # eval_kind, sum_group, m, n_groups, k_group, rows, stream
    "generation_float_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I,
                                _F, _F, _F, _F, _F, _F, _F,
                                _I, _I, _I, _I, _I, _I, _P],
    # n, L, elite, rows
    "generation_float_smem_bytes": [_I, _I, _I, _I],
    # pop, o, perm, M, out, n_rows, D, m, G, k_group, rows, groups per
    # batch, columns per slice (0: the tiled route), gather, blocks, stream
    "f15_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, _P],
    # rows, D, m, groups per batch, columns per slice, gather
    "f15_smem_bytes": [_I, _I, _I, _I, _I, _I],
    # shared memory bytes, columns per slice, gather
    "f15_blocks_per_sm": [_I, _I, _I],
    # out: int[4] (SMs, shared memory per SM, per block, reserved per block)
    "f15_device_limits": [_P],
    # fitness, pop_size, cum, n_islands, n, stream
    "roulette_cdf_launch": [_P, _P, _P, _I, _I, _P],
    # pop, fitness, seed, seed_stride, pop_size, cum, new_pop, fit_out,
    # float_genes, n_islands, n, L, elite, rows, selection, tournament_k,
    # crossover, crossover_rate, mutation_rate, sigma, low, high,
    # blend_scale, alpha, eval_kind, sum_group, trap_l, trap_group, a, b, z,
    # l_minus_z, royal_r, stream
    "generation_tiled_launch": [_P, _P, _P, _I, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, _F, _F, _F, _F, _F,
                                _F, _F, _I, _I, _I, _I, _F, _F, _F,
                                _F, _I, _P],
    # rows, L, elite, float_genes, eval_kind, sum_group
    "generation_tiled_smem_bytes": [_I, _I, _I, _I, _I, _I],
    # r, k, v, w, u, s0, y, s_out, B, S, H, hd, chunk, u_bf16, strides (an
    # int[12]: batch, seq, head of r, k, v, w), stream: bf16 r, k, v
    # (wkv.cu) and f32 (wkv_f32.cu)
    "wkv_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _P, _P],
    "wkv_f32_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _P, _P],
    # q, k, v, o, B, H, Kv, Sq, Sk, hd, the strides of q, k and v (batch,
    # seq, head), scale, causal, stream: the f32 kernel (flash_3xtf32.cu)
    # and the bf16 kernel (flash_tc.cu)
    "flash_attention_f32_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _F, _I, _P],
    "flash_attention_tc_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _F, _I, _P],
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


def _compile(nvcc: str, src: Path, obj: Path):
    t = time.perf_counter()
    proc = subprocess.run([nvcc, *FLAGS, "-c", str(src), "-o", str(obj)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    return proc, time.perf_counter() - t


def build() -> Path:
    """Compile every source in parallel and link one library; return its
    path. Each source's compile time and the compiler's resource report
    go to :data:`BUILD_LOG`."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs = sources()
    objs = [BUILD_DIR / f"{src.stem}-{target.stem}.o" for src in srcs]
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        results = list(pool.map(lambda so: _compile(nvcc, *so),
                                zip(srcs, objs)))
    failed = []
    for src, (proc, secs) in zip(srcs, results):
        BUILD_LOG.append(f"== {src.name} ({secs:.2f} s)\n{proc.stdout}")
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{proc.stdout}")
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
