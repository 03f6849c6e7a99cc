// Trap fitness of a binary population, a warp per row.
//
// Replaces: src/repro/kernels/trap/trap.py::trap_fitness_kernel (the Pallas
// body _trap_kernel), reached through kernels/trap/ops.py::trap_fitness.
//
// Bound on the H100: memory. The kernel reads N*L int8 genes once and
// writes N f32 scores: (N*L + 4N) bytes, about 0.33 MB at the main path's
// 2048 x 160, which is about 0.1 us at 3.35 TB/s. The arithmetic is one
// integer add per gene and a handful of f32 operations per trap. It runs at
// set-up and once per W² restart, not per generation, so a launch and one
// round of loads set its time.
//
// Design: a warp per row, WARPS rows per block, a grid over N. The row is
// scored by kernels/ga/csrc/row_evals.cuh::binary_row_fitness_warp, the
// body the generation kernels' fused trap fitness runs: each lane scores
// one trap block (its l genes by byte loads, so any row length and any
// base), 32 traps per round, and every lane adds the scores from shuffles
// in the plain version's grouped order (kernels/trap/ref.py::ordered_sum:
// groups of `group` consecutive traps, each summed left to right, then the
// group sums left to right), with round-to-nearest intrinsics so that the
// compiler contracts nothing into an FMA. Kernel and plain version
// therefore agree bit for bit. The first design gave one thread a row and
// walked its genes byte by byte: 16 blocks at 2048 rows, 0.01751 ms
// (PERF.md), load latency after load latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../ga/csrc/row_evals.cuh"

namespace {

constexpr int WARPS = 8;  // rows per block

__global__ void __launch_bounds__(WARPS * 32)
trap_fitness_kernel(const int8_t* __restrict__ pop, float* __restrict__ out,
                    int n_rows, BinaryEval e) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // the whole warp: every lane has this row
  const float v = binary_row_fitness_warp(pop + (size_t)row * e.L, e, lane);
  if (lane == 0) out[row] = v;
}

}  // namespace

extern "C" int trap_fitness_launch(const void* pop, void* out, int n_rows,
                                   int n_traps, int l, int group, float a,
                                   float b, float z, float l_minus_z,
                                   void* stream) {
  BinaryEval e;
  e.kind = EVAL_TRAP;
  e.L = n_traps * l;
  e.trap_l = l;
  e.trap_group = group;
  e.a = a;
  e.b = b;
  e.z = z;
  e.l_minus_z = l_minus_z;
  e.royal_r = 0;
  const int blocks = (n_rows + WARPS - 1) / WARPS;
  trap_fitness_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)pop, (float*)out, n_rows, e);
  return (int)cudaGetLastError();
}
