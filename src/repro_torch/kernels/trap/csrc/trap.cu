// Trap fitness of a binary population, one thread per row.
//
// Replaces: src/repro/kernels/trap/trap.py::trap_fitness_kernel (the Pallas
// body _trap_kernel), reached through kernels/trap/ops.py::trap_fitness.
//
// Bound on the H100: memory. The kernel reads N*L int8 genes once and
// writes N f32 scores: (N*L + 4N) bytes, about 0.33 MB at the main path's
// 2048 x 160, which is about 0.1 us at 3.35 TB/s. The arithmetic is one
// integer add per gene and a handful of f32 operations per trap. Measured,
// it takes about 17 us there (PERF.md): 16 blocks of threads that each
// walk a row byte by byte wait on load latency, far above either bound.
// It runs at set-up and once per W² restart, not per generation.
//
// Design: one thread owns one row and walks its genes in order, so the
// ragged last block is masked by a bounds test and no padding is needed.
// The per-trap scores are summed in the fixed grouped ascending order of
// the plain version (kernels/trap/ref.py::ordered_sum: groups of `group`
// consecutive traps, each summed left to right, then the group sums left to
// right), with round-to-nearest intrinsics so that the compiler contracts
// nothing into an FMA. Kernel and plain version therefore agree bit for bit.
// Reading a row per thread is not coalesced; a warp per row with coalesced
// loads is the obvious next step if the kernel ever matters on the path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float trap_score(int u, float a, float b, float z,
                                            float l_minus_z) {
  const float uf = (float)u;
  if (uf <= z) return __fdiv_rn(__fmul_rn(a, __fsub_rn(z, uf)), z);
  return __fdiv_rn(__fmul_rn(b, __fsub_rn(uf, z)), l_minus_z);
}

__global__ void trap_fitness_kernel(const int8_t* __restrict__ pop,
                                    float* __restrict__ out, int n_rows,
                                    int n_traps, int l, int group, float a,
                                    float b, float z, float l_minus_z) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int8_t* genes = pop + (size_t)row * (size_t)n_traps * (size_t)l;
  float total = 0.0f;
  for (int g0 = 0; g0 < n_traps; g0 += group) {
    const int g1 = min(g0 + group, n_traps);
    float part = 0.0f;
    for (int t = g0; t < g1; ++t) {
      int u = 0;
      for (int j = 0; j < l; ++j) u += genes[t * l + j];
      part = __fadd_rn(part, trap_score(u, a, b, z, l_minus_z));
    }
    total = __fadd_rn(total, part);
  }
  out[row] = total;
}

}  // namespace

extern "C" int trap_fitness_launch(const void* pop, void* out, int n_rows,
                                   int n_traps, int l, int group, float a,
                                   float b, float z, float l_minus_z,
                                   void* stream) {
  const int threads = 128;
  const int blocks = (n_rows + threads - 1) / threads;
  trap_fitness_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)pop, (float*)out, n_rows, n_traps, l, group, a, b, z,
      l_minus_z);
  return (int)cudaGetLastError();
}
