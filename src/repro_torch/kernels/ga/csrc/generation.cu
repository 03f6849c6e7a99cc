// One whole GA generation per island, binary genomes, one block per island.
//
// Replaces: src/repro/kernels/ga/generation.py::generation_kernel (the Pallas
// bodies _generation_kernel and _generation_eval_kernel), which the island
// model reaches through kernels/ga/ops.py::generation[_eval] under
// EAConfig(impl="pallas"), vmapped over islands.
//
// What it computes (kernels/ga/common.py::generation_math): the elite of the
// valid lanes, tournament or roulette parents, two-point or uniform
// crossover behind a rate gate, bit-flip mutation and, optionally, the
// trap / onemax / royal_road fitness of the new rows. All randomness is the
// counter-based Threefry-2x32 of rand.py, drawn on chip from two seed words
// per island with the salts of the protocol; the plain version draws the
// same bits from the same counters.
//
// Bound on the H100: integer operations. The kernel moves about 2*I*n*L
// bytes (a population in, a population out), 0.66 MB at the main path's
// 8 x 256 x 160, which is 0.2 us at 3.35 TB/s. It runs one Threefry (67
// int32 operations as compiled: a funnel shift per rotate, the key sums
// hoisted, the last round's x1 dead) per child gene for the mutation draw,
// one more per gene under uniform crossover, and 2k + 3 per child row for
// the plan: about 25 M int32 operations at the main-path shape, 0.73 us at
// 128 int32 operations per SM per clock. A block per island gives only I
// blocks, so at 8 islands most SMs idle. Measured, it takes about 0.14 ms
// at that shape (PERF.md), and the main path around it is bound by its
// launches on the host.
//
// Design: the island's (n, L) int8 tile and the new tile both live in
// shared memory (2 * 40 KiB at 256 x 160), so parents are gathered from
// shared memory and nothing but the input and output populations touches
// device memory. Phase 1 builds the selection plan in shared memory: the
// elite by iterative argmax with ties to the lowest index (one thread), the
// roulette prefix sum left to right (one thread, the plain version's order),
// and one thread per child row for tournaments, cuts and the gate. Phase 2
// runs one thread per gene, consecutive threads on consecutive genes so the
// global stores coalesce. Phase 3 runs one thread per row for the fused
// fitness, summing in the plain version's order. Round-to-nearest
// intrinsics keep the compiler from contracting any f32 step into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plan_rows.cuh"
#include "row_evals.cuh"
#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;

struct Params {
  int n, L, elite, selection, tournament_k, crossover;
  float crossover_rate, mutation_rate;
  BinaryEval ev;
};

__host__ __device__ inline size_t smem_bytes(int n, int L) {
  // masked, cum (f32) + idx_a, idx_b, cut1, cut2, gate (i32) + two tiles
  return (size_t)n * 7 * 4 + 2 * (size_t)n * (size_t)L;
}

__global__ void __launch_bounds__(THREADS)
generation_kernel(const int8_t* __restrict__ pop,
                  const float* __restrict__ fitness,
                  const int64_t* __restrict__ seed, int seed_stride,
                  const int* __restrict__ pop_size,
                  int8_t* __restrict__ new_pop, float* __restrict__ fit_out,
                  Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = p.n, L = p.L, elite = p.elite;
  const int n_children = n - elite;
  float* masked = reinterpret_cast<float*>(smem);
  float* cum = masked + n;
  int* idx_a = reinterpret_cast<int*>(cum + n);
  int* idx_b = idx_a + n;
  int* cut1 = idx_b + n;
  int* cut2 = cut1 + n;
  int* gate = cut2 + n;
  int8_t* tile = reinterpret_cast<int8_t*>(gate + n);
  int8_t* kids = tile + (size_t)n * L;

  const int isl = blockIdx.x;
  // the key words are int64 holding 32-bit values: keep the low word
  const int64_t* words = seed + (size_t)isl * seed_stride;
  const uint32_t k0 = (uint32_t)words[0], k1 = (uint32_t)words[1];
  const int size = pop_size[isl];
  const uint32_t maxval = (uint32_t)max(size, 1);
  const int8_t* src = pop + (size_t)isl * n * L;
  const float* fit = fitness + (size_t)isl * n;

  // ---- phase 0: the island's tile and masked fitness into shared memory
  for (int i = threadIdx.x; i < n * L; i += blockDim.x) tile[i] = src[i];
  for (int r = threadIdx.x; r < n; r += blockDim.x)
    masked[r] = r < size ? fit[r] : neg_inf();
  __syncthreads();

  // ---- phase 1a: elite (lowest index wins ties) and the roulette CDF
  if (threadIdx.x == 0) {
    for (int e = 0; e < elite; ++e) {
      float best = 0.0f;
      int best_i = 0;
      for (int r = 0; r < n; ++r) {
        float v = masked[r];
        for (int j = 0; j < e; ++j)
          if (idx_a[j] == r) v = neg_inf();
        if (r == 0 || v > best) {
          best = v;
          best_i = r;
        }
      }
      idx_a[e] = idx_b[e] = best_i;
      cut1[e] = cut2[e] = gate[e] = 0;
    }
  } else if (threadIdx.x == 32 && p.selection == 1) {
    roulette_cdf(masked, n, finite_min(masked, n), cum);
  }
  __syncthreads();

  // ---- phase 1b: parents, cuts and gate of each child row
  for (int c = threadIdx.x; c < n_children; c += blockDim.x) {
    const int row = elite + c;
    const RowPlan rp = child_row_plan(k0, k1, c, masked, cum, n, maxval,
                                      p.selection, p.tournament_k,
                                      p.crossover, L, p.crossover_rate);
    idx_a[row] = rp.a;
    idx_b[row] = rp.b;
    cut1[row] = rp.cut1;
    cut2[row] = rp.cut2;
    gate[row] = rp.gate;
  }
  __syncthreads();

  // ---- phase 2: crossover and mutation, one thread per gene
  int8_t* dst = new_pop + (size_t)isl * n * L;
  for (int i = threadIdx.x; i < n * L; i += blockDim.x) {
    const int r = i / L, col = i - r * L;
    const int8_t pa = tile[idx_a[r] * L + col];
    int8_t kid = pa;
    if (r >= elite) {
      const uint32_t ctr = (uint32_t)(r - elite) * (uint32_t)L + (uint32_t)col;
      if (gate[r]) {
        const int8_t pb = tile[idx_b[r] * L + col];
        const bool take =
            p.crossover == 0
                ? (col >= cut1[r] && col < cut2[r])
                : bernoulli_at(k0, k1, ctr, SALT_CROSSOVER, 0.5f);
        kid = take ? pb : pa;
      }
      if (bernoulli_at(k0, k1, ctr, SALT_MUTATE, p.mutation_rate))
        kid = (int8_t)(1 - kid);
    }
    kids[i] = kid;
    dst[i] = kid;
  }

  // ---- phase 3: fused fitness of the new rows
  if (p.ev.kind == EVAL_NONE) return;
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += blockDim.x)
    fit_out[(size_t)isl * n + r] =
        binary_row_fitness(kids + (size_t)r * L, p.ev);
}

}  // namespace

extern "C" int generation_smem_bytes(int n, int L) {
  return (int)smem_bytes(n, L);
}

extern "C" int generation_max_smem_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

extern "C" int generation_launch(
    const void* pop, const void* fitness, const void* seed, int seed_stride,
    const void* pop_size, void* new_pop, void* fit_out, int n_islands, int n,
    int L, int elite, int selection, int tournament_k, int crossover,
    float crossover_rate, float mutation_rate, int eval_kind, int trap_l,
    int trap_group, float a, float b, float z, float l_minus_z, int royal_r,
    void* stream) {
  const BinaryEval ev{eval_kind, L, trap_l, trap_group, a, b, z, l_minus_z,
                      royal_r};
  const Params p{n,         L,           elite,          selection,
                 tournament_k, crossover, crossover_rate, mutation_rate, ev};
  const size_t smem = smem_bytes(n, L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        generation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  generation_kernel<<<n_islands, THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)pop, (const float*)fitness, (const int64_t*)seed,
      seed_stride, (const int*)pop_size, (int8_t*)new_pop, (float*)fit_out, p);
  return (int)cudaGetLastError();
}
