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

#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;

enum EvalKind { EVAL_NONE = 0, EVAL_TRAP = 1, EVAL_ONEMAX = 2, EVAL_ROYAL = 3 };

struct Params {
  int n, L, elite, selection, tournament_k, crossover;
  float crossover_rate, mutation_rate;
  int eval_kind, trap_l, trap_group;
  float a, b, z, l_minus_z;
  int royal_r;
};

__host__ __device__ inline size_t smem_bytes(int n, int L) {
  // masked, cum (f32) + idx_a, idx_b, cut1, cut2, gate (i32) + two tiles
  return (size_t)n * 7 * 4 + 2 * (size_t)n * (size_t)L;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ float trap_row(const int8_t* row, const Params& p) {
  const int n_traps = p.L / p.trap_l;
  float total = 0.0f;
  for (int g0 = 0; g0 < n_traps; g0 += p.trap_group) {
    const int g1 = min(g0 + p.trap_group, n_traps);
    float part = 0.0f;
    for (int t = g0; t < g1; ++t) {
      int u = 0;
      for (int j = 0; j < p.trap_l; ++j) u += row[t * p.trap_l + j];
      const float uf = (float)u;
      const float f =
          uf <= p.z ? __fdiv_rn(__fmul_rn(p.a, __fsub_rn(p.z, uf)), p.z)
                    : __fdiv_rn(__fmul_rn(p.b, __fsub_rn(uf, p.z)),
                                p.l_minus_z);
      part = __fadd_rn(part, f);
    }
    total = __fadd_rn(total, part);
  }
  return total;
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
    float lo = __int_as_float(0x7f800000);
    for (int r = 0; r < n; ++r)
      if (isfinite(masked[r])) lo = fminf(lo, masked[r]);
    float acc = 0.0f;
    for (int r = 0; r < n; ++r) {
      const float m = masked[r];
      const float w = isfinite(m) ? __fadd_rn(__fsub_rn(m, lo), 1e-6f) : 0.0f;
      acc = __fadd_rn(acc, w);
      cum[r] = acc;
    }
  }
  __syncthreads();

  // ---- phase 1b: parents, cuts and gate of each child row
  for (int c = threadIdx.x; c < n_children; c += blockDim.x) {
    const int row = elite + c;
    int par[2];
    const uint32_t salts[2] = {SALT_SELECT_A, SALT_SELECT_B};
    for (int s = 0; s < 2; ++s) {
      if (p.selection == 0) {
        float best = 0.0f;
        int win = 0;
        for (int j = 0; j < p.tournament_k; ++j) {
          const int cand = randint_at(
              k0, k1, (uint32_t)c * (uint32_t)p.tournament_k + (uint32_t)j,
              salts[s], maxval);
          const float f = masked[cand];
          if (j == 0 || f > best) {
            best = f;
            win = cand;
          }
        }
        par[s] = win;
      } else {
        const float u =
            __fmul_rn(uniform_at(k0, k1, (uint32_t)c, salts[s]), cum[n - 1]);
        int idx = 0;
        for (int j = 0; j < n; ++j) idx += cum[j] <= u;
        par[s] = min(idx, (int)maxval - 1);
      }
    }
    idx_a[row] = par[0];
    idx_b[row] = par[1];
    if (p.crossover == 0) {
      const uint32_t span = (uint32_t)L + 1u;
      const int x = randint_at(k0, k1, (uint32_t)c * 2u, SALT_CROSSOVER, span);
      const int y =
          randint_at(k0, k1, (uint32_t)c * 2u + 1u, SALT_CROSSOVER, span);
      cut1[row] = min(x, y);
      cut2[row] = max(x, y);
    } else {
      cut1[row] = cut2[row] = 0;
    }
    gate[row] = bernoulli_at(k0, k1, (uint32_t)c, SALT_CROSSOVER_GATE,
                             p.crossover_rate);
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
  if (p.eval_kind == EVAL_NONE) return;
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int8_t* row = kids + (size_t)r * L;
    float v = 0.0f;
    if (p.eval_kind == EVAL_TRAP) {
      v = trap_row(row, p);
    } else if (p.eval_kind == EVAL_ONEMAX) {
      for (int j = 0; j < L; ++j) v = __fadd_rn(v, (float)row[j]);
    } else {
      int full = 0;
      for (int b0 = 0; b0 < L; b0 += p.royal_r) {
        int u = 0;
        for (int j = 0; j < p.royal_r; ++j) u += row[b0 + j];
        full += u >= p.royal_r;
      }
      v = __fmul_rn((float)p.royal_r, (float)full);
    }
    fit_out[(size_t)isl * n + r] = v;
  }
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
  const Params p{n,         L,           elite,        selection,
                 tournament_k, crossover, crossover_rate, mutation_rate,
                 eval_kind, trap_l,      trap_group,   a,
                 b,         z,           l_minus_z,    royal_r};
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
