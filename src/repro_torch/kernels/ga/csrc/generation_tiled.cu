// One GA generation of any population size, binary or float genomes, a few
// output rows per block, each block drawing its own rows' selection plan.
//
// Replaces: src/repro/kernels/ga/tiling.py::generation_tiled (the Pallas
// body _tiled_kernel, and the selection_plan it computes in XLA before its
// pallas_call), which the island model reaches through kernels/ga/ops.py
// under EAConfig(impl="pallas_tiled"), and impl="pallas" above the
// reference's 16 MiB untiled estimate: Fig. 4's 10,000 x 1000
// generation+F15 row (benchmarks/fig4_f15.py).
//
// What it computes (kernels/ga/common.py::selection_plan, then
// child_tile_math on the parents the plan names): the elite of the valid
// lanes, tournament or roulette parents, two-point cuts and the crossover
// gate of each child row; two-point, uniform or blend crossover behind the
// gate, bit-flip or gaussian mutation, the clip of float child rows, and
// optionally the fitness of the new rows (trap / onemax / royal_road /
// rastrigin / sphere; F15 goes to the F15 kernel after this one, as in the
// reference). Row elite + c's plan draws with the counters of
// plan_rows.cuh, gene col of output row r with counter (r - elite) * L +
// col and the salts of threefry.cuh: the untiled kernels' counters, so for
// any rows per block the output equals theirs bit for bit, fitness
// included. Under roulette the island's CDF comes from roulette_cdf.cu,
// launched before this kernel; under tournament this kernel is the
// generation's one launch.
//
// Bound on the H100: operations. At Fig. 4's 10,000 x 1000 f32 a child
// gene costs one Threefry for its mutation test and one for the blend on
// the 90 % of rows whose gate is on, 67 int32 operations each as compiled:
// about 1.3e9 int32 operations, 39 us at 33.5 T/s, against 80 MB of
// population in and out, 24 us at 3.35 TB/s. The plan adds 5 draws a row,
// 3.4e6 operations. The draws are fixed by the plain version's counters;
// only the work around them is this kernel's to cut.
//
// Design: the TPU kernel gathered parents by one-hot matmuls over a grid of
// (row tiles x gene tiles x source blocks), accumulating in VMEM across the
// sequential source axis, after XLA had drawn the plan. Here blocks run in
// no order and device memory serves a gather directly, so each block takes
// `rows` output rows of one island (grid: row blocks x islands) and reads
// its parents' rows straight from device memory. A row's plan is a pure
// function of (key, row, masked fitness), so each block draws its own
// rows' plan, one thread per row, reading fitness from device memory; only
// the blocks whose rows start below `elite` find the elite (plan_rows.cuh::
// elite_rows across all 8 warps), as in the untiled float kernel. That
// drops the first design's plan launch, its one block per island (one SM
// drew Fig. 4's 9,998 rows) and the plan's round trip through device
// memory. Genes go 16 bytes per thread (4 f32 or 16 int8, the card's
// widest load): one ld.global.v4 per parent (the second parent only where
// the row's gate is on) and one 16-byte store, the pack's 4 or 16
// mutation draws, and as many crossover draws, issued together so their
// Threefry chains overlap. That route needs the rows' pitch L * sizeof(T)
// and both populations' bases on 16 bytes; otherwise (L = 1003 f32, L =
// 157 int8, an island at an odd offset) every row takes the scalar route,
// one gene per thread, in the same loop. Threads walk (row, pack) pairs
// without a division per gene: a row of V packs takes a whole pass of the
// block when V >= 256 (threads step over its packs), else 256 / V rows go
// in a pass and a thread keeps the pack column it was given at the start
// (one division per thread). So at Fig. 4's 250 packs a row the block
// covers one row per pass, every warp inside one row: the gate branch is
// uniform across each warp and the row's plan sits in registers while the
// thread stays in the row. The mutation and the crossover tests compare
// the draw's 24 bits with an integer threshold (threefry.cuh
// unit_threshold), not a converted float. Genes are not tiled, so a fused
// separable fitness is summed per row from the rows staged in shared
// memory: a warp per row for the binary evals (row_evals.cuh, as in the
// untiled binary kernel), the grouped f32 order of neg_grouped_row_sums
// for the float terms. Shared memory is the elite, the arg-max scratch,
// the rows' plan and, under a fused eval, the staged rows; the wrapper
// raises for a `rows` above what the card holds. Row offsets are size_t:
// eight islands of 64k x 1000 f32 pass 2^31 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../rastrigin/csrc/f15_rows.cuh"
#include "plan_rows.cuh"
#include "row_evals.cuh"
#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr uint32_t HALF_THRESHOLD = 1u << 23;  // unit_threshold(0.5f)

struct TiledParams {
  int n, L, elite, rows, selection, tournament_k, crossover;
  float crossover_rate, mutation_rate, sigma, low, high, blend_scale, alpha;
  int sum_lead;  // rastrigin / sphere: window_lead(L), ordered_sum's order
  BinaryEval ev;  // ev.kind: the fused eval of either genome kind
};

// the words ahead of the staged rows: the elite, the arg-max scratch (4 x
// WARPS) and the rows' plan, on 16 bytes
__host__ __device__ inline size_t words_bytes(int elite, int rows) {
  return (4 * ((size_t)elite + 4 * WARPS + 5 * (size_t)rows) + 15) &
         ~(size_t)15;
}

__host__ __device__ inline size_t tiled_smem_bytes(int rows, int L, int elite,
                                                   bool float_genes,
                                                   int eval_kind) {
  const size_t bytes = words_bytes(elite, rows);
  if (eval_kind == EVAL_NONE) return bytes;
  if (!float_genes) return bytes + (size_t)rows * L;  // the int8 rows
  const size_t n_parts = n_windows(L);
  return bytes + (size_t)rows * ((size_t)L + n_parts) * sizeof(float);
}

// N genes from 16-byte-aligned p (N = 4 f32 or 16 int8), or one gene
__device__ __forceinline__ void load_pack(const float* p, float (&g)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  g[0] = v.x;
  g[1] = v.y;
  g[2] = v.z;
  g[3] = v.w;
}

__device__ __forceinline__ void load_pack(const int8_t* p, int8_t (&g)[16]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                         (uint32_t)v.w};
#pragma unroll
  for (int j = 0; j < 16; ++j) g[j] = (int8_t)(w[j >> 2] >> (8 * (j & 3)));
}

template <typename T>
__device__ __forceinline__ void load_pack(const T* p, T (&g)[1]) {
  g[0] = __ldg(p);
}

// N genes to 16-byte-aligned p (device or shared memory), or one gene
__device__ __forceinline__ void store_pack(float* p, const float (&g)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(g[0], g[1], g[2], g[3]);
}

__device__ __forceinline__ void store_pack(int8_t* p, const int8_t (&g)[16]) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    w[j >> 2] |= (uint32_t)(uint8_t)g[j] << (8 * (j & 3));
  *reinterpret_cast<int4*>(p) = make_int4((int)w[0], (int)w[1], (int)w[2],
                                          (int)w[3]);
}

template <typename T>
__device__ __forceinline__ void store_pack(T* p, const T (&g)[1]) {
  p[0] = g[0];
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
generation_tiled_kernel(const T* __restrict__ pop,
                        const float* __restrict__ fitness,
                        const int64_t* __restrict__ seed, int seed_stride,
                        const int* __restrict__ pop_size,
                        const float* __restrict__ cum_buf,
                        T* __restrict__ new_pop, float* __restrict__ fit_out,
                        TiledParams p) {
  constexpr bool FLOAT_GENES = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = p.n, L = p.L, elite = p.elite;
  const int isl = blockIdx.y;
  const int row0 = blockIdx.x * p.rows;
  const int rows = min(p.rows, n - row0);
  int* elite_idx = reinterpret_cast<int*>(smem);
  float* red = reinterpret_cast<float*>(elite_idx + elite);
  RowPlan* plan = reinterpret_cast<RowPlan*>(red + 4 * WARPS);
  // under a fused eval: the new int8 rows, or the float rows' terms
  unsigned char* stage = smem + words_bytes(elite, p.rows);
  int8_t* s_kids = reinterpret_cast<int8_t*>(stage);
  float* s_terms = reinterpret_cast<float*>(stage);

  // the key words are int64 holding 32-bit values: keep the low word
  const int64_t* words = seed + (size_t)isl * seed_stride;
  const uint32_t k0 = (uint32_t)words[0], k1 = (uint32_t)words[1];
  const int size = pop_size[isl];
  const MaskedFitness masked{fitness + (size_t)isl * n, size};
  const float* cum = p.selection == 1 ? cum_buf + (size_t)isl * n : nullptr;

  // ---- phase 1: the plan of this block's rows; the elite only where they
  // start below it (uniform per block)
  if (row0 < elite) {
    elite_rows(masked, n, elite, WARPS, red, elite_idx);
    __syncthreads();
  }
  for (int t = threadIdx.x; t < rows; t += THREADS) {
    const int row = row0 + t;
    if (row < elite) {
      const int e = elite_idx[row];
      plan[t] = RowPlan{e, e, 0, 0, 0};
    } else {
      plan[t] = child_row_plan(k0, k1, row - elite, masked, cum, n,
                               (uint32_t)max(size, 1), p.selection,
                               p.tournament_k, p.crossover, L,
                               p.crossover_rate);
    }
  }
  __syncthreads();

  // ---- phase 2: crossover, mutation (and clip), N genes per thread
  const T* src = pop + (size_t)isl * n * L;
  T* dst = new_pop + ((size_t)isl * n + row0) * L;
  const bool fused = p.ev.kind != EVAL_NONE;
  const uint32_t mutate_below = unit_threshold(p.mutation_rate);
  const int packs = L / N;  // a row's packs (N divides L on both routes)
  int t_first, c_first, t_step;
  if (packs >= THREADS) {
    t_first = 0;
    c_first = threadIdx.x;
    t_step = 1;
  } else {
    t_step = THREADS / packs;
    t_first = threadIdx.x / packs;
    c_first = threadIdx.x - t_first * packs;
    if (t_first >= t_step) t_first = rows;  // the pass's spare threads
  }
  for (int t = t_first; t < rows; t += t_step) {
    const RowPlan rp = plan[t];
    const int row = row0 + t;
    const bool child = row >= elite;
    const bool gate = child && rp.gate;
    // uniform and blend draw per gene; two-point uses the cuts
    const bool cross_draws = gate && p.crossover != 0;
    const T* pa_row = src + (size_t)rp.a * L;
    const T* pb_row = src + (size_t)rp.b * L;
    const uint32_t ctr_row = (uint32_t)(row - elite) * (uint32_t)L;
    for (int c = c_first; c < packs; c += THREADS) {
      const int col = c * N;
      T a[N], b[N], kid[N];
      load_pack(pa_row + col, a);
      if (gate) load_pack(pb_row + col, b);
      if (!child) {
#pragma unroll
        for (int j = 0; j < N; ++j) kid[j] = a[j];
      } else {
        const uint32_t ctr = ctr_row + (uint32_t)col;
        uint32_t mbits[N], xbits[N];
        if (cross_draws) {
#pragma unroll
          for (int j = 0; j < N; ++j) {
            mbits[j] = threefry_x0(k0, k1, ctr + j, SALT_MUTATE);
            xbits[j] = threefry_x0(k0, k1, ctr + j, SALT_CROSSOVER);
          }
        } else {
#pragma unroll
          for (int j = 0; j < N; ++j)
            mbits[j] = threefry_x0(k0, k1, ctr + j, SALT_MUTATE);
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {
          T k = a[j];
          if (gate) {
            if (p.crossover == 0) {
              k = (col + j >= rp.cut1 && col + j < rp.cut2) ? b[j] : a[j];
            } else if (p.crossover == 1) {
              k = unit_below(xbits[j], HALF_THRESHOLD) ? b[j] : a[j];
            } else if constexpr (FLOAT_GENES) {
              const float u = __fmaf_rn(bits_to_unit(xbits[j]),
                                        p.blend_scale, -p.alpha);
              k = __fmaf_rn(u, __fsub_rn(b[j], a[j]), a[j]);
            }
          }
          const bool hit = unit_below(mbits[j], mutate_below);
          if constexpr (FLOAT_GENES) {
            if (hit)
              k = __fmaf_rn(normal_at(k0, k1, ctr + j, SALT_MUTATE_NOISE),
                            p.sigma, k);
            k = fminf(fmaxf(k, p.low), p.high);
          } else {
            if (hit) k = (int8_t)(1 - k);
          }
          kid[j] = k;
        }
      }
      store_pack(dst + (size_t)t * L + col, kid);
      if (fused) {
        if constexpr (FLOAT_GENES) {
          float terms[N];
#pragma unroll
          for (int j = 0; j < N; ++j)
            terms[j] = p.ev.kind == EVAL_RASTRIGIN ? rastrigin_term(kid[j])
                                                   : __fmul_rn(kid[j], kid[j]);
          store_pack(s_terms + (size_t)t * L + col, terms);
        } else {
          store_pack(s_kids + (size_t)t * L + col, kid);
        }
      }
    }
  }

  // ---- phase 3: fused fitness of the new rows, in the untiled order
  if (!fused) return;
  __syncthreads();
  float* out = fit_out + (size_t)isl * n + row0;
  if constexpr (FLOAT_GENES) {
    neg_grouped_row_sums(s_terms, s_terms + (size_t)rows * L, rows, L,
                         p.sum_lead, out);
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int t = warp; t < rows; t += WARPS) {
      const float f =
          binary_row_fitness_warp(s_kids + (size_t)t * L, p.ev, lane);
      if (lane == 0) out[t] = f;
    }
  }
}

template <typename T, int N>
int launch_route(const void* pop, const void* fitness, const void* seed,
                 int seed_stride, const void* pop_size, const void* cum,
                 void* new_pop, void* fit_out, int n_islands,
                 const TiledParams& p, void* stream) {
  const size_t smem =
      tiled_smem_bytes(p.rows, p.L, p.elite, std::is_same<T, float>::value,
                       p.ev.kind);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        generation_tiled_kernel<T, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.n + p.rows - 1) / p.rows, n_islands);
  generation_tiled_kernel<T, N><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)pop, (const float*)fitness, (const int64_t*)seed,
      seed_stride, (const int*)pop_size, (const float*)cum, (T*)new_pop,
      (float*)fit_out, p);
  return (int)cudaGetLastError();
}

// the 16-byte route where both populations and every row start on 16
// bytes, else the scalar route
template <typename T>
int launch(const void* pop, const void* fitness, const void* seed,
           int seed_stride, const void* pop_size, const void* cum,
           void* new_pop, void* fit_out, int n_islands, const TiledParams& p,
           void* stream) {
  const bool packed = (reinterpret_cast<uintptr_t>(pop) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(new_pop) & 15) == 0 &&
                      ((size_t)p.L * sizeof(T)) % 16 == 0;
  return packed ? launch_route<T, 16 / sizeof(T)>(
                      pop, fitness, seed, seed_stride, pop_size, cum,
                      new_pop, fit_out, n_islands, p, stream)
                : launch_route<T, 1>(pop, fitness, seed, seed_stride,
                                     pop_size, cum, new_pop, fit_out,
                                     n_islands, p, stream);
}

}  // namespace

extern "C" int generation_tiled_smem_bytes(int rows, int L, int elite,
                                           int float_genes, int eval_kind) {
  return (int)tiled_smem_bytes(rows, L, elite, float_genes != 0, eval_kind);
}

// cum: the (I, n) roulette CDF of roulette_cdf.cu under roulette selection
// (selection 1), else unused
extern "C" int generation_tiled_launch(
    const void* pop, const void* fitness, const void* seed, int seed_stride,
    const void* pop_size, const void* cum, void* new_pop, void* fit_out,
    int float_genes, int n_islands, int n, int L, int elite, int rows,
    int selection, int tournament_k, int crossover, float crossover_rate,
    float mutation_rate, float sigma, float low, float high,
    float blend_scale, float alpha, int eval_kind, int sum_lead, int trap_l,
    int trap_lead, float a, float b, float z, float l_minus_z, int royal_r,
    void* stream) {
  if (rows < 1 || (selection == 1 && cum == nullptr))
    return (int)cudaErrorInvalidValue;
  const BinaryEval ev{eval_kind, L, trap_l, trap_lead, a, b, z, l_minus_z,
                      royal_r};
  const TiledParams p{n,           L,         elite,          rows,
                      selection,   tournament_k, crossover,   crossover_rate,
                      mutation_rate, sigma,   low,            high,
                      blend_scale, alpha,     sum_lead,      ev};
  return float_genes
             ? launch<float>(pop, fitness, seed, seed_stride, pop_size, cum,
                             new_pop, fit_out, n_islands, p, stream)
             : launch<int8_t>(pop, fitness, seed, seed_stride, pop_size, cum,
                              new_pop, fit_out, n_islands, p, stream);
}

