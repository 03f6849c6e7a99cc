// One GA generation of float genomes, a few output rows per block.
//
// Replaces: the float half of src/repro/kernels/ga/generation.py::
// generation_kernel (the Pallas bodies _generation_kernel and
// _generation_eval_kernel with f32 populations, and the f15 operands o, perm
// and M), which the island model reaches through
// kernels/ga/ops.py::generation[_eval] under EAConfig(impl="pallas").
//
// What it computes (kernels/ga/common.py::generation_math): the elite of the
// valid lanes, tournament or roulette parents, two-point, uniform or blend
// crossover behind a rate gate, gaussian mutation where a Bernoulli hits,
// the clip of child rows to the genome's bounds, and optionally the
// rastrigin / sphere / F15 fitness of the new rows. All randomness is the
// counter Threefry of threefry.cuh, with the counters and salts of the
// plain version; the normal is drawn only where the mutation hits, and a
// counter-based stream makes it the same value the plain version's
// whole-array normal has there.
//
// Bound on the H100: operations. At the F15 path's 8 x 256 x 1000 a child
// gene costs one Threefry for the mutation test and one for the blend on
// gated rows (67 int32 operations each, as compiled): about 2.6e8 int32
// operations, 8 us at 128 int32 operations per SM per clock. The fused F15
// adds 2.3e8 f32 operations, 2.05e8 of them the rotation's separately
// rounded multiplies and adds (3.4 us at 67 TFLOP/s). The bytes are a
// population in and one out, 16 MB, 5 us at 3.35 TB/s. What held the first
// design back was its F15 tail, one thread per output with two loads per
// multiply-add, which read the 200 KB rotation stack once per row through
// L2 (410 MB per call), and the elite, found by one thread in every block.
//
// Design: an island's f32 tile (1 MB at 256 x 1000) does not fit a block's
// shared memory. The grid is (row blocks, islands): each block recomputes
// the island's elite (an arg-max across eight warps, plan_rows.cuh::
// elite_rows) beside its roulette CDF (the ninth warp, in the segmented
// order of plan_rows.cuh::roulette_cdf_warp) and draws the plan of its own ROWS rows; counter-based draws
// make every block's plan the one a single block would draw. Parents are
// read straight from the island's input population in device memory (8 MB
// for 8 islands, held in L2) and children are written straight out,
// consecutive threads on consecutive genes. Only the plan and the rows
// under fused evaluation live in shared memory. The F15 tail stages
// z = kid - o through perm and runs f15_rows, the device function of the
// F15 kernel, register-blocked: a thread holds all ROWS rows x 4 columns
// of one group, so the block reads each element of M once and each load
// serves 4 or ROWS multiply-adds. ROWS is a template argument, 4
// (kernels/ga/generation.py FLOAT_ROWS), or 2 or 1 where the wrapper finds
// that 2 ROWS x L floats would not fit the card's shared memory per block,
// so every island the first design (4 rows) ran still runs, and wider ones
// too. Only a block whose rows start below `elite` finds the elite; the
// others read no elite row and skip it.
// Every f32 step is an explicit intrinsic: the blend and the mutation are
// the fused multiply-adds that XLA makes of them in the reference
// (__fmaf_rn; the plain version computes them exactly rounded with
// rand.fma), every other step is rounded alone. So kernel and plain
// version agree bit for bit.
//
// Measured (chip_smoke.py phase 6, CUDA events, on an NVIDIA H100 80GB
// HBM3 at 700.00 W): 0.05472 ms at 8 x 256 x 1000 with fused F15 and 4
// rows per block, against 0.1432 ms for the first design, and 0.0590 ms
// at 8 rows and 0.0768 ms at 16, timed in turns when ROWS was chosen. More
// rows per block read M less often but hold more registers (56, 90 and 136
// a thread at 4, 8 and 16 rows), so fewer blocks share an SM and hide the
// loads' latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../rastrigin/csrc/f15_rows.cuh"
#include "plan_rows.cuh"
#include "row_evals.cuh"
#include "threefry.cuh"

namespace {

// 9 warps: the F15 tail's 260 micro-tiles at m 50 (20 groups x 13 column
// quads) go in one pass; the elite takes 8 warps, the CDF the ninth
constexpr int THREADS = 288;
constexpr int ELITE_WARPS = THREADS / 32 - 1;

struct FloatParams {
  int n, L, elite, selection, tournament_k, crossover;
  float crossover_rate, mutation_rate, sigma, low, high, blend_scale, alpha;
  int eval_kind, sum_group, m, n_groups, k_group;
};

__host__ __device__ inline size_t float_smem_bytes(int n, int L, int elite,
                                                   int rows) {
  // two rows x L f32 row buffers + masked, cum (f32) + elite (i32) + the
  // arg-max scratch + the plan of `rows` rows (5 x i32)
  return 2 * (size_t)rows * (size_t)L * 4 +
         ((size_t)2 * n + elite + 4 * ELITE_WARPS + 5 * rows) * 4;
}

template <int ROWS>
__global__ void __launch_bounds__(THREADS)
generation_float_kernel(const float* __restrict__ pop,
                        const float* __restrict__ fitness,
                        const int64_t* __restrict__ seed, int seed_stride,
                        const int* __restrict__ pop_size,
                        const float* __restrict__ o,
                        const int* __restrict__ perm,
                        const float* __restrict__ M,
                        float* __restrict__ new_pop,
                        float* __restrict__ fit_out, FloatParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = p.n, L = p.L, elite = p.elite;
  float* buf0 = reinterpret_cast<float*>(smem);
  float* buf1 = buf0 + (size_t)ROWS * L;
  float* masked = buf1 + (size_t)ROWS * L;
  float* cum = masked + n;
  int* elite_idx = reinterpret_cast<int*>(cum + n);
  float* red = reinterpret_cast<float*>(elite_idx + elite);
  int* idx_a = reinterpret_cast<int*>(red + 4 * ELITE_WARPS);
  int* idx_b = idx_a + ROWS;
  int* cut1 = idx_b + ROWS;
  int* cut2 = cut1 + ROWS;
  int* gate = cut2 + ROWS;

  const int isl = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, n - row0);
  // the key words are int64 holding 32-bit values: keep the low word
  const int64_t* words = seed + (size_t)isl * seed_stride;
  const uint32_t k0 = (uint32_t)words[0], k1 = (uint32_t)words[1];
  const int size = pop_size[isl];
  const uint32_t maxval = (uint32_t)max(size, 1);
  const float* src = pop + (size_t)isl * n * L;
  const float* fit = fitness + (size_t)isl * n;

  // ---- phase 0: masked fitness
  for (int r = threadIdx.x; r < n; r += blockDim.x)
    masked[r] = r < size ? fit[r] : neg_inf();
  __syncthreads();

  // ---- phase 1a: the elite (an arg-max across warps, lowest index on a
  // tie; only where this block's rows start below it) beside the roulette
  // CDF (the last warp, in the segmented order)
  if (threadIdx.x < ELITE_WARPS * 32) {
    if (row0 < elite)
      elite_rows(masked, n, elite, ELITE_WARPS, red, elite_idx);
  } else if (p.selection == 1) {
    roulette_cdf_warp(masked, n, cum);
  }
  __syncthreads();

  // ---- phase 1b: the plan of this block's rows
  if (threadIdx.x < rows) {
    const int t = threadIdx.x, row = row0 + t;
    if (row < elite) {
      idx_a[t] = idx_b[t] = elite_idx[row];
      cut1[t] = cut2[t] = gate[t] = 0;
    } else {
      const RowPlan rp = child_row_plan(
          k0, k1, row - elite, masked, cum, n, maxval, p.selection,
          p.tournament_k, p.crossover, L, p.crossover_rate);
      idx_a[t] = rp.a;
      idx_b[t] = rp.b;
      cut1[t] = rp.cut1;
      cut2[t] = rp.cut2;
      gate[t] = rp.gate;
    }
  }
  __syncthreads();

  // ---- phase 2: crossover, mutation and clip, one thread per gene
  float* dst = new_pop + ((size_t)isl * n + row0) * L;
  for (int i = threadIdx.x; i < rows * L; i += blockDim.x) {
    const int t = i / L, col = i - t * L, row = row0 + t;
    const float pa = src[(size_t)idx_a[t] * L + col];
    float kid = pa;
    if (row >= elite) {
      const uint32_t ctr = (uint32_t)(row - elite) * (uint32_t)L + (uint32_t)col;
      if (gate[t]) {
        const float pb = src[(size_t)idx_b[t] * L + col];
        if (p.crossover == 0) {
          kid = (col >= cut1[t] && col < cut2[t]) ? pb : pa;
        } else if (p.crossover == 1) {
          kid = bernoulli_at(k0, k1, ctr, SALT_CROSSOVER, 0.5f) ? pb : pa;
        } else {
          const float u = __fmaf_rn(uniform_at(k0, k1, ctr, SALT_CROSSOVER),
                                    p.blend_scale, -p.alpha);
          kid = __fmaf_rn(u, __fsub_rn(pb, pa), pa);
        }
      }
      if (bernoulli_at(k0, k1, ctr, SALT_MUTATE, p.mutation_rate))
        kid = __fmaf_rn(normal_at(k0, k1, ctr, SALT_MUTATE_NOISE), p.sigma,
                        kid);
      kid = fminf(fmaxf(kid, p.low), p.high);
    }
    buf0[i] = kid;
    dst[i] = kid;
  }

  // ---- phase 3: fused fitness of the new rows (negated: maximised)
  if (p.eval_kind == EVAL_NONE) return;
  __syncthreads();
  float* out = fit_out + (size_t)isl * n + row0;
  if (p.eval_kind == EVAL_F15) {
    for (int i = threadIdx.x; i < rows * L; i += blockDim.x) {
      const int t = i / L, j = i - t * L;
      const int q = perm[j];
      buf1[i] = __fsub_rn(buf0[(size_t)t * L + q], o[q]);
    }
    __syncthreads();
    f15_rows<ROWS>(buf1, buf0, rows, L, p.m, p.n_groups, p.k_group, M, out,
                   -1.0f);
    return;
  }
  for (int i = threadIdx.x; i < rows * L; i += blockDim.x) {
    const float x = buf0[i];
    buf1[i] = p.eval_kind == EVAL_RASTRIGIN ? rastrigin_term(x)
                                            : __fmul_rn(x, x);
  }
  __syncthreads();
  neg_grouped_row_sums(buf1, buf0, rows, L, p.sum_group, out);
}

template <int ROWS>
int launch(const void* pop, const void* fitness, const void* seed,
           int seed_stride, const void* pop_size, const void* o,
           const void* perm, const void* M, void* new_pop, void* fit_out,
           int n_islands, const FloatParams& p, void* stream) {
  const size_t smem = float_smem_bytes(p.n, p.L, p.elite, ROWS);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        generation_float_kernel<ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.n + ROWS - 1) / ROWS, n_islands);
  generation_float_kernel<ROWS><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)pop, (const float*)fitness, (const int64_t*)seed,
      seed_stride, (const int*)pop_size, (const float*)o, (const int*)perm,
      (const float*)M, (float*)new_pop, (float*)fit_out, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int generation_float_smem_bytes(int n, int L, int elite,
                                           int rows) {
  return (int)float_smem_bytes(n, L, elite, rows);
}

// rows: the output rows per block, 1, 2 or 4
extern "C" int generation_float_launch(
    const void* pop, const void* fitness, const void* seed, int seed_stride,
    const void* pop_size, const void* o, const void* perm, const void* M,
    void* new_pop, void* fit_out, int n_islands, int n, int L, int elite,
    int selection, int tournament_k, int crossover, float crossover_rate,
    float mutation_rate, float sigma, float low, float high,
    float blend_scale, float alpha, int eval_kind, int sum_group, int m,
    int n_groups, int k_group, int rows, void* stream) {
  const FloatParams p{n,          L,           elite,         selection,
                      tournament_k, crossover, crossover_rate, mutation_rate,
                      sigma,      low,         high,          blend_scale,
                      alpha,      eval_kind,   sum_group,     m,
                      n_groups,   k_group};
  switch (rows) {
#define ROWS_CASE(R)                                                        \
  case R:                                                                   \
    return launch<R>(pop, fitness, seed, seed_stride, pop_size, o, perm, M, \
                     new_pop, fit_out, n_islands, p, stream);
    ROWS_CASE(1) ROWS_CASE(2) ROWS_CASE(4)
#undef ROWS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
