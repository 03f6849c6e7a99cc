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
// adds 1e8 f32 operations (1.5 us at 67 TFLOP/s). The bytes are a
// population in and one out, 16 MB, 5 us at 3.35 TB/s.
//
// Design: an island's f32 tile (1 MB at 256 x 1000) does not fit a block's
// shared memory, so the binary kernel's two resident tiles do not carry
// over. The grid is (row blocks, islands): each block recomputes the
// island's elite and roulette CDF (256 lanes, cheap) and draws the plan of
// its own ROWS rows; counter-based draws make every block's plan the one a
// single block would draw. Parents are read straight from the island's
// input population in device memory (8 MB for 8 islands, held in L2) and
// children are written straight out, consecutive threads on consecutive
// genes. Only the plan and the rows under fused evaluation live in shared
// memory. The F15 tail stages z = kid - o through perm and runs f15_rows,
// the device function of the F15 kernel. Every f32 step is an explicit
// intrinsic: the blend and the mutation are the fused multiply-adds that
// XLA makes of them in the reference (__fmaf_rn; the plain version computes
// them exactly rounded with rand.fma), every other step is rounded alone.
// So kernel and plain version agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../rastrigin/csrc/f15_rows.cuh"
#include "plan_rows.cuh"
#include "row_evals.cuh"
#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;

struct FloatParams {
  int n, L, elite, selection, tournament_k, crossover;
  float crossover_rate, mutation_rate, sigma, low, high, blend_scale, alpha;
  int eval_kind, sum_group, m, n_groups, k_group;
};

__host__ __device__ inline size_t float_smem_bytes(int n, int L, int elite) {
  // masked, cum (f32) + elite (i32) + the plan of ROWS rows (5 x i32)
  // + two ROWS x L f32 row buffers
  return ((size_t)2 * n + elite + 5 * ROWS) * 4 +
         2 * (size_t)ROWS * (size_t)L * 4;
}

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
  int* idx_a = elite_idx + elite;
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

  // ---- phase 1a: elite (lowest index wins ties) and the roulette CDF
  if (threadIdx.x == 0) {
    for (int e = 0; e < elite; ++e) {
      float best = 0.0f;
      int best_i = 0;
      for (int r = 0; r < n; ++r) {
        float v = masked[r];
        for (int j = 0; j < e; ++j)
          if (elite_idx[j] == r) v = neg_inf();
        if (r == 0 || v > best) {
          best = v;
          best_i = r;
        }
      }
      elite_idx[e] = best_i;
    }
  } else if (threadIdx.x == 32 && p.selection == 1) {
    roulette_cdf(masked, n, finite_min(masked, n), cum);
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
    f15_rows(buf1, buf0, rows, L, p.m, p.n_groups, p.k_group, M, out, -1.0f);
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

}  // namespace

extern "C" int generation_float_smem_bytes(int n, int L, int elite) {
  return (int)float_smem_bytes(n, L, elite);
}

extern "C" int generation_float_launch(
    const void* pop, const void* fitness, const void* seed, int seed_stride,
    const void* pop_size, const void* o, const void* perm, const void* M,
    void* new_pop, void* fit_out, int n_islands, int n, int L, int elite,
    int selection, int tournament_k, int crossover, float crossover_rate,
    float mutation_rate, float sigma, float low, float high,
    float blend_scale, float alpha, int eval_kind, int sum_group, int m,
    int n_groups, int k_group, void* stream) {
  const FloatParams p{n,          L,           elite,         selection,
                      tournament_k, crossover, crossover_rate, mutation_rate,
                      sigma,      low,         high,          blend_scale,
                      alpha,      eval_kind,   sum_group,     m,
                      n_groups,   k_group};
  const size_t smem = float_smem_bytes(n, L, elite);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        generation_float_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + ROWS - 1) / ROWS, n_islands);
  generation_float_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)pop, (const float*)fitness, (const int64_t*)seed,
      seed_stride, (const int*)pop_size, (const float*)o, (const int*)perm,
      (const float*)M, (float*)new_pop, (float*)fit_out, p);
  return (int)cudaGetLastError();
}
