// One GA generation of any population size from a selection plan, binary
// or float genomes, a few output rows per block.
//
// Replaces: src/repro/kernels/ga/tiling.py::generation_tiled (the Pallas
// body _tiled_kernel), which the island model reaches through
// kernels/ga/ops.py under EAConfig(impl="pallas_tiled"), and impl="pallas"
// above the reference's 16 MiB untiled estimate: Fig. 4's 10,000 x 1000
// generation+F15 row (benchmarks/fig4_f15.py).
//
// What it computes (kernels/ga/common.py::child_tile_math on the parents
// the plan names): two-point, uniform or blend crossover behind the plan's
// gate, bit-flip or gaussian mutation, the clip of float child rows, and
// optionally the fitness of the new rows (trap / onemax / royal_road /
// rastrigin / sphere; F15 goes to the F15 kernel after this one, as in the
// reference). Gene c of output row r draws with counter (r - elite) * L + c
// and the salts of threefry.cuh, the untiled kernels' counters, so for any
// rows per block the output equals theirs bit for bit, fitness included.
// The plan comes from plan.cu.
//
// Bound on the H100: operations. At Fig. 4's 10,000 x 1000 f32 a child
// gene costs one Threefry for its mutation test and one for the blend on
// the 90 % of rows whose gate is on, 67 int32 operations each as compiled:
// about 1.3e9 int32 operations, 39 us at 33.5 T/s, against 80 MB of
// population in and out, 24 us at 3.35 TB/s.
//
// Design: the TPU kernel gathered parents by one-hot matmuls over a grid of
// (row tiles x gene tiles x source blocks), accumulating in VMEM scratch
// across the sequential source axis. Blocks on this card run in no order
// and device memory serves a gather directly, so the source axis is gone:
// each block takes `rows` output rows of one island (grid: row blocks x
// islands), loads their plan into shared memory and reads pop[idx_a[r], c]
// (and pop[idx_b[r], c] where the gate is on) straight from device memory,
// consecutive threads on consecutive genes, writing children straight out.
// Genes are not tiled: a block covers whole rows, so a fused separable
// fitness is summed per row in the untiled kernels' order from the rows
// staged in shared memory, instead of per gene tile as on the TPU. Shared
// memory is the plan and, under a fused eval, the staged rows; the wrapper
// raises for a `rows` above what the card holds. Row offsets are size_t:
// eight islands of 64k x 1000 f32 pass 2^31 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../rastrigin/csrc/f15_rows.cuh"
#include "row_evals.cuh"
#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PLAN_FIELDS = 5;

struct TiledParams {
  int n, L, elite, rows, crossover;
  float mutation_rate, sigma, low, high, blend_scale, alpha;
  int sum_group;  // rastrigin / sphere: ordered_sum's group
  BinaryEval ev;  // ev.kind: the fused eval of either genome kind
};

__host__ __device__ inline size_t tiled_smem_bytes(int rows, int L,
                                                   bool float_genes,
                                                   int eval_kind,
                                                   int sum_group) {
  size_t bytes = (size_t)PLAN_FIELDS * rows * sizeof(int);
  if (eval_kind == EVAL_NONE) return bytes;
  if (!float_genes) return bytes + (size_t)rows * L;  // the int8 rows
  const size_t n_parts = (L + sum_group - 1) / sum_group;
  return bytes + (size_t)rows * ((size_t)L + n_parts) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
generation_tiled_kernel(const T* __restrict__ pop,
                        const int* __restrict__ plan,
                        const int64_t* __restrict__ seed, int seed_stride,
                        T* __restrict__ new_pop, float* __restrict__ fit_out,
                        int n_islands, TiledParams p) {
  constexpr bool FLOAT_GENES = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = p.n, L = p.L, elite = p.elite;
  const int isl = blockIdx.y;
  const int row0 = blockIdx.x * p.rows;
  const int rows = min(p.rows, n - row0);
  int* s_plan = reinterpret_cast<int*>(smem);
  const int* idx_a = s_plan;
  const int* idx_b = idx_a + rows;
  const int* cut1 = idx_b + rows;
  const int* cut2 = cut1 + rows;
  const int* gate = cut2 + rows;
  // under a fused eval: the new int8 rows, or the float rows' terms
  int8_t* s_kids = reinterpret_cast<int8_t*>(s_plan + PLAN_FIELDS * p.rows);
  float* s_terms = reinterpret_cast<float*>(s_plan + PLAN_FIELDS * p.rows);

  // the key words are int64 holding 32-bit values: keep the low word
  const int64_t* words = seed + (size_t)isl * seed_stride;
  const uint32_t k0 = (uint32_t)words[0], k1 = (uint32_t)words[1];

  // ---- phase 1: this block's rows of the five (I, n) plan vectors
  const size_t field = (size_t)n_islands * n;
  for (int i = threadIdx.x; i < PLAN_FIELDS * rows; i += blockDim.x) {
    const int f = i / rows, t = i - f * rows;
    s_plan[i] = plan[f * field + (size_t)isl * n + row0 + t];
  }
  __syncthreads();

  // ---- phase 2: crossover, mutation (and clip), one thread per gene
  const T* src = pop + (size_t)isl * n * L;
  T* dst = new_pop + ((size_t)isl * n + row0) * L;
  const bool fused = p.ev.kind != EVAL_NONE;
  for (int i = threadIdx.x; i < rows * L; i += blockDim.x) {
    const int t = i / L, col = i - t * L, row = row0 + t;
    const T pa = src[(size_t)idx_a[t] * L + col];
    T kid = pa;
    if (row >= elite) {
      const uint32_t ctr =
          (uint32_t)(row - elite) * (uint32_t)L + (uint32_t)col;
      if (gate[t]) {
        const T pb = src[(size_t)idx_b[t] * L + col];
        if (p.crossover == 0) {
          kid = (col >= cut1[t] && col < cut2[t]) ? pb : pa;
        } else if (p.crossover == 1) {
          kid = bernoulli_at(k0, k1, ctr, SALT_CROSSOVER, 0.5f) ? pb : pa;
        } else if constexpr (FLOAT_GENES) {
          const float u = __fmaf_rn(uniform_at(k0, k1, ctr, SALT_CROSSOVER),
                                    p.blend_scale, -p.alpha);
          kid = __fmaf_rn(u, __fsub_rn(pb, pa), pa);
        }
      }
      const bool hit = bernoulli_at(k0, k1, ctr, SALT_MUTATE, p.mutation_rate);
      if constexpr (FLOAT_GENES) {
        if (hit)
          kid = __fmaf_rn(normal_at(k0, k1, ctr, SALT_MUTATE_NOISE), p.sigma,
                          kid);
        kid = fminf(fmaxf(kid, p.low), p.high);
      } else {
        if (hit) kid = (int8_t)(1 - kid);
      }
    }
    dst[i] = kid;
    if (fused) {
      if constexpr (FLOAT_GENES)
        s_terms[i] = p.ev.kind == EVAL_RASTRIGIN ? rastrigin_term(kid)
                                                 : __fmul_rn(kid, kid);
      else
        s_kids[i] = kid;
    }
  }

  // ---- phase 3: fused fitness of the new rows, in the untiled order
  if (!fused) return;
  __syncthreads();
  float* out = fit_out + (size_t)isl * n + row0;
  if constexpr (FLOAT_GENES) {
    neg_grouped_row_sums(s_terms, s_terms + (size_t)rows * L, rows, L,
                         p.sum_group, out);
  } else {
    for (int t = threadIdx.x; t < rows; t += blockDim.x)
      out[t] = binary_row_fitness(s_kids + (size_t)t * L, p.ev);
  }
}

template <typename T>
int launch(const void* pop, const void* plan, const void* seed,
           int seed_stride, void* new_pop, void* fit_out, int n_islands,
           const TiledParams& p, void* stream) {
  const size_t smem =
      tiled_smem_bytes(p.rows, p.L, std::is_same<T, float>::value, p.ev.kind,
                       p.sum_group);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        generation_tiled_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.n + p.rows - 1) / p.rows, n_islands);
  generation_tiled_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)pop, (const int*)plan, (const int64_t*)seed, seed_stride,
      (T*)new_pop, (float*)fit_out, n_islands, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int generation_tiled_smem_bytes(int rows, int L, int float_genes,
                                           int eval_kind, int sum_group) {
  return (int)tiled_smem_bytes(rows, L, float_genes != 0, eval_kind,
                               sum_group);
}

extern "C" int generation_tiled_launch(
    const void* pop, const void* plan, const void* seed, int seed_stride,
    void* new_pop, void* fit_out, int float_genes, int n_islands, int n,
    int L, int elite, int rows, int crossover, float mutation_rate,
    float sigma, float low, float high, float blend_scale, float alpha,
    int eval_kind, int sum_group, int trap_l, int trap_group, float a,
    float b, float z, float l_minus_z, int royal_r, void* stream) {
  const BinaryEval ev{eval_kind, L, trap_l, trap_group, a, b, z, l_minus_z,
                      royal_r};
  const TiledParams p{n,     L,     elite, rows,        crossover,
                      mutation_rate, sigma, low,   high,
                      blend_scale,   alpha, sum_group, ev};
  return float_genes
             ? launch<float>(pop, plan, seed, seed_stride, new_pop, fit_out,
                             n_islands, p, stream)
             : launch<int8_t>(pop, plan, seed, seed_stride, new_pop, fit_out,
                              n_islands, p, stream);
}
