// The selection plan of one GA generation, every island in one launch.
//
// Replaces: the selection_plan that src/repro/kernels/ga/tiling.py::
// generation_tiled computes in XLA before its pallas_call (tiling.py:168),
// for the tiled generation kernel (generation_tiled.cu), which the island
// model reaches through kernels/ga/ops.py under EAConfig(impl=
// "pallas_tiled"), or under impl="pallas" above the untiled kernels' limits.
//
// What it computes (kernels/ga/common.py::selection_plan): five (I, n)
// int32 vectors aligned with the output rows. Rows [0, elite) hold the
// elite of the valid lanes (iterative masked argmax, ties to the lowest
// index) with cuts and gate 0; each child row holds its tournament or
// roulette parents, its two-point cuts and its crossover gate, drawn with
// the counters and salts of plan_rows.cuh, the code the untiled kernels
// run.
//
// Bound on the H100: operations, and far below any launch. At Fig. 4's
// 10,000 rows a child row costs 2k + 3 Threefry draws (67 int32 operations
// each): about 4.7e6 operations, 0.14 us at 33.5 T int32 operations/s; the
// bytes are the fitness in and the plan out, 240 KB, 0.07 us at 3.35 TB/s.
//
// Design: one block per island, since the elite and the roulette CDF are
// island-wide. The elite is a block-wide argmax per pick over a scratch
// copy of the masked fitness, the pick then set to -inf. The CDF is one
// thread's left-to-right scan into device memory (serial, as the plain
// version's order demands; 10,000 lanes take tens of microseconds), its
// minimum a block-wide reduction, and each roulette draw a binary search
// of it. The child rows then go one per thread. The masked fitness and the
// CDF live in device scratch the wrapper allocates, so n has no limit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "plan_rows.cuh"
#include "threefry.cuh"

namespace {

constexpr int PLAN_THREADS = 512;
constexpr int PLAN_WARPS = PLAN_THREADS / 32;

struct PlanParams {
  int n, L, elite, selection, tournament_k, crossover;
  float crossover_rate;
};

// (v, i) becomes the larger of itself and (v2, i2), the lower index on a
// tie: the order of torch.argmax.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2,
                                             int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// The block's argmax of x[0, n), lowest index on a tie; every thread gets
// it. Every thread of the block must call it.
__device__ int block_argmax(const float* x, int n, float* red_v,
                            int* red_i) {
  float v = neg_inf();
  int i = INT_MAX;
  for (int r = threadIdx.x; r < n; r += blockDim.x)
    argmax_merge(v, i, x[r], r);
  for (int off = 16; off > 0; off >>= 1)
    argmax_merge(v, i, __shfl_down_sync(0xffffffffu, v, off),
                 __shfl_down_sync(0xffffffffu, i, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < PLAN_WARPS ? red_v[lane] : neg_inf();
    i = lane < PLAN_WARPS ? red_i[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1)
      argmax_merge(v, i, __shfl_down_sync(0xffffffffu, v, off),
                   __shfl_down_sync(0xffffffffu, i, off));
    if (lane == 0) red_i[0] = i;
  }
  __syncthreads();
  const int best = red_i[0];
  __syncthreads();  // red_* are reused by the next call
  return best;
}

// The block's smallest finite value of x[0, n) (+inf when none); fminf is
// exact, so any order gives the serial scan's value.
__device__ float block_finite_min(const float* x, int n, float* red_v) {
  float v = pos_inf();
  for (int r = threadIdx.x; r < n; r += blockDim.x)
    if (isfinite(x[r])) v = fminf(v, x[r]);
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red_v[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < PLAN_WARPS ? red_v[lane] : pos_inf();
    for (int off = 16; off > 0; off >>= 1)
      v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) red_v[0] = v;
  }
  __syncthreads();
  const float lo = red_v[0];
  __syncthreads();
  return lo;
}

__global__ void __launch_bounds__(PLAN_THREADS)
selection_plan_kernel(const float* __restrict__ fitness,
                      const int64_t* __restrict__ seed, int seed_stride,
                      const int* __restrict__ pop_size,
                      float* masked_buf, float* cum_buf,
                      int* __restrict__ plan,
                      int n_islands, PlanParams p) {
  __shared__ float red_v[PLAN_WARPS];
  __shared__ int red_i[PLAN_WARPS];
  const int n = p.n, elite = p.elite;
  const int isl = blockIdx.x;
  // the key words are int64 holding 32-bit values: keep the low word
  const int64_t* words = seed + (size_t)isl * seed_stride;
  const uint32_t k0 = (uint32_t)words[0], k1 = (uint32_t)words[1];
  const int size = pop_size[isl];
  const uint32_t maxval = (uint32_t)max(size, 1);
  const float* fit = fitness + (size_t)isl * n;
  float* masked = masked_buf + (size_t)isl * n;
  float* cum = cum_buf + (size_t)isl * n;
  // plan rows: (5, I, n), the fields in SelectionPlan's order
  const size_t field = (size_t)n_islands * n;
  int* idx_a = plan + (size_t)isl * n;
  int* idx_b = idx_a + field;
  int* cut1 = idx_b + field;
  int* cut2 = cut1 + field;
  int* gate = cut2 + field;

  // ---- masked fitness, and a copy (in cum) for the elite picks
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const float v = r < size ? fit[r] : neg_inf();
    masked[r] = v;
    cum[r] = v;
  }
  __syncthreads();

  // ---- elite: argmax, then that lane drops to -inf
  for (int e = 0; e < elite; ++e) {
    const int best = block_argmax(cum, n, red_v, red_i);
    if (threadIdx.x == 0) {
      idx_a[e] = idx_b[e] = best;
      cut1[e] = cut2[e] = gate[e] = 0;
      cum[best] = neg_inf();
    }
    __syncthreads();
  }

  // ---- the roulette CDF
  if (p.selection == 1) {
    const float lo = block_finite_min(masked, n, red_v);
    if (threadIdx.x == 0) roulette_cdf(masked, n, lo, cum);
    __syncthreads();
  }

  // ---- one child row per thread
  for (int c = threadIdx.x; c < n - elite; c += blockDim.x) {
    const int row = elite + c;
    const RowPlan rp = child_row_plan(k0, k1, c, masked, cum, n, maxval,
                                      p.selection, p.tournament_k,
                                      p.crossover, p.L, p.crossover_rate);
    idx_a[row] = rp.a;
    idx_b[row] = rp.b;
    cut1[row] = rp.cut1;
    cut2[row] = rp.cut2;
    gate[row] = rp.gate;
  }
}

}  // namespace

extern "C" int selection_plan_launch(
    const void* fitness, const void* seed, int seed_stride,
    const void* pop_size, void* masked, void* cum, void* plan, int n_islands,
    int n, int L, int elite, int selection, int tournament_k, int crossover,
    float crossover_rate, void* stream) {
  const PlanParams p{n, L, elite, selection, tournament_k, crossover,
                     crossover_rate};
  selection_plan_kernel<<<n_islands, PLAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)fitness, (const int64_t*)seed, seed_stride,
      (const int*)pop_size, (float*)masked, (float*)cum, (int*)plan,
      n_islands, p);
  return (int)cudaGetLastError();
}
