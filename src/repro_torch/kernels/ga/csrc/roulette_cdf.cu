// The roulette CDF of one GA generation, every island in one launch.
//
// Replaces: the CDF step of the selection_plan that src/repro/kernels/ga/
// tiling.py::generation_tiled computes in XLA before its pallas_call
// (tiling.py:168; its _roulette's prefix sum), for the tiled generation
// kernel (generation_tiled.cu), which reads it under roulette selection and
// draws everything else of the plan itself. No paper configuration uses
// roulette, so the island paths and Fig. 4's row never launch it.
//
// What it computes (kernels/ga/common.py::roulette_cdf): per island, the
// weight (v - lo) + 1e-6 of each finite lane of the masked fitness (lo its
// smallest finite value; padded lanes and -inf weigh 0), summed from 0 left
// to right in f32 into an (I, n) vector.
//
// Bound on the H100: bytes, and far below a launch: the fitness in and the
// CDF out, 80 KB at Fig. 4's 10,000 lanes, 0.02 us at 3.35 TB/s. What the
// kernel takes is the scan's chain of n dependent f32 adds, about 4 clocks
// each.
//
// Design: one block per island. The minimum is a block-wide reduction
// (fminf is exact, so any order gives the serial scan's value); the scan is
// one thread's, left to right, because that order is the contract with the
// plain version's prefix_sum: a parallel scan would round differently. The
// island goes through shared memory in chunks: the whole block loads a
// chunk and turns it into weights (elementwise, so in any order), thread 0
// adds them up in place, and the block stores the sums, consecutive
// threads on consecutive lanes. So the scanning thread's loop is only its
// chain of adds over shared memory: a scan that loaded and stored device
// memory itself waited out a load's latency on every lane, since its loads
// could not pass its stores.
// Fitness is read with the island's size applied (MaskedFitness), so n has
// no limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plan_rows.cuh"

namespace {

constexpr int CDF_THREADS = 512;
constexpr int CDF_WARPS = CDF_THREADS / 32;
constexpr int CDF_CHUNK = 4096;  // lanes staged in shared memory at a time

// The block's smallest finite value of masked[0, n) (+inf when none).
__device__ float block_finite_min(const MaskedFitness& masked, int n,
                                  float* red) {
  float v = pos_inf();
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const float x = masked[r];
    if (isfinite(x)) v = fminf(v, x);
  }
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < CDF_WARPS ? red[lane] : pos_inf();
    for (int off = 16; off > 0; off >>= 1)
      v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__global__ void __launch_bounds__(CDF_THREADS)
roulette_cdf_kernel(const float* __restrict__ fitness,
                    const int* __restrict__ pop_size,
                    float* __restrict__ cum_buf, int n) {
  __shared__ float red[CDF_WARPS];
  __shared__ float chunk[CDF_CHUNK];
  const int isl = blockIdx.x;
  const MaskedFitness masked{fitness + (size_t)isl * n, pop_size[isl]};
  float* cum = cum_buf + (size_t)isl * n;
  const float lo = block_finite_min(masked, n, red);
  float acc = 0.0f;  // thread 0's running sum
  for (int base = 0; base < n; base += CDF_CHUNK) {
    const int len = min(CDF_CHUNK, n - base);
    for (int i = threadIdx.x; i < len; i += CDF_THREADS)
      chunk[i] = roulette_weight(masked[base + i], lo);
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 8
      for (int i = 0; i < len; ++i) {
        acc = __fadd_rn(acc, chunk[i]);
        chunk[i] = acc;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += CDF_THREADS)
      cum[base + i] = chunk[i];
    __syncthreads();
  }
}

}  // namespace

extern "C" int roulette_cdf_launch(const void* fitness, const void* pop_size,
                                   void* cum, int n_islands, int n,
                                   void* stream) {
  roulette_cdf_kernel<<<n_islands, CDF_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)fitness, (const int*)pop_size, (float*)cum, n);
  return (int)cudaGetLastError();
}
