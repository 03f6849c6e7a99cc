// The selection plan of one child row, shared by the generation kernels
// (generation.cu, generation_float.cu, generation_tiled.cu): the two
// parents (tournament or roulette), the two-point cuts and the crossover
// gate of output row elite + c, drawn with the counters and salts of
// kernels/ga/common.py::selection_plan. Also the roulette CDF in
// common.py::prefix_sum's segmented order (SCAN_SEGMENT lanes left to
// right, then each segment's carry; by one warp in the untiled kernels,
// roulette_cdf.cu runs the same order across a block), and the elite, an
// arg-max across warps. The plan and the elite read the island's
// masked fitness through `masked[r]`: a float array in shared memory (the
// untiled kernels) or MaskedFitness, which reads device memory (the tiled
// kernel).
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// An island's fitness with -inf on the lanes at or past its size, read
// from device memory.
struct MaskedFitness {
  const float* fit;
  int size;
  __device__ __forceinline__ float operator[](int r) const {
    return r < size ? fit[r] : neg_inf();
  }
};

// The roulette scan's segment (common.py's SCAN_SEGMENT): lanes
// [64 s, 64 s + 64) are summed left to right, then the segment's carry is
// added to each.
constexpr int SCAN_SEGMENT = 64;

// A lane's roulette weight: (v - lo) + 1e-6 on a finite lane, 0 elsewhere.
__device__ __forceinline__ float roulette_weight(float v, float lo) {
  return isfinite(v) ? __fadd_rn(__fsub_rn(v, lo), 1e-6f) : 0.0f;
}

// The roulette CDF of one island by one whole warp, in common.py::
// prefix_sum's order: local[j], the left-to-right sum of the weights from
// j's segment's first lane, and cum[j] = carry_s + local[j], where carry_0
// = 0 and carry_{s+1} = cum[64 s + 63]. The warp takes 32 segments a pass:
// lane i scans segment i into cum, then every lane runs the carry chain
// over the pass's 32 segment totals (passed lane to lane by shuffles,
// the same adds in every lane) and keeps its own segment's carry, which
// it adds to its lanes. The weights are non-negative and f32 addition
// rounds monotonically, so cum never decreases. `lo` is the island's
// smallest finite value (fminf, exact in any order).
__device__ __forceinline__ void roulette_cdf_warp(const float* masked, int n,
                                                  float* cum) {
  const int lane = threadIdx.x & 31;
  float lo = pos_inf();
  for (int r = lane; r < n; r += 32)
    if (isfinite(masked[r])) lo = fminf(lo, masked[r]);
  for (int off = 16; off > 0; off >>= 1)
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
  float carry = 0.0f;  // into the pass's first segment, alike in all lanes
  for (int base = 0; base < n; base += 32 * SCAN_SEGMENT) {
    const int s0 = base + lane * SCAN_SEGMENT;
    const int len = max(0, min(SCAN_SEGMENT, n - s0));
    float acc = 0.0f;
    for (int j = 0; j < len; ++j) {
      acc = __fadd_rn(acc, roulette_weight(masked[s0 + j], lo));
      cum[s0 + j] = acc;
    }
    float mine = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float total = __shfl_sync(0xffffffffu, acc, i);
      if (i == lane) mine = carry;
      carry = __fadd_rn(carry, total);
    }
    for (int j = 0; j < len; ++j) cum[s0 + j] = __fadd_rn(mine, cum[s0 + j]);
  }
}

// The number of lanes j with cum[j] <= u, the plain version's count: cum
// does not decrease, so those lanes are a prefix and a binary search finds
// its end.
__device__ __forceinline__ int count_at_most(const float* cum, int n,
                                             float u) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= u)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// (v, i) becomes the larger of itself and (v2, i2), the lower index on a
// tie: the order of torch.argmax.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2,
                                             int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// The elite of one island into out[0, elite): `elite` passes of an arg-max
// over masked[0, n), the largest value first and the lowest index on a
// tie, each pass counting the rows already picked as -inf. For values
// without NaN that is what the serial loop
//   v = picked(r) ? -inf : masked[r]; if (r == 0 || v > best) take r
// picks: with every lane -inf (padded, or picked) row 0 wins again, runs of
// equal values go to their first row, one lane gives row 0. A NaN never
// wins here (row 0 does when nothing else can), where the serial loop kept
// a NaN in row 0 and the plain version's torch.argmax takes the first NaN;
// fitness on every path is finite or -inf.
// Each pass: every thread takes the arg-max of a strided slice, each warp
// merges its lanes by shuffles, and after named barrier 1 every thread
// merges the warps' results itself, so the pick needs no second barrier.
// Run by the first `warps` warps of the block only, which meet at named
// barrier 1 and nowhere else, so another warp can work beside them. `red`
// is 4 * warps words of scratch (two buffers, passes alternate). out[e] is
// written by thread 0; the block sees all of out after its next
// __syncthreads().
template <typename Masked>
__device__ void elite_rows(const Masked& masked, int n, int elite, int warps,
                           float* red, int* out) {
  const int nthreads = warps * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int last = -1;  // the previous pass's pick; earlier ones are in out
  for (int e = 0; e < elite; ++e) {
    float v = neg_inf();
    int i = INT_MAX;
    for (int r = threadIdx.x; r < n; r += nthreads) {
      bool picked = r == last;
      for (int j = 0; j + 1 < e; ++j) picked |= out[j] == r;
      argmax_merge(v, i, picked ? neg_inf() : masked[r], r);
    }
    for (int off = 16; off > 0; off >>= 1)
      argmax_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off),
                   __shfl_xor_sync(0xffffffffu, i, off));
    float* red_v = red + (e & 1) * 2 * warps;
    int* red_i = reinterpret_cast<int*>(red_v + warps);
    if (lane == 0) {
      red_v[warp] = v;
      red_i[warp] = i;
    }
    named_barrier_sync(1, nthreads);
    v = red_v[0];
    i = red_i[0];
    for (int w = 1; w < warps; ++w) argmax_merge(v, i, red_v[w], red_i[w]);
    if (i == INT_MAX) i = 0;  // only NaN left
    if (threadIdx.x == 0) out[e] = i;
    last = i;
  }
}

struct RowPlan {
  int a, b, cut1, cut2, gate;
};

// The plan of child c. masked is the island's fitness with -inf on padded
// lanes (n lanes), cum its roulette CDF (read under roulette only), maxval
// max(pop_size, 1). selection: 0 tournament, 1 roulette; crossover: 0
// two-point (draws the cuts), else none.
template <typename Masked>
__device__ __forceinline__ RowPlan child_row_plan(
    uint32_t k0, uint32_t k1, int c, const Masked& masked, const float* cum,
    int n, uint32_t maxval, int selection, int tournament_k, int crossover,
    int L, float crossover_rate) {
  RowPlan rp;
  int par[2];
  const uint32_t salts[2] = {SALT_SELECT_A, SALT_SELECT_B};
  for (int s = 0; s < 2; ++s) {
    if (selection == 0) {
      float best = 0.0f;
      int win = 0;
      for (int j = 0; j < tournament_k; ++j) {
        const int cand = randint_at(
            k0, k1, (uint32_t)c * (uint32_t)tournament_k + (uint32_t)j,
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
      par[s] = min(count_at_most(cum, n, u), (int)maxval - 1);
    }
  }
  rp.a = par[0];
  rp.b = par[1];
  if (crossover == 0) {
    const uint32_t span = (uint32_t)L + 1u;
    const int x = randint_at(k0, k1, (uint32_t)c * 2u, SALT_CROSSOVER, span);
    const int y =
        randint_at(k0, k1, (uint32_t)c * 2u + 1u, SALT_CROSSOVER, span);
    rp.cut1 = min(x, y);
    rp.cut2 = max(x, y);
  } else {
    rp.cut1 = rp.cut2 = 0;
  }
  rp.gate = bernoulli_at(k0, k1, (uint32_t)c, SALT_CROSSOVER_GATE,
                         crossover_rate);
  return rp;
}

}  // namespace
