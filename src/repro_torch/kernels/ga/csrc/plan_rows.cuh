// The selection plan of one child row, shared by the generation kernels
// (generation.cu, generation_float.cu) and the plan kernel (plan.cu): the
// two parents (tournament or roulette), the two-point cuts and the
// crossover gate of output row elite + c, drawn with the counters and salts
// of kernels/ga/common.py::selection_plan. Also the roulette CDF, a
// left-to-right f32 scan as common.py::prefix_sum takes it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// The smallest finite value of masked[0, n), +inf when none is finite.
__device__ __forceinline__ float finite_min(const float* masked, int n) {
  float lo = pos_inf();
  for (int r = 0; r < n; ++r)
    if (isfinite(masked[r])) lo = fminf(lo, masked[r]);
  return lo;
}

// The roulette CDF of one island, by one thread: weight (v - lo) + 1e-6 on
// a finite lane and 0 elsewhere, summed from 0 left to right. The weights
// are non-negative and f32 addition rounds monotonically, so cum never
// decreases.
__device__ __forceinline__ void roulette_cdf(const float* masked, int n,
                                             float lo, float* cum) {
  float acc = 0.0f;
  for (int r = 0; r < n; ++r) {
    const float v = masked[r];
    const float w = isfinite(v) ? __fadd_rn(__fsub_rn(v, lo), 1e-6f) : 0.0f;
    acc = __fadd_rn(acc, w);
    cum[r] = acc;
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

struct RowPlan {
  int a, b, cut1, cut2, gate;
};

// The plan of child c. masked is the island's fitness with -inf on padded
// lanes (n lanes), cum its roulette CDF (read under roulette only), maxval
// max(pop_size, 1). selection: 0 tournament, 1 roulette; crossover: 0
// two-point (draws the cuts), else none.
__device__ __forceinline__ RowPlan child_row_plan(
    uint32_t k0, uint32_t k1, int c, const float* masked, const float* cum,
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
