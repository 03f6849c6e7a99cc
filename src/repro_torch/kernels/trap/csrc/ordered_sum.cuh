// The f32 order of kernels/trap/ref.py::ordered_sum, the order XLA's CPU
// backend gives a row reduction: n > 32 terms in windows of 32 over the row
// padded with 32 * ceil(n / 32) - n zeros, half of them (rounded down)
// before it, so the first window holds window_lead(n) terms, the next ones
// 32 and the last the rest; each window summed from 0 left to right, and
// the window sums summed by the same rule while more than 32 are left. Up
// to 32 terms it is one left-to-right sum from 0. Every add is a
// round-to-nearest intrinsic, so nothing contracts into an FMA.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int SUM_WINDOW = 32;
constexpr int SUM_LEVELS = 4;  // windowed levels: rows of up to 32^5 terms

// terms in the first window of n (all of them up to 32)
__host__ __device__ __forceinline__ int window_lead(int n) {
  if (n <= SUM_WINDOW) return n;
  const int pad = SUM_WINDOW * ((n + SUM_WINDOW - 1) / SUM_WINDOW) - n;
  return SUM_WINDOW - pad / 2;
}

// windows of the first level of n terms
__host__ __device__ __forceinline__ int n_windows(int n) {
  return n <= SUM_WINDOW ? 1 : (n + SUM_WINDOW - 1) / SUM_WINDOW;
}

// first term of window w, the first window holding `lead` terms
__host__ __device__ __forceinline__ int window_start(int w, int lead) {
  return w == 0 ? 0 : lead + SUM_WINDOW * (w - 1);
}

// Rows of up to SHORT_ROW terms: one level of windows, then the window
// sums left to right.
constexpr int SHORT_ROW = SUM_WINDOW * SUM_WINDOW;

// The ordered sum of any n terms fed in order by add(): a running sum per
// level, a level's window passed up when it is full and, by total(), the
// partial ones at the end. `lead` is window_lead(n); the deeper levels'
// leads follow from their counts. Its arrays are indexed at run time, so
// they live in local memory: rows of up to SHORT_ROW terms (every paper
// shape) take the callers' scalar paths instead.
struct OrderedSum {
  float part[SUM_LEVELS + 1];
  int left[SUM_LEVELS];
  int levels;

  __device__ OrderedSum(int n, int lead) : levels(0) {
    for (int k = 0; k <= SUM_LEVELS; ++k) part[k] = 0.0f;
    while (n > SUM_WINDOW && levels < SUM_LEVELS) {
      left[levels] = levels == 0 ? lead : window_lead(n);
      n = (n + SUM_WINDOW - 1) / SUM_WINDOW;
      ++levels;
    }
  }

  __device__ void add(float x) {
    part[0] = __fadd_rn(part[0], x);
    for (int k = 0; k < levels; ++k) {
      if (--left[k] > 0) return;
      part[k + 1] = __fadd_rn(part[k + 1], part[k]);
      part[k] = 0.0f;
      left[k] = SUM_WINDOW;
    }
  }

  __device__ float total() {
    for (int k = 0; k < levels; ++k) {
      if (left[k] < SUM_WINDOW) {  // a window holding terms
        part[k + 1] = __fadd_rn(part[k + 1], part[k]);
        if (k + 1 < levels) --left[k + 1];
      }
    }
    return part[levels];
  }
};

// t[0], t[stride], ..., t[(n - 1) stride] of a row of up to SHORT_ROW
// terms in the order: window by window, each from 0, the window sums from
// 0 left to right
__device__ __forceinline__ float ordered_sum_short(const float* t, int n,
                                                   int lead, int stride) {
  float sums = 0.0f;
  for (int s = 0; s < n;) {
    const int e = min(s == 0 ? lead : s + SUM_WINDOW, n);
    float part = 0.0f;
    for (int i = s; i < e; ++i)
      part = __fadd_rn(part, t[(size_t)i * stride]);
    sums = __fadd_rn(sums, part);
    s = e;
  }
  return sums;
}

// the same sum of a row of any length
__device__ __forceinline__ float ordered_sum_strided(const float* t, int n,
                                                     int lead, int stride) {
  if (n <= SHORT_ROW) return ordered_sum_short(t, n, lead, stride);
  OrderedSum acc(n, lead);
  for (int i = 0; i < n; ++i) acc.add(t[(size_t)i * stride]);
  return acc.total();
}

}  // namespace
