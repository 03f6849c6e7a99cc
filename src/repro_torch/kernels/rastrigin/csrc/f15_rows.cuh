// The F15 tail shared by the F15 kernel (f15.cu) and the fused F15 of the
// float generation kernel (kernels/ga/csrc/generation_float.cu): for a few
// rows staged in shared memory, rotate each group, apply the Rastrigin term
// and sum, in the f32 order of kernels/rastrigin/ref.py. Every step is a
// round-to-nearest intrinsic, so nothing contracts into an FMA, and cosf is
// the one the plain version's torch.cos runs on the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// f32(2 pi), the constant of the plain version's torch.tensor(2 * pi)
constexpr float RASTRIGIN_TWO_PI = 6.28318548202514648438f;

__device__ __forceinline__ float rastrigin_term(float r) {
  const float c = cosf(__fmul_rn(RASTRIGIN_TWO_PI, r));
  return __fadd_rn(__fsub_rn(__fmul_rn(r, r), __fmul_rn(10.0f, c)), 10.0f);
}

// Sum of n terms in groups of `group` consecutive terms: each group summed
// from 0 left to right, the group sums added to 0 left to right
// (kernels/trap/ref.py::ordered_sum).
__device__ __forceinline__ float ordered_sum(const float* t, int n,
                                             int group) {
  float total = 0.0f;
  for (int g0 = 0; g0 < n; g0 += group) {
    const int g1 = min(g0 + group, n);
    float part = 0.0f;
    for (int i = g0; i < g1; ++i) part = __fadd_rn(part, t[i]);
    total = __fadd_rn(total, part);
  }
  return total;
}

// F15 of `rows` rows of width D = G * m. zp holds the rows shifted and
// permuted (rows * D floats of shared memory); terms is rows * D floats of
// shared scratch. Row r's value times `sign` goes to out[r]. zp is
// overwritten with the group sums. Every thread of the block must call it.
__device__ void f15_rows(float* zp, float* terms, int rows, int D, int m,
                         int G, int k_group, const float* __restrict__ M,
                         float* out, float sign) {
  // one thread per (row, group, k): consecutive threads take consecutive k,
  // so their reads of M[g][j][k] coalesce and zp[j] is a broadcast
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, q = i - r * D;
    const int g = q / m, k = q - g * m;
    const float* z = zp + (size_t)r * D + (size_t)g * m;
    const float* Mg = M + (size_t)g * m * m + k;
    float acc = __fmul_rn(z[0], Mg[0]);
    for (int j = 1; j < m; ++j)
      acc = __fadd_rn(acc, __fmul_rn(z[j], Mg[(size_t)j * m]));
    terms[i] = rastrigin_term(acc);
  }
  __syncthreads();
  float* gsum = zp;
  for (int i = threadIdx.x; i < rows * G; i += blockDim.x) {
    const int r = i / G, g = i - r * G;
    gsum[i] = ordered_sum(terms + (size_t)r * D + (size_t)g * m, m, k_group);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float total = 0.0f;
    for (int g = 0; g < G; ++g) total = __fadd_rn(total, gsum[r * G + g]);
    out[r] = __fmul_rn(sign, total);
  }
}

}  // namespace
