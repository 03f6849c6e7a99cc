// The F15 tail shared by the F15 kernel (f15.cu) and the fused F15 of the
// float generation kernel (kernels/ga/csrc/generation_float.cu): for a few
// rows staged in shared memory, rotate each group, apply the Rastrigin term
// and sum, in the f32 order of kernels/rastrigin/ref.py. Every step is a
// round-to-nearest intrinsic, so nothing contracts into an FMA, and cosf is
// the one the plain version's torch.cos runs on the card.
//
// Bound on the H100: the rotation's multiply-adds, two instructions each
// (a multiply and an add rounded apart, as the plain version rounds them):
// 2 * rows * G * m * m lane instructions, 2.05e8 at 2048 rows of D 1000,
// m 50, about 7 us on 132 SMs x 128 lanes. The first body gave a
// thread one output and two loads per multiply-add, z[j] from shared
// memory and M[g][j][k] from device memory, so every row read the whole
// 200 KB rotation stack through L1/L2 (410 MB at 2048 rows): L2's rate,
// not the arithmetic's, bound it. The register-blocked body below reads M
// once per call and does ROWS * 4 multiply-adds per 4 + ROWS loads.
//
// Measured through the F15 kernel (chip_smoke.py phase 6, CUDA events, on
// an NVIDIA H100 80GB HBM3 at 700.00 W; its own launch of 4 rows per block
// unchanged, so M still crosses L2 once per 4 rows): 0.03533 ms at 2048
// rows and 0.1545 ms at 10,000 rows of D 1000, m 50, against 0.1411 and
// 0.4566 ms for the first body.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../trap/csrc/ordered_sum.cuh"

namespace {

// f32(2 pi), the constant of the plain version's torch.tensor(2 * pi)
constexpr float RASTRIGIN_TWO_PI = 6.28318548202514648438f;

__device__ __forceinline__ float rastrigin_term(float r) {
  const float c = cosf(__fmul_rn(RASTRIGIN_TWO_PI, r));
  return __fadd_rn(__fsub_rn(__fmul_rn(r, r), __fmul_rn(10.0f, c)), 10.0f);
}

// Sum of n terms in XLA's window order, lead = window_lead(n)
// (kernels/trap/ref.py::ordered_sum, kernels/trap/csrc/ordered_sum.cuh).
__device__ __forceinline__ float ordered_sum(const float* t, int n,
                                             int lead) {
  return ordered_sum_strided(t, n, lead, 1);
}

// One step j of a micro-tile's sums: acc = z[j] M[j] (FIRST) or acc +
// z[j] M[j], a multiply and an add rounded apart.
template <bool FIRST, int ROWS, int KB>
__device__ __forceinline__ void rotate_step(float (&acc)[ROWS][KB],
                                            const float* z, const int* zr,
                                            int j, const float (&mj)[KB]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float zj = z[zr[r] + j];
#pragma unroll
    for (int c = 0; c < KB; ++c) {
      const float prod = __fmul_rn(zj, mj[c]);
      acc[r][c] = FIRST ? prod : __fadd_rn(acc[r][c], prod);
    }
  }
}

// Steps j and j + 1 of a micro-tile's sums, z by 8-byte loads; M's rows j
// and j + 1 in column pairs.
template <bool FIRST, int ROWS, int KB, int P>
__device__ __forceinline__ void rotate_pair_step(float (&acc)[ROWS][KB],
                                                 const float* z,
                                                 const int* zr, int j,
                                                 const float2 (&m0)[P],
                                                 const float2 (&m1)[P]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float2 zz = *reinterpret_cast<const float2*>(z + zr[r] + j);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float p0 = __fmul_rn(zz.x, m0[q].x);
      const float p1 = __fmul_rn(zz.x, m0[q].y);
      float& a0 = acc[r][2 * q];
      float& a1 = acc[r][2 * q + 1];
      a0 = FIRST ? p0 : __fadd_rn(a0, p0);
      a1 = FIRST ? p1 : __fadd_rn(a1, p1);
      a0 = __fadd_rn(a0, __fmul_rn(zz.y, m1[q].x));
      a1 = __fadd_rn(a1, __fmul_rn(zz.y, m1[q].y));
    }
  }
}

// The rotated z of one micro-tile: acc[r][c] = sum over j of z_r[j] *
// Mg[j][k0 + c] for ROWS rows (row r at z + zr[r]) and KB columns, the
// plain version's order: acc = z0 M0, then acc + zj Mj for j = 1 .. m - 1,
// a multiply and an add rounded apart. Each step loads the rows' z[j] (a
// shared-memory broadcast) and M's row j + 1 (from device memory, one step
// ahead of its use). Columns past m repeat m - 1.
template <int ROWS, int KB>
__device__ __forceinline__ void rotate_tile(float (&acc)[ROWS][KB],
                                            const float* z, const int* zr,
                                            const float* __restrict__ Mg,
                                            int m, int k0) {
  int kc[KB];
#pragma unroll
  for (int c = 0; c < KB; ++c) kc[c] = min(k0 + c, m - 1);
  float mj[KB], next[KB];
#pragma unroll
  for (int c = 0; c < KB; ++c) mj[c] = __ldg(Mg + kc[c]);
  for (int j = 0; j < m; ++j) {
    const float* Mn = Mg + (size_t)min(j + 1, m - 1) * m;
#pragma unroll
    for (int c = 0; c < KB; ++c) next[c] = __ldg(Mn + kc[c]);
    if (j == 0)
      rotate_step<true>(acc, z, zr, 0, mj);
    else
      rotate_step<false>(acc, z, zr, j, mj);
#pragma unroll
    for (int c = 0; c < KB; ++c) mj[c] = next[c];
  }
}

// rotate_tile for even m with z and M 8-byte aligned: two steps of j at a
// time, each row's z[j], z[j + 1] and each pair of M's columns by one
// 8-byte load, M's next two rows a step ahead; the same order and
// roundings, so the same bits, with half the load instructions.
template <int ROWS, int KB>
__device__ __forceinline__ void rotate_tile_pairs(float (&acc)[ROWS][KB],
                                                  const float* z,
                                                  const int* zr,
                                                  const float* __restrict__ Mg,
                                                  int m, int k0) {
  static_assert(KB % 2 == 0, "columns go in pairs");
  constexpr int P = KB / 2;
  int kp[P];  // a pair past m repeats m - 2, m - 1
#pragma unroll
  for (int q = 0; q < P; ++q) kp[q] = min(k0 + 2 * q, m - 2);
  float2 m0[P], m1[P], n0[P], n1[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    m0[q] = __ldg(reinterpret_cast<const float2*>(Mg + kp[q]));
    m1[q] = __ldg(reinterpret_cast<const float2*>(Mg + m + kp[q]));
  }
  for (int j = 0; j < m; j += 2) {
    const float* Mn = Mg + (size_t)min(j + 2, m - 2) * m;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      n0[q] = __ldg(reinterpret_cast<const float2*>(Mn + kp[q]));
      n1[q] = __ldg(reinterpret_cast<const float2*>(Mn + m + kp[q]));
    }
    if (j == 0)
      rotate_pair_step<true>(acc, z, zr, 0, m0, m1);
    else
      rotate_pair_step<false>(acc, z, zr, j, m0, m1);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      m0[q] = n0[q];
      m1[q] = n1[q];
    }
  }
}

// F15 of `rows` rows of width D = G * m, rows <= ROWS. zp holds the rows
// shifted and permuted (rows * D floats of shared memory); terms is
// rows * D floats of shared scratch. Row r's value times `sign` goes to
// out[r]. zp is overwritten with the group sums. Every thread of the block
// must call it.
//
// The rotation is register-blocked: a thread owns a micro-tile of all ROWS
// rows x KB consecutive k of one group and keeps its ROWS * KB sums in
// registers, so each element of M is read once per call, not once per row,
// and a load serves ROWS or KB multiply-adds instead of one. Rows past
// `rows` repeat the last row; neither they nor columns past m are stored.
template <int ROWS>
__device__ void f15_rows(float* zp, float* terms, int rows, int D, int m,
                         int G, int k_lead, const float* __restrict__ M,
                         float* out, float sign) {
  constexpr int KB = 4;
  const int quads = (m + KB - 1) / KB;
  const bool pairs = m % 2 == 0 && D % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(zp) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(M) % 8 == 0;
  int zr[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) zr[r] = min(r, rows - 1) * D;
  for (int task = threadIdx.x; task < G * quads; task += blockDim.x) {
    const int g = task / quads, k0 = (task - g * quads) * KB;
    const float* z = zp + (size_t)g * m;
    const float* Mg = M + (size_t)g * m * m;
    float acc[ROWS][KB];
    if (pairs)
      rotate_tile_pairs<ROWS, KB>(acc, z, zr, Mg, m, k0);
    else
      rotate_tile<ROWS, KB>(acc, z, zr, Mg, m, k0);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rows) break;
#pragma unroll
      for (int c = 0; c < KB; ++c)
        if (k0 + c < m)
          terms[(size_t)r * D + (size_t)g * m + k0 + c] =
              rastrigin_term(acc[r][c]);
    }
  }
  __syncthreads();
  float* gsum = zp;
  for (int i = threadIdx.x; i < rows * G; i += blockDim.x) {
    const int r = i / G, g = i - r * G;
    gsum[i] = ordered_sum(terms + (size_t)r * D + (size_t)g * m, m, k_lead);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    out[r] = __fmul_rn(sign, ordered_sum(gsum + r * G, G, window_lead(G)));
  }
}

}  // namespace
