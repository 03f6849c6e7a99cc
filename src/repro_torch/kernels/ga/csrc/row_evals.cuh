// The fused separable fitness of new rows, shared by the generation
// kernels (generation.cu, generation_float.cu, generation_tiled.cu), in the
// f32 order of kernels/ga/common.py::fused_fitness: trap as
// kernels/trap/ref.py::ordered_sum of the block scores, onemax and
// royal_road exactly, and the rastrigin and sphere terms in ordered_sum's
// grouped order. Round-to-nearest intrinsics keep the compiler from
// contracting any step into an FMA.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The fused eval's codes (kernels/ga/generation.py::EVAL_KINDS).
enum EvalKind {
  EVAL_NONE = 0,
  EVAL_TRAP = 1,
  EVAL_ONEMAX = 2,
  EVAL_ROYAL = 3,
  EVAL_RASTRIGIN = 4,
  EVAL_SPHERE = 5,
  EVAL_F15 = 6
};

struct BinaryEval {
  int kind, L, trap_l, trap_group;
  float a, b, z, l_minus_z;
  int royal_r;
};

__device__ float trap_row(const int8_t* row, const BinaryEval& e) {
  const int n_traps = e.L / e.trap_l;
  float total = 0.0f;
  for (int g0 = 0; g0 < n_traps; g0 += e.trap_group) {
    const int g1 = min(g0 + e.trap_group, n_traps);
    float part = 0.0f;
    for (int t = g0; t < g1; ++t) {
      int u = 0;
      for (int j = 0; j < e.trap_l; ++j) u += row[t * e.trap_l + j];
      const float uf = (float)u;
      const float f =
          uf <= e.z ? __fdiv_rn(__fmul_rn(e.a, __fsub_rn(e.z, uf)), e.z)
                    : __fdiv_rn(__fmul_rn(e.b, __fsub_rn(uf, e.z)),
                                e.l_minus_z);
      part = __fadd_rn(part, f);
    }
    total = __fadd_rn(total, part);
  }
  return total;
}

// The trap, onemax or royal_road fitness of one int8 row of e.L genes.
__device__ float binary_row_fitness(const int8_t* row, const BinaryEval& e) {
  if (e.kind == EVAL_TRAP) return trap_row(row, e);
  if (e.kind == EVAL_ONEMAX) {
    float v = 0.0f;
    for (int j = 0; j < e.L; ++j) v = __fadd_rn(v, (float)row[j]);
    return v;
  }
  int full = 0;
  for (int b0 = 0; b0 < e.L; b0 += e.royal_r) {
    int u = 0;
    for (int j = 0; j < e.royal_r; ++j) u += row[b0 + j];
    full += u >= e.royal_r;
  }
  return __fmul_rn((float)e.royal_r, (float)full);
}

// out[t] = -(the sum of terms[t * L + j] over j) for t < rows, in the
// grouped order of ordered_sum: the group partials in parallel into parts
// (rows * ceil(L / sum_group) floats), then one thread per row adds them to
// 0 in order. Every thread of the block must call it.
__device__ void neg_grouped_row_sums(const float* terms, float* parts,
                                     int rows, int L, int sum_group,
                                     float* out) {
  const int n_parts = (L + sum_group - 1) / sum_group;
  for (int i = threadIdx.x; i < rows * n_parts; i += blockDim.x) {
    const int t = i / n_parts, g = i - t * n_parts;
    const int g0 = g * sum_group, g1 = min(g0 + sum_group, L);
    float part = 0.0f;
    for (int j = g0; j < g1; ++j)
      part = __fadd_rn(part, terms[(size_t)t * L + j]);
    parts[i] = part;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    float total = 0.0f;
    for (int g = 0; g < n_parts; ++g)
      total = __fadd_rn(total, parts[t * n_parts + g]);
    out[t] = -total;
  }
}

}  // namespace
