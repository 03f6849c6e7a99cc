// The fused separable fitness of new rows, shared by the generation
// kernels (generation.cu, generation_float.cu, generation_tiled.cu) and,
// through binary_row_fitness_warp, the trap kernel (kernels/trap/csrc/
// trap.cu), in the f32 order of kernels/ga/common.py::fused_fitness: trap as
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

// The score of trap block t of a row: its u ones give a(z - u)/z when
// u <= z, else b(u - z)/(l - z).
__device__ __forceinline__ float trap_score(const int8_t* row, int t,
                                            const BinaryEval& e) {
  int u = 0;
  for (int j = 0; j < e.trap_l; ++j) u += row[t * e.trap_l + j];
  const float uf = (float)u;
  return uf <= e.z ? __fdiv_rn(__fmul_rn(e.a, __fsub_rn(e.z, uf)), e.z)
                   : __fdiv_rn(__fmul_rn(e.b, __fsub_rn(uf, e.z)),
                               e.l_minus_z);
}

__device__ float trap_row(const int8_t* row, const BinaryEval& e) {
  const int n_traps = e.L / e.trap_l;
  float total = 0.0f;
  for (int g0 = 0; g0 < n_traps; g0 += e.trap_group) {
    const int g1 = min(g0 + e.trap_group, n_traps);
    float part = 0.0f;
    for (int t = g0; t < g1; ++t) part = __fadd_rn(part, trap_score(row, t, e));
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

// binary_row_fitness by the 32 lanes of a warp, each passing its lane
// index; every lane returns the value. Trap scores one block per lane, then
// every lane adds them alike, in trap_row's grouped order, from shuffles;
// onemax and royal_road count in integers, exactly as the f32 sums of
// whole numbers below 2^24 are.
__device__ float binary_row_fitness_warp(const int8_t* row,
                                         const BinaryEval& e, int lane) {
  const unsigned all = 0xffffffffu;
  if (e.kind == EVAL_TRAP) {
    const int n_traps = e.L / e.trap_l;
    float total = 0.0f, part = 0.0f;
    int in_group = 0;
    for (int base = 0; base < n_traps; base += 32) {
      const int t = base + lane;
      const float f = t < n_traps ? trap_score(row, t, e) : 0.0f;
      const int here = min(32, n_traps - base);
      for (int k = 0; k < here; ++k) {
        part = __fadd_rn(part, __shfl_sync(all, f, k));
        if (++in_group == e.trap_group) {
          total = __fadd_rn(total, part);
          part = 0.0f;
          in_group = 0;
        }
      }
    }
    return in_group ? __fadd_rn(total, part) : total;
  }
  int count = 0;
  if (e.kind == EVAL_ONEMAX) {
    for (int j = lane; j < e.L; j += 32) count += row[j];
  } else {
    for (int b0 = lane * e.royal_r; b0 < e.L; b0 += 32 * e.royal_r) {
      int u = 0;
      for (int j = 0; j < e.royal_r; ++j) u += row[b0 + j];
      count += u >= e.royal_r;
    }
  }
  count = __reduce_add_sync(all, count);
  return e.kind == EVAL_ONEMAX ? (float)count
                               : __fmul_rn((float)e.royal_r, (float)count);
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
