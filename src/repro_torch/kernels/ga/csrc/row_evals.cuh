// The fused separable fitness of new rows, shared by the generation
// kernels (generation.cu, generation_float.cu, generation_tiled.cu) and,
// through binary_row_fitness_warp, the trap kernel (kernels/trap/csrc/
// trap.cu), in the f32 order of kernels/ga/common.py::fused_fitness: trap as
// kernels/trap/ref.py::ordered_sum of the block scores, onemax and
// royal_road exactly, and the rastrigin and sphere terms in ordered_sum's
// window order (kernels/trap/csrc/ordered_sum.cuh). Round-to-nearest
// intrinsics keep the compiler from contracting any step into an FMA.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../trap/csrc/ordered_sum.cuh"

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
  int kind, L, trap_l, trap_lead;  // trap_lead: window_lead(L / trap_l)
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

// Trap fitness of a row by the 32 lanes of a warp, each passing its lane
// index; every lane returns the value. Each lane scores one block, 32
// blocks a round, then every lane adds the scores alike, from shuffles, in
// ordered_sum's order: rows of up to SHORT_ROW traps in scalars (the window
// in progress, its size, the finished windows' sum), longer ones through
// OrderedSum.
template <bool LONG_ROWS>
__device__ __forceinline__ float trap_row_warp(const int8_t* row,
                                               const BinaryEval& e,
                                               int lane) {
  const unsigned all = 0xffffffffu;
  const int n_traps = e.L / e.trap_l;
  if (LONG_ROWS) {
    OrderedSum acc(n_traps, e.trap_lead);
    for (int base = 0; base < n_traps; base += 32) {
      const int t = base + lane;
      const float f = t < n_traps ? trap_score(row, t, e) : 0.0f;
      const int here = min(32, n_traps - base);
      for (int k = 0; k < here; ++k) acc.add(__shfl_sync(all, f, k));
    }
    return acc.total();
  }
  float total = 0.0f, part = 0.0f;
  int in_window = 0, window = e.trap_lead;
  for (int base = 0; base < n_traps; base += 32) {
    const int t = base + lane;
    const float f = t < n_traps ? trap_score(row, t, e) : 0.0f;
    const int here = min(32, n_traps - base);
    for (int k = 0; k < here; ++k) {
      part = __fadd_rn(part, __shfl_sync(all, f, k));
      if (++in_window == window) {
        total = __fadd_rn(total, part);
        part = 0.0f;
        in_window = 0;
        window = SUM_WINDOW;
      }
    }
  }
  return in_window ? __fadd_rn(total, part) : total;
}

// The trap, onemax or royal_road fitness of one int8 row of e.L genes, by
// the 32 lanes of a warp (trap_row_warp); onemax and royal_road count in
// integers, exactly as the f32 sums of whole numbers below 2^24 are.
__device__ float binary_row_fitness_warp(const int8_t* row,
                                         const BinaryEval& e, int lane) {
  const unsigned all = 0xffffffffu;
  if (e.kind == EVAL_TRAP)
    return e.L / e.trap_l > SHORT_ROW ? trap_row_warp<true>(row, e, lane)
                                      : trap_row_warp<false>(row, e, lane);
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
// window order of ordered_sum (lead = window_lead(L)): the first level's
// window sums in parallel into parts (rows * n_windows(L) floats), then one
// thread per row adds them in their own window order. Every thread of the
// block must call it.
__device__ void neg_grouped_row_sums(const float* terms, float* parts,
                                     int rows, int L, int lead, float* out) {
  const int n_parts = n_windows(L);
  for (int i = threadIdx.x; i < rows * n_parts; i += blockDim.x) {
    const int t = i / n_parts, g = i - t * n_parts;
    const int g0 = window_start(g, lead);
    const int g1 = min(window_start(g + 1, lead), L);
    float part = 0.0f;
    for (int j = g0; j < g1; ++j)
      part = __fadd_rn(part, terms[(size_t)t * L + j]);
    parts[i] = part;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < rows; t += blockDim.x)
    out[t] = -ordered_sum_strided(parts + t * n_parts, n_parts,
                                  window_lead(n_parts), 1);
}

}  // namespace
