// 3xTF32 products on the tensor cores (mma.sync m16n8k8), shared by the
// kernels that run f32-grade products there: the WKV6 kernel
// (kernels/rwkv6/csrc/wkv.cuh) and the f32 flash-attention kernel
// (kernels/flash_attention/csrc/flash_3xtf32.cu).
//
// Each f32 operand is split into a tf32 hi part and a lo part, and a
// product is hi hi + hi lo + lo hi with f32 sums: f32 grade, never plain
// TF32 (lo lo, about 2^-22 of the product, is left out).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

struct Split4 {
  uint32_t hi[4], lo[4];
};
struct Split2 {
  uint32_t hi[2], lo[2];
};

// hi: x rounded to tf32, half an ulp added and the low 13 bits cleared
// (cvt.rna.tf32.f32 compiles to four instructions with an infinity test,
// and the values here are finite); lo: the exact rest x - hi, which the
// tensor core reads truncated to tf32, at most 2^-21 of x off. The split
// of CUTLASS's fast 3xTF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ Split4 split4(float a0, float a1, float a2,
                                         float a3) {
  Split4 s;
  split(a0, s.hi[0], s.lo[0]);
  split(a1, s.hi[1], s.lo[1]);
  split(a2, s.hi[2], s.lo[2]);
  split(a3, s.hi[3], s.lo[3]);
  return s;
}

__device__ __forceinline__ Split2 split2(float b0, float b1) {
  Split2 s;
  split(b0, s.hi[0], s.lo[0]);
  split(b1, s.hi[1], s.lo[1]);
  return s;
}

// d += a b, one m16n8k8 tf32 product with f32 sums. Fragments (g = lane / 4,
// t = lane % 4): a = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the
// 16 x 8 A; b = (t, g), (t + 4, g) of the 8 x 8 B; d = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1) of the 16 x 8 D.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b (m16 x k8 times k8 x n8) in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const Split4& a,
                                     const Split2& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// d += a b where b is exact in tf32 (a bf16 value widened): b's lo part is
// zero, so the product is a's hi and lo parts against it
__device__ __forceinline__ void mma3_exact_b(float (&d)[4], const Split4& a,
                                             const uint32_t* b) {
  mma_tf32(d, a.lo, b);
  mma_tf32(d, a.hi, b);
}

// d += a b where a is exact in tf32
__device__ __forceinline__ void mma3_exact_a(float (&d)[4], const uint32_t* a,
                                             const Split2& b) {
  mma_tf32(d, a, b.lo);
  mma_tf32(d, a, b.hi);
}

}  // namespace tf32x3
