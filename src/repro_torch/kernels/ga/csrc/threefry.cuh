// The GA counter RNG on the card: 20-round Threefry-2x32 and the draws of
// repro_torch/rand.py (uniform, bernoulli, randint, normal). Every draw is a
// pure function of (k0, k1, counter, salt), the salt in the second counter
// word, so the kernels and the plain versions draw the same bits. Included
// by the generation kernels; everything here is inline device code, with
// the draw-site salts of the generation protocol.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Draw-site salts of the generation protocol (kernels/ga/common.py).
constexpr uint32_t SALT_SELECT_A = 0xA1u;
constexpr uint32_t SALT_SELECT_B = 0xB2u;
constexpr uint32_t SALT_CROSSOVER = 0xC3u;
constexpr uint32_t SALT_CROSSOVER_GATE = 0xD4u;
constexpr uint32_t SALT_MUTATE = 0xE5u;
constexpr uint32_t SALT_MUTATE_NOISE = 0xF6u;

// f32(2 pi), the constant of the plain versions' torch.tensor(2 * pi)
constexpr float BOX_MULLER_TWO_PI = 6.28318548202514648438f;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define TF_ROUND(r)      \
  x0 += x1;              \
  x1 = rotl32(x1, r) ^ x0;

// 20-round Threefry-2x32 of counter block (x0, x1); both output words.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

#undef TF_ROUND

// The first word only; the compiler drops the work of the second.
__device__ __forceinline__ uint32_t threefry_x0(uint32_t k0, uint32_t k1,
                                                uint32_t x0, uint32_t x1) {
  return threefry2x32(k0, k1, x0, x1).x;
}

__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return __fmul_rn((float)(bits >> 8), 1.0f / 16777216.0f);
}

__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            uint32_t ctr, uint32_t salt) {
  return bits_to_unit(threefry_x0(k0, k1, ctr, salt));
}

__device__ __forceinline__ bool bernoulli_at(uint32_t k0, uint32_t k1,
                                             uint32_t ctr, uint32_t salt,
                                             float p) {
  return uniform_at(k0, k1, ctr, salt) < p;
}

// bernoulli_at's test as an integer compare: u = k 2^-24 with k = bits >> 8
// exactly, so u < p iff k < ceil(p 2^24). p 2^24 is exact (a power-of-two
// scale); p <= 0 or NaN never passes, p >= 1 always does.
__device__ __forceinline__ uint32_t unit_threshold(float p) {
  const float s = __fmul_rn(p, 16777216.0f);
  if (!(s > 0.0f)) return 0u;
  if (s >= 16777216.0f) return 1u << 24;
  return (uint32_t)ceilf(s);
}

__device__ __forceinline__ bool unit_below(uint32_t bits, uint32_t threshold) {
  return (bits >> 8) < threshold;
}

__device__ __forceinline__ int randint_at(uint32_t k0, uint32_t k1,
                                          uint32_t ctr, uint32_t salt,
                                          uint32_t maxval) {
  return (int)(threefry_x0(k0, k1, ctr, salt) % maxval);
}

// Box-Muller from both words of one block, as rand.normal:
// sqrt(-2 log(1 - u1)) * cos(f32(2 pi) * u2), each step rounded alone.
__device__ __forceinline__ float normal_at(uint32_t k0, uint32_t k1,
                                           uint32_t ctr, uint32_t salt) {
  const uint2 b = threefry2x32(k0, k1, ctr, salt);
  const float u1 = bits_to_unit(b.x), u2 = bits_to_unit(b.y);
  const float r = __fsqrt_rn(__fmul_rn(-2.0f, logf(__fsub_rn(1.0f, u1))));
  return __fmul_rn(r, cosf(__fmul_rn(BOX_MULLER_TWO_PI, u2)));
}

}  // namespace
