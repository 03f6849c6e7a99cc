// Causal (or full) attention with an online softmax, GQA by index: the f32
// route, both products on the tensor cores in 3xTF32. flash_tc.cu is the
// bf16 route of the same wrapper.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
// ::flash_attention_kernel (the Pallas body _flash_kernel), reached through
// kernels/flash_attention/ops.py::flash_attention from every layer of
// Model.prefill(use_flash=True) (models/attention.py::attend) of a model in
// f32 (every reduced() configuration, the f32 twin of chip_smoke.py 8b).
//
// Per query row, over the key tiles in order: s = (q . k) * scale, masked
// where kpos > qpos (causal) or kpos >= Sk; m_new = max(m, max s);
// p = exp(s - m_new); l = l e^{m - m_new} + sum p; acc = acc e^{m - m_new}
// + p v; at the end o = acc / max(l, 1e-30). m, l and p are f32; the exps
// are ex2.approx on s scale log2(e). A row with no visible key adds
// nothing.
//
// Bound on the H100, at the yi-9b serve shape in f32 (B 4, S 2048, H 32,
// Kv 4, hd 128, causal): the two products over the visible pairs are
// 4 B H hd S(S+1)/2 = 1.375e11 operations. In 3xTF32 each is three TF32
// products: 4.1e11 operations, 0.833 ms at the 495 TFLOP/s of the TF32
// tensor cores (the same work on the f32 CUDA cores: 2.05 ms at 67
// TFLOP/s), against 302 MB of q, k, v and o, 0.09 ms at 3.35 TB/s:
// operations bound.
//
// Design. A block of 8 warps owns one (b, h, 128-row q tile), 16 rows a
// warp, and walks the 32-key tiles from 0 up to the causal frontier; the
// grid is (H, B, q tiles) with the q tiles reversed, so the longest blocks
// start first. GQA is the index h / G into k and v. The model's (B, S, H,
// hd) layout is read through its strides (16-byte loads where a view's base
// and strides allow, 4-byte ones otherwise), so nothing is transposed or
// padded; rows >= Sq and keys >= Sk are zero-filled and masked here.
// - The products are mma.sync m16n8k8 in 3xTF32 (hopper/csrc/tf32x3.cuh,
//   shared with the WKV kernel): hi lo, lo hi, then hi hi, f32 sums.
// - The split is done once per operand, not per product: q once per block,
//   each k and v tile once as it is stored into shared memory, into hi and
//   lo tiles that every warp reads; p once per 8-key step in registers.
// - Layouts. Within each k8 step the contraction index is permuted (slot t
//   <-> 2t, t + 4 <-> 2t + 1; the product sums the same terms). So q's and
//   k's fragments load as float2 from [row][d] tiles of pitch hd + 8
//   (conflict-free), and the accumulator of S, which holds keys 2t and 2t + 1
//   of each 8-key tile, is directly the A fragment of p v; v's fragment
//   (keys 2t and 2t + 1, column g) loads from a [key][d] tile of pitch hd + 4
//   (conflict-free).
// - Loads overlap the math: the next tile's k and v are loaded into
//   registers before this tile's products and split into shared memory after
//   them (one tile of hi and lo each: 203 KB at hd 128, one block of 8 warps
//   per SM; 107 KB at hd 64, two).
// - A warp skips the key tiles wholly above its rows' diagonal.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../hopper/csrc/tf32x3.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // q rows per block, 16 per warp
constexpr int kBK = 32;            // keys per tile
constexpr int kNT = kBK / 8;       // 8-key tiles of S
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tiles {
  static constexpr int PQ = HD + 8;   // pitch of q and k (float2 fragments)
  static constexpr int PV = HD + 4;   // pitch of v (two keys 2t, 2t + 1)
  static constexpr int Q = kBQ * PQ;  // floats of q's hi (and of its lo)
  static constexpr int K = kBK * PQ;
  static constexpr int V = kBK * PV;
  static constexpr int kBytes = 4 * (2 * Q + 2 * K + 2 * V);
  static constexpr int F4 = kBK * HD / 4;   // float4 of a k or v tile
  static constexpr int PER = (F4 + kThreads - 1) / kThreads;
  static constexpr int kMinBlocks = HD > 64 ? 1 : 2;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// four floats of a row: one 16-byte load where the view allows it
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

// x split into hi and lo at dst_hi / dst_lo (16-byte aligned)
__device__ __forceinline__ void store_split(float* dst_hi, float* dst_lo,
                                            float4 x) {
  uint4 hi, lo;
  tf32x3::split(x.x, hi.x, lo.x);
  tf32x3::split(x.y, hi.y, lo.y);
  tf32x3::split(x.z, hi.z, lo.z);
  tf32x3::split(x.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(dst_hi) = hi;
  *reinterpret_cast<uint4*>(dst_lo) = lo;
}

// this thread's share of the k (or v) tile at key k0: float4 i of the tile
// is key i / (HD / 4), columns 4 (i % (HD / 4)) ..; keys >= Sk read as 0
template <int HD>
__device__ __forceinline__ void load_tile(float4 (&r)[Tiles<HD>::PER],
                                          const float* base, long long ss,
                                          int k0, int Sk, bool vec) {
  using T = Tiles<HD>;
#pragma unroll
  for (int i = 0; i < T::PER; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int key = idx / (HD / 4), d = idx % (HD / 4) * 4;
    r[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (idx < T::F4 && k0 + key < Sk)
      r[i] = load4(base + (k0 + key) * ss + d, vec);
  }
}

template <int HD, int PITCH>
__device__ __forceinline__ void store_tile(float* hi, float* lo,
                                           const float4 (&r)[Tiles<HD>::PER]) {
  using T = Tiles<HD>;
#pragma unroll
  for (int i = 0; i < T::PER; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int key = idx / (HD / 4), d = idx % (HD / 4) * 4;
    if (idx < T::F4) store_split(hi + key * PITCH + d, lo + key * PITCH + d,
                                 r[i]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, Tiles<HD>::kMinBlocks)
flash_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int H, int G, int Sq, int Sk, long long q_sb,
                    long long q_ss, long long q_sh, long long k_sb,
                    long long k_ss, long long k_sh, long long v_sb,
                    long long v_ss, long long v_sh, float scale_log2,
                    int causal, int q_vec, int k_vec, int v_vec) {
  using T = Tiles<HD>;
  extern __shared__ __align__(16) float smem[];
  float* q_hi = smem;
  float* q_lo = q_hi + T::Q;
  float* k_hi = q_lo + T::Q;
  float* k_lo = k_hi + T::K;
  float* v_hi = k_lo + T::K;
  float* v_lo = v_hi + T::V;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + (h / G) * k_sh;
  const float* vb = v + b * v_sb + (h / G) * v_sh;

  // q, split once; rows >= Sq are zeros
  for (int idx = tid; idx < kBQ * HD / 4; idx += kThreads) {
    const int r = idx / (HD / 4), d = idx % (HD / 4) * 4;
    const float4 x = q0 + r < Sq ? load4(qb + (q0 + r) * q_ss + d, q_vec)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    store_split(q_hi + r * T::PQ + d, q_lo + r * T::PQ + d, x);
  }

  // keys up to the last row of the tile (causal), else all of them
  const int k_end = causal ? min(Sk, min(q0 + kBQ, Sq)) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  float4 kr[T::PER], vr[T::PER];
  load_tile<HD>(kr, kb, k_ss, 0, Sk, k_vec);
  load_tile<HD>(vr, vb, v_ss, 0, Sk, v_vec);
  store_tile<HD, T::PQ>(k_hi, k_lo, kr);
  store_tile<HD, T::PV>(v_hi, v_lo, vr);
  __syncthreads();

  // this lane's rows: g and g + 8 of the warp's 16
  const int r0 = warp * 16;
  const int qa = q0 + r0 + g, qb8 = qa + 8;
  const int warp_last = min(q0 + r0 + 15, Sq - 1);
  float acc[HD / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    if (kt + 1 < n_tiles) {
      load_tile<HD>(kr, kb, k_ss, k0 + kBK, Sk, k_vec);
      load_tile<HD>(vr, vb, v_ss, k0 + kBK, Sk, v_vec);
    }
    // warps whose rows all lie past Sq or above this tile skip it
    if (q0 + r0 < Sq && (!causal || k0 <= warp_last)) {
      // S = q k^T: 16 rows x 32 keys, hd / 8 steps of k8
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
      for (int ks = 0; ks < HD / 8; ++ks) {
        const int d = ks * 8 + 2 * t;
        const uint2 h0 = *reinterpret_cast<const uint2*>(
            q_hi + (r0 + g) * T::PQ + d);
        const uint2 h1 = *reinterpret_cast<const uint2*>(
            q_hi + (r0 + g + 8) * T::PQ + d);
        const uint2 l0 = *reinterpret_cast<const uint2*>(
            q_lo + (r0 + g) * T::PQ + d);
        const uint2 l1 = *reinterpret_cast<const uint2*>(
            q_lo + (r0 + g + 8) * T::PQ + d);
        const uint32_t ahi[4] = {h0.x, h1.x, h0.y, h1.y};
        const uint32_t alo[4] = {l0.x, l1.x, l0.y, l1.y};
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const uint2 bh = *reinterpret_cast<const uint2*>(
              k_hi + (8 * j + g) * T::PQ + d);
          const uint2 bl = *reinterpret_cast<const uint2*>(
              k_lo + (8 * j + g) * T::PQ + d);
          const uint32_t bhi[2] = {bh.x, bh.y}, blo[2] = {bl.x, bl.y};
          tf32x3::mma_tf32(s[j], alo, bhi);
          tf32x3::mma_tf32(s[j], ahi, blo);
          tf32x3::mma_tf32(s[j], ahi, bhi);
        }
      }

      // the online softmax; s[j] holds (row g: keys 2t, 2t + 1; row g + 8:
      // the same keys) of 8-key tile j, in log2 units after the scale
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? qa : qb8;
          const bool visible = key < Sk && (!causal || key <= row);
          s[j][e] = visible ? s[j][e] * scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float base[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // no visible key yet: p = 0 and nothing is rescaled (acc, l are 0)
        base[r] = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = ex2(m[r] - base[r]);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = ex2(s[j][e] - base[e >> 1]);
          l[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      // acc += p v: k8 step j is S's 8-key tile j, whose accumulator is the
      // A fragment (rows g, g + 8 at slots t, t + 4 = keys 2t, 2t + 1)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const tf32x3::Split4 pa =
            tf32x3::split4(s[j][0], s[j][2], s[j][1], s[j][3]);
        const float* vh = v_hi + (8 * j + 2 * t) * T::PV + g;
        const float* vl = v_lo + (8 * j + 2 * t) * T::PV + g;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const uint32_t bhi[2] = {__float_as_uint(vh[8 * n]),
                                   __float_as_uint(vh[T::PV + 8 * n])};
          const uint32_t blo[2] = {__float_as_uint(vl[8 * n]),
                                   __float_as_uint(vl[T::PV + 8 * n])};
          tf32x3::mma_tf32(acc[n], pa.lo, bhi);
          tf32x3::mma_tf32(acc[n], pa.hi, blo);
          tf32x3::mma_tf32(acc[n], pa.hi, bhi);
        }
      }
    }
    if (kt + 1 < n_tiles) {
      __syncthreads();   // every warp is done with this tile
      store_tile<HD, T::PQ>(k_hi, k_lo, kr);
      store_tile<HD, T::PV>(v_hi, v_lo, vr);
      __syncthreads();
    }
  }

  // l over the quad of lanes that share a row, then o = acc / max(l, 1e-30)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
  float* row_a = o + ((static_cast<long long>(b) * Sq + qa) * H + h) * HD;
  float* row_b = o + ((static_cast<long long>(b) * Sq + qb8) * H + h) * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (qa < Sq)
      *reinterpret_cast<float2*>(row_a + 8 * n + 2 * t) =
          make_float2(acc[n][0] / den0, acc[n][1] / den0);
    if (qb8 < Sq)
      *reinterpret_cast<float2*>(row_b + 8 * n + 2 * t) =
          make_float2(acc[n][2] / den1, acc[n][3] / den1);
  }
}

bool aligned16(const void* p, const long long* st) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] % 4) return false;
  return true;
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int H, int Kv, int Sq, int Sk, const long long* st,
                   float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = Tiles<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_3xtf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_3xtf32_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, H, H / Kv, Sq, Sk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale * kLog2e, causal,
      aligned16(q, st), aligned16(k, st + 3), aligned16(v, st + 6));
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Sk, Kv, hd), f32, through their strides (in
// elements; the last dim contiguous); o (B, Sq, H, hd) f32 contiguous.
// Returns cudaGetLastError().
extern "C" int flash_attention_f32_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Kv, int Sq, int Sk, int hd, int q_sb, int q_ss, int q_sh, int k_sb,
    int k_ss, int k_sh, int v_sb, int v_ss, int v_sh, float scale,
    int causal, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch<16>(qf, kf, vf, of, B, H, Kv, Sq, Sk, st, scale, causal, s); break;
    case 32: err = launch<32>(qf, kf, vf, of, B, H, Kv, Sq, Sk, st, scale, causal, s); break;
    case 64: err = launch<64>(qf, kf, vf, of, B, H, Kv, Sq, Sk, st, scale, causal, s); break;
    case 128: err = launch<128>(qf, kf, vf, of, B, H, Kv, Sq, Sk, st, scale, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
