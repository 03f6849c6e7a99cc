// Chunked WKV6 recurrence (RWKV6 time mix) for Hopper, f32 arithmetic.
//
// Replaces: src/repro/kernels/rwkv6/rwkv6.py::wkv_kernel (the Pallas body
// _wkv_kernel), reached through kernels/rwkv6/ops.py::wkv from every layer
// of Model.prefill(use_rwkv_kernel=True). wkv.cu instantiates it for bf16
// r, k and v (the served model), wkv_f32.cu for f32 (its f32 twin).
//
// Per (batch, head) and chunk of T tokens, with L the inclusive cumsum of
// log w over the chunk (w floored at 1e-38, as the reference) and L_prev =
// L - log w:
//   y   = (r e^{L_prev}) S + a v
//   S  <- e^{L_T} S + (k e^{L_T - L})^T v
// where a (T x T) holds the intra-chunk scores below its diagonal and the
// bonus r.u.k on it. Inside each sub-chunk of 8 tokens a pair (t, i < t)
// is the exact pairwise sum_k r_tk k_ik e^{L_prev,tk - L_ik}. A pair that
// straddles the end e = 8q + 7 of i's sub-chunk q factors there:
// e^{L_prev,t - L_i} = e^{L_prev,t - L_e} e^{L_e - L_i}, both exponents <= 0
// at any decay, so the block (t >= 8(q + 1), i in q) of a is a product of
// r scaled to e and k scaled from e. ref.py::wkv_subchunked is this form
// in plain PyTorch; ref.py::wkv_chunked the reference's all-pairwise one.
//
// Bound on the H100 at the serve shape (B 4, S 1024, H 40, hd 64, bf16 r,
// k, v): about 152 MB of r, k, v, w, y and states, 0.045 ms at 3.35 TB/s,
// against this form's work (chip_smoke.py's wkv_work): 0.39 G f32
// operations on the CUDA cores and 8.2 G TF32 tensor-core operations for
// the 3xTF32 products, 0.022 ms at 67 and 495 TFLOP/s: bytes bound. What
// holds the kernel above it is the chain of chunks each CTA walks: per
// chunk 3 barrier-separated phases whose instructions one SM must issue
// (the split of the 3xTF32 operands was the largest cost it shed), and at
// 160 heads on 132 SMs, 28 SMs run two heads at once (PERF.md has the
// readings).
//
// Design. What held the first port back, and what each part does:
// - Layout copies around the kernel: r, k, v, w are read where the model
//   leaves them, (B, S, H, hd) through their strides, by TMA tensor maps
//   built per call (hopper/csrc/tma.cuh), r, k, v in bf16 or f32 and
//   widened on load; u is read per head as (H, hd), y written as (B, S, H,
//   hd) f32. ops.wkv launches nothing else for a model's inputs.
// - Exposed loads: a ring of 2 stages, filled by TMA and waited on through
//   mbarriers (a copy not landed in 2 s traps); chunk c + 2 is requested
//   as soon as chunk c is out of its stage.
// - Work repeated per head: one CTA per head does the chunk's
//   state-independent work once. (A cluster of 2 CTAs per head, splitting
//   the key channels and summing their partial y through distributed
//   shared memory, was timed against it and was slower: PERF.md.)
// - Scalar loops: the three products (r~ S, a v, k^T v) and a's
//   off-diagonal blocks run on the tensor cores as mma.sync m16n8k8 in
//   3xTF32 (each f32 operand split into tf32 hi + lo, the product hi hi +
//   hi lo + lo hi with f32 sums: f32 grade, never plain TF32; a bf16 v is
//   exact in tf32, so its products skip its lo part). The state S^T lives
//   in registers across chunks, as the products' accumulators; within a
//   k8 step the contraction index is permuted (slot c <-> 2c, c + 4 <->
//   2c + 1) so that fragments load as float2 and the accumulator of S^T is
//   directly the B operand of r~ S.
// - Exponentials: 112 + 72 per channel and chunk at T = 32 instead of 496.
// Per chunk, 256 threads: (1) all of them: log w, the cumsum (a serial
// segment per thread, then the segments' prefix), r~, k^T and v^T into
// shared memory; (2) warps 0-3, one 16-column band of S each: r~ S and the
// state update, while warps 4-7 build a, warp 4 + p sub-chunk p's share
// (an off-diagonal tile, the bonus, the 28 pairs), so each scheduler holds
// one warp of each and the tensor cores overlap a's loads and
// exponentials; (3) warps 0-3: y += a v, stored from the accumulators.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../hopper/csrc/tf32x3.cuh"
#include "../../hopper/csrc/tma.cuh"

namespace wkv {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kSub = 8;                 // tokens per sub-chunk
constexpr float kWFloor = 1e-38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint64_t kTmaTimeoutNs = 2000000000ull;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// e^x by ex2.approx (relative error about 2^-22 over the range that matters)
__device__ __forceinline__ float ex(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---- 3xTF32 products (hopper/csrc/tf32x3.cuh) -----------------------------
using tf32x3::mma3;
using tf32x3::mma3_exact_a;
using tf32x3::mma3_exact_b;
using tf32x3::Split2;
using tf32x3::split2;
using tf32x3::Split4;
using tf32x3::split4;

// N consecutive floats of a row of a transposed buffer (k^T, v^T), in as
// few vector stores as their alignment allows: one lane per row, so the
// rows' pitch puts 8 (float) or 2 (float4) lanes on one bank
template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4)
      *reinterpret_cast<float4*>(dst + j) =
          float4{x[j], x[j + 1], x[j + 2], x[j + 3]};
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 2)
      *reinterpret_cast<float2*>(dst + j) = make_float2(x[j], x[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = x[j];
  }
}

// ---- shapes and shared memory ----------------------------------------------
// HD head size, T chunk, In the type of r, k and v.
template <int HD, int T_, typename In>
struct Shape {
  static constexpr int T = T_;
  static constexpr int VP = cmax(HD, 16);         // S columns, an m16 band
  static constexpr int R16 = round_up(T, 16);     // rows of an m16 tile
  static constexpr int MT = R16 / 16;
  static constexpr int NSC = T / kSub;
  static constexpr int PW = HD + 4;   // pitch of r, k, L_prev, L
  static constexpr int PR = HD + 8;   // of r~
  static constexpr int PT = T + 8;    // of k^T, v^T and a (t along a row)
  static constexpr int BANDS = VP / 16;   // state warps: one 16-column band
  static constexpr int SEGS = cmin(kThreads / HD, T);      // cumsum segments
  static constexpr int SL = T / SEGS;
  // the ring: per stage r, k, v (T x HD) in In, w (T x HD) f32
  static constexpr int kIn = round_up(T * HD * (int)sizeof(In), 128);
  static constexpr int kStage = 3 * kIn + round_up(T * HD * 4, 128);
  static constexpr uint32_t kTx = 3 * T * HD * sizeof(In) + T * HD * 4;
  // r, k, L_prev, L in phases 1-2
  static constexpr int kWork = kStages * kStage;
  static constexpr int kRt = kWork + round_up(4 * T * PW * 4, 128);
  static constexpr int kKt = kRt + round_up(R16 * PR * 4, 128);
  static constexpr int kVt = kKt + round_up(HD * PT * 4, 128);
  static constexpr int kA = kVt + round_up(VP * PT * 4, 128);
  static constexpr int kTot = kA + round_up(R16 * PT * 4, 128);
  static constexpr int kElt = kTot + round_up(SEGS * HD * 4, 128);
  static constexpr int kU = kElt + round_up(HD * 4, 128);
  static constexpr int kBar = kU + round_up(HD * 4, 128);
  static constexpr int kSmem = kBar + kStages * 8 + 128;  // + base alignment
  static_assert(HD % 8 == 0 && T % kSub == 0, "shape");
  static_assert(HD * SEGS <= kThreads && T % SEGS == 0, "cumsum segments");
  static_assert(BANDS <= 4 && NSC <= 4, "warps 0-3 hold S, 4-7 build a");
};

// Request chunk `chunk` of head (b, h) into ring stage `stage`: r, k, v
// and w, completing on the stage's mbarrier.
template <typename Sh>
__device__ __forceinline__ void issue(uint8_t* base, uint64_t* bar,
                                      const CUtensorMap* r_map,
                                      const CUtensorMap* k_map,
                                      const CUtensorMap* v_map,
                                      const CUtensorMap* w_map, int chunk,
                                      int stage, int h, int b) {
  uint8_t* dst = base + stage * Sh::kStage;
  const int t0 = chunk * Sh::T;
  hopper::mbar_expect_tx(bar + stage, Sh::kTx);
  hopper::tma_load_4d(dst, r_map, bar + stage, 0, t0, h, b);
  hopper::tma_load_4d(dst + Sh::kIn, k_map, bar + stage, 0, t0, h, b);
  hopper::tma_load_4d(dst + 2 * Sh::kIn, v_map, bar + stage, 0, t0, h, b);
  hopper::tma_load_4d(dst + 3 * Sh::kIn, w_map, bar + stage, 0, t0, h, b);
}

// ---- the kernel ------------------------------------------------------------
// Grid (H, B): one CTA per head. Maps: boxes of (HD, T) over (hd, S, H, B).
template <int HD, int T, typename In>
__global__ void __launch_bounds__(kThreads, 2)
wkv_kernel(const __grid_constant__ CUtensorMap r_map,
           const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map,
           const __grid_constant__ CUtensorMap w_map,
           const void* __restrict__ u, int u_bf16,
           const float* __restrict__ s0, float* __restrict__ y,
           float* __restrict__ s_out, int H, int S) {
  using Sh = Shape<HD, T, In>;
  constexpr int VP = Sh::VP, R16 = Sh::R16, MT = Sh::MT, NSC = Sh::NSC;
  constexpr int PW = Sh::PW, PR = Sh::PR, PT = Sh::PT, BANDS = Sh::BANDS;
  constexpr int SEGS = Sh::SEGS, SL = Sh::SL;
  // bf16 v widened is exact in tf32: its products need no lo part
  constexpr bool kVExact = sizeof(In) == 2;

  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((128 - (hopper::smem_addr(smem_raw) & 127)) & 127);
  float* rbuf = reinterpret_cast<float*>(base + Sh::kWork);
  float* kbuf = rbuf + T * PW;
  float* lp = kbuf + T * PW;
  float* lc = lp + T * PW;
  float* rt = reinterpret_cast<float*>(base + Sh::kRt);
  float* kt = reinterpret_cast<float*>(base + Sh::kKt);
  float* vt = reinterpret_cast<float*>(base + Sh::kVt);
  float* am = reinterpret_cast<float*>(base + Sh::kA);
  float* tot = reinterpret_cast<float*>(base + Sh::kTot);
  float* elt = reinterpret_cast<float*>(base + Sh::kElt);
  float* ub = reinterpret_cast<float*>(base + Sh::kU);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + Sh::kBar);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_chunks = S / T;

  // padding that is never written: a's upper triangle and rows >= T, r~'s
  // rows >= T, v^T's rows >= HD
  for (int i = tid; i < R16 * PT; i += kThreads) am[i] = 0.0f;
  for (int i = tid; i < R16 * PR; i += kThreads) rt[i] = 0.0f;
  for (int i = tid; i < VP * PT; i += kThreads) vt[i] = 0.0f;
  for (int i = tid; i < HD; i += kThreads) {
    const size_t at = static_cast<size_t>(h) * HD + i;
    ub[i] = u_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(u)[at])
                   : static_cast<const float*>(u)[at];
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(bar + s, 1);
    hopper::mbar_fence_init();
    hopper::tma_prefetch_map(&r_map);
    hopper::tma_prefetch_map(&k_map);
    hopper::tma_prefetch_map(&v_map);
    hopper::tma_prefetch_map(&w_map);
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages && s < n_chunks; ++s)
      issue<Sh>(base, bar, &r_map, &k_map, &v_map, &w_map, s, s, h, b);

  // Warps 0..BANDS-1 hold S^T[band rows][key channels] as m16n8
  // accumulator fragments: st[n] = (v = vb + g, key 8n + 2c), (v, +1),
  // (v + 8, ..), (v + 8, +1). Warp 4 + p builds sub-chunk p's share of a.
  const bool state_warp = warp < BANDS;
  const int vb = 16 * warp;
  const size_t state = (static_cast<size_t>(b) * H + h) * HD * HD;
  float st[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int v = vb + g + (e >> 1) * 8;
      const int kk = 8 * n + 2 * c + (e & 1);
      st[n][e] = state_warp && v < HD ? s0[state + kk * HD + v] : 0.0f;
    }
  // warp 4 + p's jobs in every chunk: the p-th off-diagonal tile (q, mt),
  // the bonus rows and the pairs of sub-chunk p, the pair (tl, il) a lane
  const int p = warp - 4;
  int od_q = -1, od_mt = 0;
  for (int qq = 0, tile = 0; qq + 1 < NSC; ++qq)
    for (int m = (kSub * (qq + 1)) / 16; m < MT; ++m, ++tile)
      if (tile == p) od_q = qq, od_mt = m;
  int tl = 1, il = lane;
  while (il >= tl) il -= tl++;

  const int ck = tid % HD, seg = tid / HD;   // phase 1: channel, segment
  const bool scans = tid < HD * SEGS;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int stage = ci % kStages;
    hopper::mbar_wait_or_trap(bar + stage, (ci / kStages) & 1,
                              kTmaTimeoutNs);
    const uint8_t* ring = base + stage * Sh::kStage;
    const In* r_in = reinterpret_cast<const In*>(ring);
    const In* k_in = reinterpret_cast<const In*>(ring + Sh::kIn);
    const In* v_in = reinterpret_cast<const In*>(ring + 2 * Sh::kIn);
    const float* w_in =
        reinterpret_cast<const float*>(ring + 3 * Sh::kIn);

    // ---- 1: log w and its cumsum, r~, k^ -----------------------------------
    float lw[SL], ac[SL];
    if (scans) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < SL; ++j) {
        lw[j] = logf(fmaxf(w_in[(seg * SL + j) * HD + ck], kWFloor));
        acc += lw[j];
        ac[j] = acc;
      }
      tot[seg * HD + ck] = acc;
    }
    __syncthreads();
    if (scans) {
      float pre = 0.0f, lt = 0.0f;
      for (int s = 0; s < SEGS; ++s) {
        if (s == seg) pre = lt;
        lt += tot[s * HD + ck];
      }
      if (seg == 0) elt[ck] = ex(lt);
      float kh[SL];
#pragma unroll
      for (int j = 0; j < SL; ++j) {
        const int t = seg * SL + j;
        const float big_l = pre + ac[j], l_prev = big_l - lw[j];
        const float rf = widen(r_in[t * HD + ck]);
        const float kf = widen(k_in[t * HD + ck]);
        rbuf[t * PW + ck] = rf;
        kbuf[t * PW + ck] = kf;
        lp[t * PW + ck] = l_prev;
        lc[t * PW + ck] = big_l;
        rt[t * PR + ck] = rf * ex(l_prev);
        kh[j] = kf * ex(lt - big_l);
      }
      store_row<SL>(kt + ck * PT + seg * SL, kh);
    }
    // v^T: a thread takes 4 consecutive t of one column
    for (int i = tid; i < HD * (T / 4); i += kThreads) {
      const int vv = i % HD, t4 = (i / HD) * 4;
      const float vq[4] = {widen(v_in[t4 * HD + vv]),
                           widen(v_in[(t4 + 1) * HD + vv]),
                           widen(v_in[(t4 + 2) * HD + vv]),
                           widen(v_in[(t4 + 3) * HD + vv])};
      store_row<4>(vt + vv * PT + t4, vq);
    }
    __syncthreads();
    // the stage is read: request chunk ci + kStages into it
    if (tid == 0 && ci + kStages < n_chunks)
      issue<Sh>(base, bar, &r_map, &k_map, &v_map, &w_map, ci + kStages,
                stage, h, b);

    // ---- 2 and 3a: a on warps 4-7; on warps 0-3 the products that do not
    // need it. Each scheduler holds one warp of each, so a's loads and
    // exponentials overlap the tensor cores.
    float yacc[MT][2][4];
    if (state_warp) {
      // r~ S into yacc
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) yacc[mt][nn][e] = 0.0f;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        // S as the B operand, per n8 of v
        const Split2 sb0 = split2(st[n][0], st[n][1]);
        const Split2 sb1 = split2(st[n][2], st[n][3]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* row = rt + (16 * mt + g) * PR + 8 * n + 2 * c;
          const float2 x0 = *reinterpret_cast<const float2*>(row);
          const float2 x1 = *reinterpret_cast<const float2*>(row + 8 * PR);
          const Split4 fa = split4(x0.x, x1.x, x0.y, x1.y);
          mma3(yacc[mt][0], fa, sb0);
          mma3(yacc[mt][1], fa, sb1);
        }
      }
      // S^T <- e^{L_T} S^T + v^T k^
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const float e0 = elt[8 * n + 2 * c], e1 = elt[8 * n + 2 * c + 1];
        st[n][0] *= e0;
        st[n][1] *= e1;
        st[n][2] *= e0;
        st[n][3] *= e1;
      }
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
        const int tc = 8 * j + 2 * c;
        const float* col = vt + (vb + g) * PT + tc;
        const float2 x0 = *reinterpret_cast<const float2*>(col);
        const float2 x1 = *reinterpret_cast<const float2*>(col + 8 * PT);
        const Split4 fa = split4(x0.x, x1.x, x0.y, x1.y);
        const uint32_t va[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x),
                                __float_as_uint(x0.y), __float_as_uint(x1.y)};
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const float2 kk =
              *reinterpret_cast<const float2*>(kt + (8 * n + g) * PT + tc);
          if constexpr (kVExact)
            mma3_exact_a(st[n], va, split2(kk.x, kk.y));
          else
            mma3(st[n], fa, split2(kk.x, kk.y));
        }
      }
    } else if (p >= 0 && p < NSC) {
      // a's off-diagonal tile (q, mt): rows t >= 8(q + 1) of m16 tile mt
      // against the 8 columns of sub-chunk q
      if (od_q >= 0) {
        const int q = od_q, e = kSub * q + kSub - 1, lim = kSub * (q + 1);
        const int t0 = 16 * od_mt + g, t1 = t0 + 8, i = kSub * q + g;
        float acc[2][4] = {};   // even and odd k8 steps: two chains
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const int k0 = 8 * n + c, k1 = k0 + 4;
          const float le0 = lc[e * PW + k0], le1 = lc[e * PW + k1];
          // t0 (or t1) is below lim in every lane or in none
          auto scaled_r = [&](int t, int kk, float le) {
            if (t < lim) return 0.0f;
            return rbuf[t * PW + kk] * ex(lp[t * PW + kk] - le);
          };
          const Split4 fa =
              split4(scaled_r(t0, k0, le0), scaled_r(t1, k0, le0),
                     scaled_r(t0, k1, le1), scaled_r(t1, k1, le1));
          const Split2 fb =
              split2(kbuf[i * PW + k0] * ex(le0 - lc[i * PW + k0]),
                     kbuf[i * PW + k1] * ex(le1 - lc[i * PW + k1]));
          mma3(acc[n & 1], fa, fb);
        }
        const int col = kSub * q + 2 * c;
        if (t0 >= lim)
          *reinterpret_cast<float2*>(am + t0 * PT + col) = make_float2(
              acc[0][0] + acc[1][0], acc[0][1] + acc[1][1]);
        if (t1 >= lim)
          *reinterpret_cast<float2*>(am + t1 * PT + col) = make_float2(
              acc[0][2] + acc[1][2], acc[0][3] + acc[1][3]);
      }
      // the bonus r.u.k on the diagonal of rows 8p..8p+7, 4 lanes a row
      {
        const int t = kSub * p + g;
        float acc = 0.0f;
        for (int j = c; j < HD; j += 4)
          acc += rbuf[t * PW + j] * ub[j] * kbuf[t * PW + j];
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (c == 0) am[t * PT + t] = acc;
      }
      // the pairs inside sub-chunk p, one pair a lane
      if (lane < kSub * (kSub - 1) / 2) {
        const int t = kSub * p + tl, i = kSub * p + il;
        float4 acc = {0.0f, 0.0f, 0.0f, 0.0f};   // four independent sums
#pragma unroll 4
        for (int kk = 0; kk < HD; kk += 4) {
          auto at = [&](const float* buf, int row) {
            return *reinterpret_cast<const float4*>(buf + row * PW + kk);
          };
          const float4 rr = at(rbuf, t), kq = at(kbuf, i);
          const float4 lt = at(lp, t), li = at(lc, i);
          acc.x += rr.x * kq.x * ex(lt.x - li.x);
          acc.y += rr.y * kq.y * ex(lt.y - li.y);
          acc.z += rr.z * kq.z * ex(lt.z - li.z);
          acc.w += rr.w * kq.w * ex(lt.w - li.w);
        }
        am[t * PT + i] = (acc.x + acc.y) + (acc.z + acc.w);
      }
    }
    __syncthreads();

    // ---- 3b: y += a v, then y out ------------------------------------------
    const size_t row0 =
        static_cast<size_t>(b) * S + static_cast<size_t>(ci) * T;
    auto y_at = [&](int t, int v) {
      return y + ((row0 + t) * H + h) * HD + v;
    };
    if (state_warp) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // the k8 steps of t' <= the tile's last row
#pragma unroll
        for (int j = 0; j < T / 8 && j <= 2 * mt + 1; ++j) {
          const int tc = 8 * j + 2 * c;
          const float* row = am + (16 * mt + g) * PT + tc;
          const float2 x0 = *reinterpret_cast<const float2*>(row);
          const float2 x1 = *reinterpret_cast<const float2*>(row + 8 * PT);
          const Split4 fa = split4(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            const float2 vv = *reinterpret_cast<const float2*>(
                vt + (vb + 8 * nn + g) * PT + tc);
            if constexpr (kVExact) {
              const uint32_t bv[2] = {__float_as_uint(vv.x),
                                      __float_as_uint(vv.y)};
              mma3_exact_b(yacc[mt][nn], fa, bv);
            } else {
              mma3(yacc[mt][nn], fa, split2(vv.x, vv.y));
            }
          }
        }
      }
      // rows t < T, columns v < HD (HD 8 pads the band to 16), straight to
      // y: 8 rows of 32 bytes a store
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = 16 * mt + g + 8 * half, col = vb + 8 * nn + 2 * c;
            const float2 val = make_float2(yacc[mt][nn][2 * half],
                                           yacc[mt][nn][2 * half + 1]);
            if (t >= T || col >= HD) continue;
            *reinterpret_cast<float2*>(y_at(t, col)) = val;
          }
    }
  }

  if (state_warp)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = vb + g + (e >> 1) * 8;
        const int kk = 8 * n + 2 * c + (e & 1);
        if (v < HD) s_out[state + kk * HD + v] = st[n][e];
      }
}

// ---- host ------------------------------------------------------------------
template <typename In>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(In) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// A (B, S, H, hd) tensor of `elem`-byte values through its strides (in
// elements: batch, sequence, head; hd contiguous) as a 4-D map (hd, S, H,
// B) with boxes of (hd, rows, 1, 1), unswizzled.
inline bool make_map(hopper::EncodeTiled enc, CUtensorMap* map,
                     const void* ptr, CUtensorMapDataType type, int elem,
                     int B, int S, int H, int hd, const int* st, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[1]) * elem,
                                 static_cast<cuuint64_t>(st[2]) * elem,
                                 static_cast<cuuint64_t>(st[0]) * elem};
  const cuuint32_t boxes[4] = {static_cast<cuuint32_t>(hd),
                               static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, type, 4, const_cast<void*>(ptr), dims, strides, boxes, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *r, *k, *v, *w, *u, *s0;
  void *y, *s_out;
  int B, S, H, hd, chunk, u_bf16;
  const int* st;   // the strides of r, k, v and w: (batch, seq, head) each
  cudaStream_t stream;
};

template <int HD, int T, typename In>
cudaError_t launch(const Args& a) {
  using Sh = Shape<HD, T, In>;
  const hopper::EncodeTiled enc = hopper::tensor_map_encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  constexpr CUtensorMapDataType type = tma_type<In>();
  constexpr int elem = sizeof(In);
  CUtensorMap r_map, k_map, v_map, w_map;
  if (!make_map(enc, &r_map, a.r, type, elem, a.B, a.S, a.H, HD, a.st, T) ||
      !make_map(enc, &k_map, a.k, type, elem, a.B, a.S, a.H, HD, a.st + 3,
                T) ||
      !make_map(enc, &v_map, a.v, type, elem, a.B, a.S, a.H, HD, a.st + 6,
                T) ||
      !make_map(enc, &w_map, a.w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.B,
                a.S, a.H, HD, a.st + 9, T))
    return cudaErrorInvalidValue;
  auto kernel = wkv_kernel<HD, T, In>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.H, a.B), kThreads, Sh::kSmem, a.stream>>>(
      r_map, k_map, v_map, w_map, a.u, a.u_bf16,
      static_cast<const float*>(a.s0), static_cast<float*>(a.y),
      static_cast<float*>(a.s_out), a.H, a.S);
  return cudaGetLastError();
}

template <int HD, typename In>
cudaError_t launch_t(const Args& a) {
  switch (a.chunk) {
    case 8: return launch<HD, 8, In>(a);
    case 16: return launch<HD, 16, In>(a);
    case 32: return launch<HD, 32, In>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename In>
int dispatch(const Args& a) {
  cudaError_t err;
  switch (a.hd) {
    case 8: err = launch_t<8, In>(a); break;
    case 16: err = launch_t<16, In>(a); break;
    case 32: err = launch_t<32, In>(a); break;
    case 64: err = launch_t<64, In>(a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace wkv

// The C entry points (wkv.cu: bf16 r, k, v; wkv_f32.cu: f32). r, k, v, w
// (B, S, H, hd) through their strides in elements (st: batch, seq, head of
// r, then k, v, w; hd contiguous; base and strides multiples of 16 bytes),
// w f32; u (H, hd) contiguous, bf16 when u_bf16 else f32; s0, s_out (B, H,
// hd, hd) f32 and y (B, S, H, hd) f32, contiguous. S % chunk == 0; hd one
// of 8, 16, 32, 64; chunk one of 8, 16, 32.
// Launches on `stream` without synchronising; returns cudaGetLastError(),
// cudaErrorInvalidValue for another shape or a refused tensor map, or
// cudaErrorSymbolNotFound where the driver has no cuTensorMapEncodeTiled.
#define WKV_ENTRY(NAME, IN)                                                   \
  extern "C" int NAME(const void* r, const void* k, const void* v,            \
                      const void* w, const void* u, const void* s0, void* y,  \
                      void* s_out, int B, int S, int H, int hd, int chunk,    \
                      int u_bf16, const int* st, void* stream) {              \
    const wkv::Args a{r, k, v, w, u, s0, y, s_out, B, S, H, hd, chunk,        \
                      u_bf16, st, static_cast<cudaStream_t>(stream)};         \
    return wkv::dispatch<IN>(a);                                              \
  }
