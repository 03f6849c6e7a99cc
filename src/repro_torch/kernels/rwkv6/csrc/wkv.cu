// Chunked WKV6 recurrence (RWKV6 time mix), f32 throughout.
//
// Replaces: src/repro/kernels/rwkv6/rwkv6.py::wkv_kernel (the Pallas body
// _wkv_kernel), reached through kernels/rwkv6/ops.py::wkv from every layer
// of Model.prefill(use_rwkv_kernel=True).
//
// Per (batch x head) and chunk of T tokens, with L the inclusive cumsum of
// log w over the chunk and L_prev = L - log w:
//   y_t  = (r e^{L_prev})_t S                                 [inter]
//        + sum_{i<t} (sum_k r_tk k_ik e^{L_prev,tk - L_ik}) v_i [intra]
//        + (sum_k r_tk u_k k_tk) v_t                          [bonus]
//   S   <- e^{L_T} S + (k e^{L_T - L})^T v
// Every exponent of the pairwise intra term is <= 0, so decays of any
// strength cannot overflow; log w is taken of max(w, 1e-38), as the
// reference does.
//
// Bound on the H100: memory. At the serve shape (BH 160, S 1024, D 64)
// the kernel must read r, k, v, w (4 x 41.9 MB), u and s0, and write y
// (41.9 MB) and the final state: about 215 MB, 0.064 ms at 3.35 TB/s.
// The arithmetic, counted once per head (chip_smoke.py's wkv_work), is
// about 4.0 G f32 operations, 0.060 ms at 67 TFLOP/s.
//
// Design. The TPU walks the chunks as a sequential grid axis with the
// state in VMEM. Here one block owns one (batch x head) and VB columns of
// the state and loops over the chunks itself, the (D x VB) state slice in
// shared memory throughout. Columns of S are independent (y[:, j] needs
// only S[:, j] and v[:, j]), so a (BH, D / VB) grid gives D / VB blocks
// per head: at the serve shape 320 blocks with VB = 32 (a compile-time
// constant, min(32, D)), where one block per head would give 160, less
// than two waves' worth on 132 SMs. Of 16, 32 and 64 columns, 32 was the
// fastest at the serve shape on the H100 (PERF.md). The price is that
// each of a head's D / VB blocks recomputes the chunk's cumsum, r~, k^
// and the pairwise scores (T(T-1)/2 pairs of K exps) for itself. That recomputation and the shared-memory reads of
// the three f32 products, not the bytes, are what this simple kernel
// spends its time on. Only the strictly lower pairs are computed. Lanes
// walk the K axis from staggered starts, so the pairwise loop reads
// shared memory without bank conflicts. No tensor cores and no TF32: the
// products are f32 loops (a later step is mma.sync or wgmma for them,
// register tiles, and TMA for the chunk loads).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColumns = 32;
constexpr float kWFloor = 1e-38f;

// Shared memory, in floats, for T = chunk, K = D and VB columns:
//   sr, sk   [T*K]   r and k of the chunk
//   sa       [T*K]   log w, then L_prev, then r~ = r e^{L_prev}
//   sb       [T*K]   L, then k^ = k e^{L_T - L}
//   sv       [T*VB]  v of the block's columns
//   sc       [T*T]   pairwise scores (rows t, columns i < t)
//   sd       [T]     bonus diagonal r.u.k
//   slt, su  [K]     L_T and u
//   ss       [K*VB]  the block's columns of the state
inline int smem_floats(int t, int k, int vb) {
  return 4 * t * k + t * vb + t * t + t + 2 * k + k * vb;
}

template <int VB>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ y, float* __restrict__ s_out, int seq, int D,
           int T) {
  extern __shared__ float smem[];
  const int K = D;
  float* sr = smem;
  float* sk = sr + T * K;
  float* sa = sk + T * K;
  float* sb = sa + T * K;
  float* sv = sb + T * K;
  float* sc = sv + T * VB;
  float* sd = sc + T * T;
  float* slt = sd + T;
  float* su = slt + K;
  float* ss = su + K;

  const int bh = blockIdx.x;
  const int col0 = blockIdx.y * VB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t head = (size_t)bh * seq * D;
  const size_t state = (size_t)bh * D * D;

  for (int i = tid; i < K; i += kThreads) su[i] = u[(size_t)bh * D + i];
  for (int i = tid; i < K * VB; i += kThreads)
    ss[i] = s0[state + (size_t)(i / VB) * D + col0 + i % VB];

  const int n_pairs = T * (T - 1) / 2;
  for (int c0 = 0; c0 < seq; c0 += T) {
    // the chunk's r, k, log w (T*K contiguous floats) and v's columns
    const size_t off = head + (size_t)c0 * D;
    for (int i = tid; i < T * K; i += kThreads) {
      sr[i] = r[off + i];
      sk[i] = k[off + i];
      sa[i] = logf(fmaxf(w[off + i], kWFloor));
    }
    for (int i = tid; i < T * VB; i += kThreads)
      sv[i] = v[off + (size_t)(i / VB) * D + col0 + i % VB];
    __syncthreads();

    // inclusive cumsum of log w down the chunk, one thread per channel
    for (int kk = tid; kk < K; kk += kThreads) {
      float acc = 0.0f;
      for (int t = 0; t < T; ++t) {
        const float lw = sa[t * K + kk];
        acc += lw;
        sb[t * K + kk] = acc;
        sa[t * K + kk] = acc - lw;
      }
      slt[kk] = acc;
    }
    __syncthreads();

    // pairwise scores for i < t; pair p lies in row t where
    // t(t-1)/2 <= p < t(t+1)/2
    for (int p = tid; p < n_pairs; p += kThreads) {
      int t = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)p)) * 0.5f);
      while (t * (t - 1) / 2 > p) --t;
      while (t * (t + 1) / 2 <= p) ++t;
      const int i = p - t * (t - 1) / 2;
      const float* rt = sr + t * K;
      const float* lp = sa + t * K;
      const float* ki = sk + i * K;
      const float* li = sb + i * K;
      float acc = 0.0f;
      for (int q = 0; q < K; ++q) {
        const int kk = (q + lane) & (K - 1);
        acc += rt[kk] * ki[kk] * expf(lp[kk] - li[kk]);
      }
      sc[t * T + i] = acc;
    }
    for (int t = tid; t < T; t += kThreads) {
      float acc = 0.0f;
      for (int kk = 0; kk < K; ++kk)
        acc += sr[t * K + kk] * su[kk] * sk[t * K + kk];
      sd[t] = acc;
    }
    __syncthreads();

    // r~ = r e^{L_prev} over L_prev, k^ = k e^{L_T - L} over L
    for (int i = tid; i < T * K; i += kThreads) {
      sa[i] = sr[i] * expf(sa[i]);
      sb[i] = sk[i] * expf(slt[i & (K - 1)] - sb[i]);
    }
    __syncthreads();

    // y = r~ S + scores v + diag v, for the block's columns
    for (int o = tid; o < T * VB; o += kThreads) {
      const int t = o / VB, j = o % VB;
      float inter = 0.0f;
      for (int kk = 0; kk < K; ++kk) inter += sa[t * K + kk] * ss[kk * VB + j];
      float intra = 0.0f;
      for (int i = 0; i < t; ++i) intra += sc[t * T + i] * sv[i * VB + j];
      y[off + (size_t)t * D + col0 + j] = inter + intra + sd[t] * sv[o];
    }
    __syncthreads();

    // S <- e^{L_T} S + k^T v
    for (int o = tid; o < K * VB; o += kThreads) {
      const int kk = o / VB, j = o % VB;
      float acc = 0.0f;
      for (int t = 0; t < T; ++t) acc += sb[t * K + kk] * sv[t * VB + j];
      ss[o] = expf(slt[kk]) * ss[o] + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < K * VB; i += kThreads)
    s_out[state + (size_t)(i / VB) * D + col0 + i % VB] = ss[i];
}

template <int VB>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int bh,
           int seq, int d, int chunk, cudaStream_t stream) {
  const int smem = smem_floats(chunk, d, VB) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel<VB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(bh, d / VB);
  wkv_kernel<VB><<<grid, kThreads, smem, stream>>>(r, k, v, w, u, s0, y,
                                                   s_out, seq, d, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, y: (bh, seq, d) f32; u: (bh, d); s0, s_out: (bh, d, d).
// seq % chunk == 0, d one of 8, 16, 32, 64; each block owns min(32, d)
// columns of the state. Launches on `stream` without synchronising;
// returns cudaGetLastError(), or cudaErrorInvalidValue for another d.
extern "C" int wkv_launch(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, int bh, int seq, int d,
                          int chunk, void* stream) {
  const auto* fr = (const float*)r;
  const auto* fk = (const float*)k;
  const auto* fv = (const float*)v;
  const auto* fw = (const float*)w;
  const auto* fu = (const float*)u;
  const auto* fs = (const float*)s0;
  auto* fy = (float*)y;
  auto* fo = (float*)s_out;
  const auto st = (cudaStream_t)stream;
  switch (d) {
    case 8:
      return launch<8>(fr, fk, fv, fw, fu, fs, fy, fo, bh, seq, d, chunk, st);
    case 16:
      return launch<16>(fr, fk, fv, fw, fu, fs, fy, fo, bh, seq, d, chunk,
                        st);
    case 32:
    case 64:
      return launch<kColumns>(fr, fk, fv, fw, fu, fs, fy, fo, bh, seq, d,
                              chunk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
