// Causal (or full) attention with an online softmax, GQA by index: the f32
// route, on the CUDA cores. flash_tc.cu is the bf16 route of the same
// wrapper, on the tensor cores.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
// ::flash_attention_kernel (the Pallas body _flash_kernel), reached through
// kernels/flash_attention/ops.py::flash_attention from every layer of
// Model.prefill(use_flash=True) (models/attention.py::attend).
//
// Per query row, over the key tiles in order: s = (q . k) * scale, masked
// where kpos > qpos (causal) or kpos >= Sk; m_new = max(m, max s);
// p = exp(s - m_new); l = l e^{m - m_new} + sum p; acc = acc e^{m - m_new}
// + p v; at the end o = acc / max(l, 1e-30), rounded once to the output
// dtype. Everything is f32; p stays f32. expf, not __expf: the build has
// no fast math, and the parity with the plain version is at f32
// tolerances (atol 2e-5).
//
// Bound on the H100, at the yi-9b serve shape in f32 (B 4, S 2048, H 32,
// Kv 4, hd 128, causal): the two products over the causal half are 4 B H
// hd S(S+1)/2 = 1.375e11 operations, 2.05 ms at the 67 TFLOP/s of the f32
// CUDA cores, against 302 MB of q, k, v and o, 0.09 ms at 3.35 TB/s:
// operations bound.
//
// Design. The Pallas grid's sequential KV axis becomes a loop inside the
// block: a block owns one (b, h, 64-row q tile) and walks the 64-key tiles
// from 0 up to the causal frontier, so the tiles above the diagonal are
// never touched (528 of 1024 tiles run at S = 2048) and m, l and the
// accumulator stay in registers across the loop. The grid is (H, B, q
// tiles) with the q tiles reversed on the slowest axis, so the longest
// blocks start first. GQA is the index h / G into k and v: no broadcast
// copy. The kernel reads the model's (B, S, H, hd) layout through its
// strides and masks the ragged edges itself (rows >= Sq, keys >= Sk), so
// the wrapper neither transposes nor pads. 256 threads as 16 x 16: a
// thread computes a 4 x 4 tile of the scores (rows 4 ty.., keys 4 tx..)
// and the same 4 rows of the output at hd / 16 columns (tx + 16 j), so m,
// l and the rescale are per thread, the row reductions four xor shuffles.
// Shared memory: q transposed (hd x 68 floats), one buffer for k
// transposed and then v (hd x 68), p transposed (64 x 68); 87 KB at
// hd 128, two blocks per SM. The transposed tiles give conflict-free
// float4 reads in both products. A row whose tile holds no visible key
// (m still -inf) adds nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kLd = kBQ + 4;   // row stride of the transposed tiles
static_assert(kBQ == kBK, "the transposed tiles share one row stride");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int HD>
constexpr int smem_floats() {
  return 2 * HD * kLd + kBK * kLd;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int G,
             int Sq, int Sk, long long q_sb, long long q_ss, long long q_sh,
             long long k_sb, long long k_ss, long long k_sh, long long v_sb,
             long long v_ss, long long v_sh, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [HD][kLd]  q tile, transposed
  float* kv = qt + HD * kLd;     // [HD][kLd]  k tile transposed; then v
  float* pt = kv + HD * kLd;     // [kBK][kLd] p, transposed
  constexpr int kCols = HD / 16;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / G) * k_sh;
  const T* vb = v + b * v_sb + (h / G) * v_sh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qt[d * kLd + r] = q0 + r < Sq ? to_f32(qb[(q0 + r) * q_ss + d]) : 0.f;
  }

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // keys up to the last row of the tile (causal), else all of them
  const int k_end = causal ? min(Sk, min(q0 + kBQ, Sq)) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();               // the last tile's v and p are read
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      kv[d * kLd + c] = k0 + c < Sk ? to_f32(kb[(k0 + c) * k_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + 4 * ty);
      const float4 bk = *reinterpret_cast<const float4*>(kv + d * kLd + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * tx + j;
        const bool visible = kj < Sk && (!causal || kj <= qi);
        s[i][j] = visible ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float corr = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {     // else no visible key yet: p = 0
        corr = expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          sum += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * kLd + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();               // p written, k read

    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      kv[c * HD + d] = k0 + c < Sk ? to_f32(vb[(k0 + c) * v_ss + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(pt + c * kLd + 4 * ty);
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float vv = kv[c * HD + tx + 16 * jj];
        acc[0][jj] = fmaf(p.x, vv, acc[0][jj]);
        acc[1][jj] = fmaf(p.y, vv, acc[1][jj]);
        acc[2][jj] = fmaf(p.z, vv, acc[2][jj]);
        acc[3][jj] = fmaf(p.w, vv, acc[3][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = o + ((static_cast<long long>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj)
      store(row + tx + 16 * jj, acc[i][jj] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Kv, int Sq, int Sk, const long long* st,
                   float scale, int causal, cudaStream_t stream) {
  const int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / Kv, Sq, Sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Sk, Kv, hd), f32, through their strides (in
// elements; the last dim contiguous); o (B, Sq, H, hd) f32 contiguous.
// Returns cudaGetLastError().
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Kv, int Sq, int Sk, int hd, int q_sb, int q_ss, int q_sh, int k_sb,
    int k_ss, int k_sh, int v_sb, int v_ss, int v_sh, float scale,
    int causal, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch<float, 16>(q, k, v, o, B, H, Kv, Sq, Sk, st, scale, causal, s); break;
    case 32: err = launch<float, 32>(q, k, v, o, B, H, Kv, Sq, Sk, st, scale, causal, s); break;
    case 64: err = launch<float, 64>(q, k, v, o, B, H, Kv, Sq, Sk, st, scale, causal, s); break;
    case 128: err = launch<float, 128>(q, k, v, o, B, H, Kv, Sq, Sk, st, scale, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
