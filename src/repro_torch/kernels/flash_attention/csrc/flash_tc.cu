// Causal (or full) attention with an online softmax, GQA by index: the bf16
// route, on the tensor cores.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
// ::flash_attention_kernel (the Pallas body _flash_kernel), reached through
// kernels/flash_attention/ops.py::flash_attention from every layer of
// Model.prefill(use_flash=True) (models/attention.py::attend).
// flash_3xtf32.cu is the f32 route of the same wrapper.
//
// Per query row, over the key tiles: s = (q . k) * scale, masked where kpos
// > qpos (causal) or kpos >= Sk; m_new = max(m, max s); p = exp(s - m_new);
// l = l e^{m - m_new} + sum p; acc = acc e^{m - m_new} + bf16(p) v; at the
// end o = acc / max(l, 1e-30), rounded once to bf16. Both products run on
// the bf16 tensor cores with f32 sums. p is rounded to bf16 for the second
// product, as the plain versions round the probabilities to v's dtype
// (ref.attention; the reference's ref.py and its model's _sdpa,
// repro/models/attention.py:135) and unlike the Pallas kernel, which keeps
// p in f32. l sums the unrounded p. The exps are ex2.approx on s log2(e).
//
// Bound on the H100, at the yi-9b serve shape (B 4, S 2048, H 32, Kv 4,
// hd 128, causal): the two products over the visible pairs are 4 B H hd
// S(S+1)/2 = 1.375e11 operations, 0.139 ms at the 989 TFLOP/s of the bf16
// tensor cores, against 151 MB of q, k, v and o, 0.045 ms at 3.35 TB/s:
// operations bound.
//
// Design (sm_90a). A block owns one (b, h, 128-row q tile) and walks the
// 128-key tiles from the causal frontier down to 0, so tiles above the
// diagonal are never loaded (136 of 256 tile pairs per head at S = 2048)
// and only the diagonal tile and the ragged last tile are masked. The grid
// is (H, B, q tiles) with the q tiles reversed, so the longest blocks start
// first. 384 threads in three warpgroups:
// - warpgroup 0 is the producer: setmaxnreg drops it to 40 registers and
//   one thread issues the TMA loads: q once, then k and v of each key tile
//   into a ring of 2 stages, each stage with a full and an empty mbarrier
//   for k and for v, so the next tile's k and v arrive while this tile's
//   products run;
// - warpgroups 1 and 2 are the consumers (232 registers each), 64 q rows
//   apiece: S = q k^T as 8 (hd / 16) wgmma m64n128k16 with q and k from
//   shared memory (K-major); the mask, the row max and sum in registers
//   (the accumulator's rows are spread over 4 lanes: two xor shuffles);
//   p packed to bf16 in the accumulator's own layout, which is wgmma's A
//   fragment layout, so o += p v is 8 wgmma m64n{hd}k16 with p from
//   registers and v from shared memory read MN-major. k is released as
//   soon as S is computed, v after the second product.
// The tensor maps are built on the host for each call over the model's
// (B, S, H, hd) layout through its strides (dims hd, S, H, B), so nothing
// is transposed or padded: TMA fills rows past Sq or Sk with zeros, and
// the kernel masks keys >= Sk (a zero key would score 0, not -inf) and
// stores only rows < Sq. The swizzle follows the box row: 32, 64 or 128
// bytes at hd 16, 32 or 64; hd 128 is two 64-wide boxes, each swizzled by
// 128 bytes (wgmma.cuh gives the descriptors). Shared memory at hd 128:
// q 32 KB and 2 stages of k and v, 32 KB each: 161 KB, one block per SM.
// ptxas (-Xptxas -v, printed by chip_smoke.py): 168 registers a thread at
// launch at every hd, no spills; setmaxnreg then moves the consumers to
// 232.
// What holds it back (times in PERF.md): within a warpgroup the softmax
// waits for S and the next S waits for p v, and the two warpgroups are
// left to interleave on their own. Two schedules that overlap them were
// tried on the card and were slower in this kernel, so neither is kept:
// turns on the tensor cores between the warpgroups by named barriers, and
// S of a tile issued beside p v of the previous one. 3 stages instead of
// 2 changed nothing. With one block per SM, a block's first loads and its
// stores of o are not hidden behind another block's products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kBQ = 128;            // q rows per block: 2 consumers x 64
constexpr int kBK = 128;            // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int kBox = HD < 64 ? HD : 64;   // box width, in values
  static constexpr int kBoxes = HD / kBox;         // 2 at hd 128, else 1
  static constexpr int kRow = kBox * 2;            // bytes per box row
  static constexpr uint32_t kSwz = tc::swizzle_code(kRow);
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBK * HD * 2;
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes;
  static_assert(HD % 16 == 0 && kRow % 32 == 0, "hd is 16, 32, 64 or 128");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of k16 step kk (16 values along hd) in a K-major tile of
// `rows` rows: 32 bytes along a box row, then the next box.
template <int HD>
__device__ __forceinline__ uint32_t kstep_offset(int kk, int rows) {
  using T = Tile<HD>;
  return (kk * 32) % T::kRow + (kk * 32) / T::kRow * rows * T::kRow;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                __nv_bfloat16* __restrict__ o, int H, int G, int Sq, int Sk,
                float scale_log2, int causal) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  // q_full, then k_full, v_full, k_empty and v_empty per stage
  __shared__ __align__(8) uint64_t bars[1 + 4 * kStages];
  uint8_t* q_s = smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + T::kQBytes;
  uint8_t* v_s = k_s + kStages * T::kKVBytes;
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  // keys up to the last row of the tile (causal), else all of them
  const int k_end = causal ? min(Sk, min(q0 + kBQ, Sq)) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    tc::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(k_full + s, 1);
      tc::mbar_init(v_full + s, 1);
      tc::mbar_init(k_empty + s, kConsumerWarps);
      tc::mbar_init(v_empty + s, kConsumerWarps);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer ---------------------------------------------------------
    tc::regs_dealloc<kProducerRegs>();
    if (threadIdx.x != 0) return;
    tc::tma_prefetch_map(&q_map);
    tc::tma_prefetch_map(&k_map);
    tc::tma_prefetch_map(&v_map);
    const int kvh = h / G;
    tc::mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
    for (int box = 0; box < T::kBoxes; ++box)
      tc::tma_load_4d(q_s + box * kBQ * T::kRow, &q_map, q_full,
                      box * T::kBox, q0, h, b);
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % kStages;
      const uint32_t parity = ((it / kStages) & 1) ^ 1;
      const int k0 = (n_tiles - 1 - it) * kBK;
      uint8_t* k_dst = k_s + stage * T::kKVBytes;
      uint8_t* v_dst = v_s + stage * T::kKVBytes;
      tc::mbar_wait(k_empty + stage, parity);
      tc::mbar_expect_tx(k_full + stage, T::kKVBytes);
#pragma unroll
      for (int box = 0; box < T::kBoxes; ++box)
        tc::tma_load_4d(k_dst + box * kBK * T::kRow, &k_map, k_full + stage,
                        box * T::kBox, k0, kvh, b);
      tc::mbar_wait(v_empty + stage, parity);
      tc::mbar_expect_tx(v_full + stage, T::kKVBytes);
#pragma unroll
      for (int box = 0; box < T::kBoxes; ++box)
        tc::tma_load_4d(v_dst + box * kBK * T::kRow, &v_map, v_full + stage,
                        box * T::kBox, k0, kvh, b);
    }
  } else {
    // ---- consumers --------------------------------------------------------
    tc::regs_alloc<kConsumerRegs>();
    const int wg = warp / 4 - 1;                    // 0 or 1
    const int wg_row0 = q0 + 64 * wg;               // its first q row
    const int r0 = wg_row0 + 16 * (warp % 4) + lane / 4;   // and r0 + 8
    const int c_lane = 2 * (lane % 4);
    const uint32_t q_addr = tc::smem_addr(q_s) + 64 * wg * T::kRow;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    tc::mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const int k0 = (n_tiles - 1 - it) * kBK;
      const uint32_t k_addr = tc::smem_addr(k_s + stage * T::kKVBytes);
      const uint32_t v_addr = tc::smem_addr(v_s + stage * T::kKVBytes);

      // S = q k^T (64 x 128 per warpgroup), f32
      float s[kBK / 2];
      tc::mbar_wait(k_full + stage, parity);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        tc::wgmma_ss_n128(
            s,
            tc::make_desc(q_addr + kstep_offset<HD>(kk, kBQ), 16,
                          8 * T::kRow, T::kSwz),
            tc::make_desc(k_addr + kstep_offset<HD>(kk, kBK), 16,
                          8 * T::kRow, T::kSwz),
            kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(s);
      if (lane == 0) tc::mbar_arrive(k_empty + stage);

      // scale, mask, row max. Register 4j + e holds row r0 + 8 (e / 2),
      // key k0 + 8j + c_lane + e % 2.
      const bool mask = k0 + kBK > Sk || (causal && k0 + kBK - 1 > wg_row0);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale_log2;
          if (mask) {
            const int col = k0 + 8 * j + c_lane + (e & 1);
            const int row = r0 + 8 * (e >> 1);
            if (col >= Sk || (causal && col > row)) x = -INFINITY;
          }
          s[4 * j + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row with no visible key yet keeps p = 0 and acc = 0
      const float base0 = mn0 == -INFINITY ? 0.f : mn0;
      const float base1 = mn1 == -INFINITY ? 0.f : mn1;
      const float corr0 = ex2(m0 - base0), corr1 = ex2(m1 - base1);
      m0 = mn0;
      m1 = mn1;

      // p, its row sums, and p in bf16 as the A fragments of o += p v:
      // k16 step kk takes accumulator blocks 2kk (registers 0, 1) and
      // 2kk + 1 (registers 2, 3), rows r0 and r0 + 8 alternating
      uint32_t pa[kBK / 16][4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float p0 = ex2(s[4 * j] - base0), p1 = ex2(s[4 * j + 1] - base0);
        const float p2 = ex2(s[4 * j + 2] - base1);
        const float p3 = ex2(s[4 * j + 3] - base1);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        pa[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= corr0;
        acc[4 * j + 1] *= corr0;
        acc[4 * j + 2] *= corr1;
        acc[4 * j + 3] *= corr1;
      }

      // o += p v (64 x hd per warpgroup), v MN-major
      tc::mbar_wait(v_full + stage, parity);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        tc::wgmma_rs<HD>(acc, pa[kk],
                         tc::make_desc(v_addr + kk * 16 * T::kRow,
                                       kBK * T::kRow, 8 * T::kRow, T::kSwz));
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(acc);
      if (lane == 0) tc::mbar_arrive(v_empty + stage);
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const long long row_elems = static_cast<long long>(H) * HD;
    __nv_bfloat16* o0 = o + (static_cast<long long>(b) * Sq + r0) * row_elems +
                        static_cast<long long>(h) * HD + c_lane;
    __nv_bfloat16* o1 = o0 + 8 * row_elems;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      if (r0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
  }
}

// A bf16 (B, S, heads, HD) tensor through its strides (in elements) as a
// 4-D tensor map (HD, S, heads, B), boxes of (box width, rows, 1, 1).
template <int HD>
bool make_map(hopper::EncodeTiled enc, CUtensorMap* map, const void* ptr,
              int B, int S, int heads, long long sb, long long ss, long long sh,
              int rows) {
  using T = Tile<HD>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kBox),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = T::kRow == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : T::kRow == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Kv, int Sq, int Sk, const long long* st,
                   float scale, int causal, cudaStream_t stream) {
  const hopper::EncodeTiled enc = hopper::tensor_map_encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map<HD>(enc, &q_map, q, B, Sq, H, st[0], st[1], st[2], kBQ) ||
      !make_map<HD>(enc, &k_map, k, B, Sk, Kv, st[3], st[4], st[5], kBK) ||
      !make_map<HD>(enc, &v_map, v, B, Sk, Kv, st[6], st[7], st[8], kBK))
    return cudaErrorInvalidValue;
  const int bytes = Tile<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_tc_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), H, H / Kv, Sq, Sk,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Sk, Kv, hd), bf16, through their strides
// (in elements; the last dim contiguous, the base and the other strides
// multiples of 16 bytes); o (B, Sq, H, hd) bf16 contiguous. Returns
// cudaGetLastError(), or cudaErrorSymbolNotFound / cudaErrorInvalidValue
// when the driver has no cuTensorMapEncodeTiled or refuses a tensor map.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Kv, int Sq, int Sk, int hd, int q_sb, int q_ss, int q_sh, int k_sb,
    int k_ss, int k_sh, int v_sb, int v_ss, int v_sh, float scale,
    int causal, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch<16>(q, k, v, o, B, H, Kv, Sq, Sk, st, scale, causal, s); break;
    case 32: err = launch<32>(q, k, v, o, B, H, Kv, Sq, Sk, st, scale, causal, s); break;
    case 64: err = launch<64>(q, k, v, o, B, H, Kv, Sq, Sk, st, scale, causal, s); break;
    case 128: err = launch<128>(q, k, v, o, B, H, Kv, Sq, Sk, st, scale, causal, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
