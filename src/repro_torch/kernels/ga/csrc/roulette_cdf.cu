// The roulette CDF of one GA generation, every island in one launch.
//
// Replaces: the CDF step of the selection_plan that src/repro/kernels/ga/
// tiling.py::generation_tiled computes in XLA before its pallas_call
// (tiling.py:168; its _roulette's prefix sum), for the tiled generation
// kernel (generation_tiled.cu), which reads it under roulette selection and
// draws everything else of the plan itself. No paper configuration uses
// roulette, so the island paths and Fig. 4's row never launch it.
//
// What it computes (kernels/ga/common.py::roulette_cdf): per island, the
// weight (v - lo) + 1e-6 of each finite lane of the masked fitness (lo its
// smallest finite value; padded lanes and -inf weigh 0), summed in f32 in
// common.py::prefix_sum's segmented order into an (I, n) vector: lanes
// fall into segments of SCAN_SEGMENT = 64 from lane 0, local[j] is the
// left-to-right sum from j's segment's first lane, cum[j] = carry_s +
// local[j], carry_0 = 0 and carry_{s+1} = cum[64 s + 63]. The reference
// sums blocks of 4096 lanes by tril @ w and adds a carry the same way.
//
// Bound on the H100: bytes, and far below a launch: the fitness in and the
// CDF out, 80 KB at Fig. 4's 10,000 lanes, 0.02 us at 3.35 TB/s. What a
// serial scan took was its chain of n dependent adds (the first design: one
// thread over shared memory, 62 us at 10,000 lanes); the segmented order's
// chain is 64 adds per segment plus one per segment for the carries.
//
// Design: one block of 1024 threads per island, the island in chunks of 256
// segments (16,384 lanes), so Fig. 4's 10,000 lanes are one chunk. The
// block sits on one SM: a launch, one round of load latency, that SM's
// path to L2 for the 80 KB and the two chains set its time. Two variants
// were slower: the stores overlapped with the carry chain (whose shared
// loads then queue behind the stores), and a cluster of CTAs per island
// (its three cluster barriers cost more than splitting the bytes saves).
// - Loads: each thread's quads of the chunk (at most 4) by 16-byte loads
//   (4-byte ones where the island is not on 16 bytes, and on the quad that
//   crosses its end; -inf from the island's size on), all issued before
//   any is used and before the size arrives. The block takes the island's
//   smallest finite value (fminf is exact in any order; lanes past chunk 0
//   are read for it alone), then each thread writes its quads' weights
//   into shared memory in rows of SEG_PITCH = 68 floats, one row a segment:
//   the rows stay on 16 bytes and a quarter-warp's 16-byte accesses, to
//   eight rows or to 32 lanes of one, fall on distinct banks.
// - Segment sums: thread t sums row t left to right, 64 dependent adds, 16
//   lanes at a time with the next 16 loaded meanwhile (1024 threads leave
//   64 registers a thread), writing the sums back and its total beside them.
// - Carries: thread 0 runs the chain over the totals (157 dependent adds at
//   10,000 lanes), 16 at a time, the next 16 loaded while these are added;
//   its last sum carries into the next chunk.
// - Finish: the block adds each lane's carry and stores the chunk, 16 bytes
//   a thread, consecutive threads on consecutive lanes.
// Fitness is read with the island's size applied, so n has no limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plan_rows.cuh"

namespace {

constexpr int CDF_THREADS = 1024;
constexpr int CDF_WARPS = CDF_THREADS / 32;
constexpr int CHUNK_SEGS = 256;              // segments staged at a time
constexpr int SEG_PITCH = SCAN_SEGMENT + 4;  // floats per segment row
constexpr int SEG_QUADS = SCAN_SEGMENT / 4;
constexpr int STAGE_QUADS = CHUNK_SEGS * SEG_QUADS / CDF_THREADS;
constexpr int CHAIN_PAD = 16;  // totals the chain reads past the last one

// Shared memory of a block whose chunks hold `segs` segments: the rows,
// the segments' totals and carries, and the minimum's scratch.
inline size_t cdf_smem_bytes(int segs) {
  return ((size_t)segs * SEG_PITCH + 2 * (CHUNK_SEGS + CHAIN_PAD) +
          CDF_WARPS) * sizeof(float);
}

// Lanes r .. r + 3 of the island's masked fitness: its value below `lim`
// (the island's size, at most n), -inf from there on. The loads wait for
// nothing but n, so they fly beside the size's own load.
__device__ __forceinline__ float4 masked_quad(const float* fit, int n,
                                              int lim, int r, bool vec) {
  float4 q;
  if (vec && r + 3 < n) {
    q = __ldg(reinterpret_cast<const float4*>(fit + r));
  } else {
    q.x = r < n ? fit[r] : 0.0f;
    q.y = r + 1 < n ? fit[r + 1] : 0.0f;
    q.z = r + 2 < n ? fit[r + 2] : 0.0f;
    q.w = r + 3 < n ? fit[r + 3] : 0.0f;
  }
  q.x = r < lim ? q.x : neg_inf();
  q.y = r + 1 < lim ? q.y : neg_inf();
  q.z = r + 2 < lim ? q.z : neg_inf();
  q.w = r + 3 < lim ? q.w : neg_inf();
  return q;
}

__device__ __forceinline__ float finite_or_inf(float v) {
  return isfinite(v) ? v : pos_inf();
}

// This thread's quads of the chunk at `base` (quad u = t + k CDF_THREADS),
// every load issued before any is used.
__device__ __forceinline__ void load_chunk(const float* fit, int n, int lim,
                                           int base, int quads, bool vec,
                                           float4 (&q)[STAGE_QUADS]) {
#pragma unroll
  for (int k = 0; k < STAGE_QUADS; ++k) {
    const int u = threadIdx.x + k * CDF_THREADS;
    if (u < quads) q[k] = masked_quad(fit, n, lim, base + 4 * u, vec);
  }
}

// Writes the weights of this thread's quads into the segment rows, quad u
// of the chunk at row u / 16, column 4 (u % 16).
__device__ __forceinline__ void store_weights(const float4 (&q)[STAGE_QUADS],
                                              int quads, float lo,
                                              float* rows) {
#pragma unroll
  for (int k = 0; k < STAGE_QUADS; ++k) {
    const int u = threadIdx.x + k * CDF_THREADS;
    if (u < quads) {
      float4 w;
      w.x = roulette_weight(q[k].x, lo);
      w.y = roulette_weight(q[k].y, lo);
      w.z = roulette_weight(q[k].z, lo);
      w.w = roulette_weight(q[k].w, lo);
      *reinterpret_cast<float4*>(rows + (u / SEG_QUADS) * SEG_PITCH +
                                 4 * (u % SEG_QUADS)) = w;
    }
  }
}

// The block's smallest value of v.
__device__ float block_min(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[lane];
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Four lanes' running sums from acc into out; returns the last.
__device__ __forceinline__ float scan4(float acc, float4 w, float4* out) {
  acc = __fadd_rn(acc, w.x);
  w.x = acc;
  acc = __fadd_rn(acc, w.y);
  w.y = acc;
  acc = __fadd_rn(acc, w.z);
  w.z = acc;
  acc = __fadd_rn(acc, w.w);
  w.w = acc;
  *out = w;
  return acc;
}

// carry_s for four segments from `run`, the carry into the first, into
// out; returns the carry past the fourth.
__device__ __forceinline__ float chain4(float run, float4 total,
                                        float4* out) {
  float4 c;
  c.x = run;
  run = __fadd_rn(run, total.x);
  c.y = run;
  run = __fadd_rn(run, total.y);
  c.z = run;
  run = __fadd_rn(run, total.z);
  c.w = run;
  run = __fadd_rn(run, total.w);
  *out = c;
  return run;
}

// One thread's carry chain over the chunk's segs totals, carry_{s+1} =
// carry_s + total_s from `run`: 16 totals a step, the next 16 loaded while
// these are added, so only the adds wait on each other. Reads up to 16
// totals past the last 32-segment step (zeros or unused).
__device__ float carry_chain(const float* tot, float* carry, int segs,
                             float run) {
  const float4* tq = reinterpret_cast<const float4*>(tot);
  float4* cq = reinterpret_cast<float4*>(carry);
  float4 a0 = tq[0], a1 = tq[1], a2 = tq[2], a3 = tq[3];
  for (int s = 0; s < segs; s += 32) {
    const int q = s / 4;
    const float4 b0 = tq[q + 4], b1 = tq[q + 5], b2 = tq[q + 6],
                 b3 = tq[q + 7];
    run = chain4(run, a0, cq + q);
    run = chain4(run, a1, cq + q + 1);
    run = chain4(run, a2, cq + q + 2);
    run = chain4(run, a3, cq + q + 3);
    if (s + 16 >= segs) break;
    a0 = tq[q + 8];
    a1 = tq[q + 9];
    a2 = tq[q + 10];
    a3 = tq[q + 11];
    run = chain4(run, b0, cq + q + 4);
    run = chain4(run, b1, cq + q + 5);
    run = chain4(run, b2, cq + q + 6);
    run = chain4(run, b3, cq + q + 7);
  }
  return run;
}

__global__ void __launch_bounds__(CDF_THREADS)
roulette_cdf_kernel(const float* __restrict__ fitness,
                    const int* __restrict__ pop_size,
                    float* __restrict__ cum_buf, int n, int chunk_segs) {
  extern __shared__ __align__(16) float smem[];
  float* rows = smem;                            // chunk_segs x SEG_PITCH
  float* tot = rows + chunk_segs * SEG_PITCH;    // segment totals
  float* carry = tot + CHUNK_SEGS + CHAIN_PAD;   // segment carries
  float* red = carry + CHUNK_SEGS + CHAIN_PAD;   // CDF_WARPS
  const int isl = blockIdx.x, t = threadIdx.x;
  const float* fit = fitness + (size_t)isl * n;
  float* cum = cum_buf + (size_t)isl * n;
  const int lim = min(pop_size[isl], n);
  const bool vec = ((reinterpret_cast<uintptr_t>(fit) |
                     reinterpret_cast<uintptr_t>(cum)) & 15) == 0;
  const int chunk = chunk_segs * SCAN_SEGMENT, quads = chunk / 4;

  // chunk 0 into registers beside the island's smallest finite value
  float4 q[STAGE_QUADS];
  load_chunk(fit, n, lim, 0, quads, vec, q);
  float lo = pos_inf();
#pragma unroll
  for (int k = 0; k < STAGE_QUADS; ++k) {
    if (t + k * CDF_THREADS < quads) {
      lo = fminf(fminf(lo, finite_or_inf(q[k].x)), finite_or_inf(q[k].y));
      lo = fminf(fminf(lo, finite_or_inf(q[k].z)), finite_or_inf(q[k].w));
    }
  }
  for (int r = chunk + t; r < lim; r += CDF_THREADS)
    lo = fminf(lo, finite_or_inf(fit[r]));
  lo = block_min(lo, red);

  float run = 0.0f;  // thread 0: the carry into the chunk's first segment
  for (int base = 0; base < n; base += chunk) {
    const int segs = min(chunk_segs, (n - base + SCAN_SEGMENT - 1) /
                                         SCAN_SEGMENT);
    if (base > 0) load_chunk(fit, n, lim, base, quads, vec, q);
    store_weights(q, quads, lo, rows);
    if (t >= segs && t < CHUNK_SEGS + CHAIN_PAD) tot[t] = 0.0f;
    __syncthreads();
    // thread t sums segment t left to right, 16 lanes at a time, the next
    // 16 loaded while these are added (1024 threads leave 64 registers)
    if (t < segs) {
      float4* row = reinterpret_cast<float4*>(rows + t * SEG_PITCH);
      float4 a0 = row[0], a1 = row[1], a2 = row[2], a3 = row[3];
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < SEG_QUADS; k += 8) {
        const float4 b0 = row[k + 4], b1 = row[k + 5], b2 = row[k + 6],
                     b3 = row[k + 7];
        acc = scan4(acc, a0, row + k);
        acc = scan4(acc, a1, row + k + 1);
        acc = scan4(acc, a2, row + k + 2);
        acc = scan4(acc, a3, row + k + 3);
        if (k + 8 < SEG_QUADS) {
          a0 = row[k + 8];
          a1 = row[k + 9];
          a2 = row[k + 10];
          a3 = row[k + 11];
        }
        acc = scan4(acc, b0, row + k + 4);
        acc = scan4(acc, b1, row + k + 5);
        acc = scan4(acc, b2, row + k + 6);
        acc = scan4(acc, b3, row + k + 7);
      }
      tot[t] = acc;
    }
    __syncthreads();
    if (t == 0) run = carry_chain(tot, carry, segs, run);
    __syncthreads();
    // every lane plus its segment's carry, 16 bytes a thread
    const int len = min(chunk, n - base);
    for (int i = 4 * t; i < len; i += 4 * CDF_THREADS) {
      float4 v = *reinterpret_cast<const float4*>(
          rows + (i / SCAN_SEGMENT) * SEG_PITCH + i % SCAN_SEGMENT);
      const float c = carry[i / SCAN_SEGMENT];
      v.x = __fadd_rn(c, v.x);
      v.y = __fadd_rn(c, v.y);
      v.z = __fadd_rn(c, v.z);
      v.w = __fadd_rn(c, v.w);
      float* out = cum + base + i;
      if (vec && i + 3 < len) {
        *reinterpret_cast<float4*>(out) = v;
      } else {
        out[0] = v.x;
        if (i + 1 < len) out[1] = v.y;
        if (i + 2 < len) out[2] = v.z;
        if (i + 3 < len) out[3] = v.w;
      }
    }
    if (base + chunk < n) __syncthreads();  // before the next chunk's rows
  }
}

}  // namespace

extern "C" int roulette_cdf_launch(const void* fitness, const void* pop_size,
                                   void* cum, int n_islands, int n,
                                   void* stream) {
  const int segs = (n + SCAN_SEGMENT - 1) / SCAN_SEGMENT;
  const int chunk_segs = segs < CHUNK_SEGS ? segs : CHUNK_SEGS;
  const size_t smem = cdf_smem_bytes(chunk_segs);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        roulette_cdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  roulette_cdf_kernel<<<n_islands, CDF_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)fitness, (const int*)pop_size, (float*)cum, n,
      chunk_segs);
  return (int)cudaGetLastError();
}
