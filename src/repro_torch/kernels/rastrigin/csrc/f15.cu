// CEC2010-F15 of a float population: tiles of many rows in shared memory,
// each group's rotation staged once per tile by a bulk copy, twelve compute
// warps fed by four helper warps.
//
// Replaces: src/repro/kernels/rastrigin/rastrigin.py::f15_kernel (the Pallas
// body _f15_kernel) and the shift / permute / pad that its wrapper
// kernels/rastrigin/ops.py::f15 runs before it. The island model reaches it
// through core/problems.py::make_f15(impl="pallas") at set-up and at each W²
// restart, and the tiled generation path (kernels/ga/tiling.py) after each
// generation.
//
// Bound on the H100: operations. Per row of D = G * m genes the rotation is
// G * m * m multiply-adds, 50,000 at D = 1000, m = 50. The plain version
// rounds each multiply and each add apart (no FMA), so each multiply-add is
// two FP32-pipe instructions, and each gene's term (cosf's fast path) is 32
// more (chip_smoke.py counts them in this kernel's SASS): 1.32e9
// instructions at Fig. 4's 10,000 rows, 40 us of issue on 132 SMs x 128
// lanes at 1.98 GHz. The bytes are the population read once, 40 MB there
// (12 us at 3.35 TB/s).
//
// Design. A block takes a tile of `rows` consecutive rows and loops over
// the tiles (gridDim.x blocks, as many as the card holds at once; the
// wrapper kernels/rastrigin/f15.py::launch_shape picks rows, groups per
// batch and grid from n, D, m, the card's SMs and the occupancy of the
// shared memory they need). The tile's rows are contiguous in device
// memory: one bulk copy (cp.async.bulk, the 16-byte-aligned body; the
// ragged ends, under 16 bytes each, by plain loads) brings them into shared
// memory at the source's offset modulo 16. Groups go in batches of `gpb`;
// a batch's rotations M[g0 .. g0 + gpb) (contiguous) come by one bulk copy
// into one half of a two-half ring, each half behind an mbarrier, issued a
// whole batch ahead of their use. So each element of M crosses L2 once per
// tile, not once per 4 rows as in the first design (M read by __ldg from
// every block of 4 rows: 500 MB through L2 at 10,000 rows). Each batch:
// - the compute warps take a micro-tile of RB rows x KB columns of one
//   group each, both operands from shared memory (even m: z and M's rows in
//   column pairs by 8-byte loads; odd m: one column at a time), apply the
//   Rastrigin term and, once every compute warp has read z, write the terms
//   where z was;
// - the helper warps meanwhile sum the previous batch's terms, a thread per
//   (group, row) in ordered_sum's order, gather the next batch's z = x[perm]
//   - o from the staged rows (a thread per column, down the rows), and,
//   after a tile's last z, bring the next tile's rows in, a batch ahead;
//   after a tile's last batch a thread per row adds its group sums in group
//   order.
// Where no row fits shared memory beside the ring (D above 51,900 at m 50),
// the rows are not staged: the helpers gather z from device memory (the
// `gather` launch), and everything else stays as it is. Where not even two
// rotations fit the ring (m above 169), the sliced route below runs
// instead.
// The arithmetic is f15_rows.cuh's (rotate_step, rotate_pair_step,
// rastrigin_term, ordered_sum's order), so kernel and plain version
// (kernels/rastrigin/ref.py) agree bit for bit. No padding: the TPU padded
// m to its 128-lane matrix unit, which a CUDA core does not need.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper/csrc/async_copy.cuh"
#include "f15_rows.cuh"

namespace {

// twelve compute warps rotate, four helper warps stage, gather and sum
constexpr int COMPUTE = 384, HELPERS = 128, THREADS = COMPUTE + HELPERS;
constexpr int RB = 4;  // rows of a thread's micro-tile
constexpr int KB = 4;  // columns of a thread's micro-tile
// a copy that has not landed after this long traps (async_copy.cuh)
constexpr uint64_t COPY_TIMEOUT_NS = 2000000000ull;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// A block's shared memory, in bytes from its start: three mbarriers (the
// rows, the ring's two halves), the rows (rows * D f32 and 16 bytes for
// their offset; none where z is gathered from device memory), the ring (two
// halves of gpb * m * m f32 and 16 bytes), two buffers of rows * gpb * m
// f32, each a batch's z and then its terms, and the tile's group sums
// (rows * D / m f32).
// kernels/rastrigin/f15.py::smem_bytes computes the same total.
struct Layout {
  size_t xs, half, ring, buf, gs, bytes;
};

__host__ __device__ inline Layout layout(int rows, int D, int m, int gpb,
                                         bool gather) {
  Layout l;
  size_t off = 32;
  l.xs = off;
  if (!gather) off += align16((size_t)rows * D * 4 + 16);
  l.half = align16((size_t)gpb * m * m * 4 + 16);
  l.ring = off;
  off += 2 * l.half;
  l.buf = off;
  off += 2 * align16((size_t)rows * gpb * m * 4);
  l.gs = off;
  off += align16((size_t)rows * (D / m) * 4);
  l.bytes = off;
  return l;
}

// n floats from device memory at src, to sit in the shared region at
// `region` (16-byte aligned, 4n + 16 bytes) at src's offset modulo 16: the
// first `head` floats and the tail after the 16-byte-aligned body (under 4
// floats each) by plain loads, the body (`body` bytes) by one bulk copy.
struct Span {
  float* dst;
  const float* src;
  size_t n;
  uint32_t head, body;
};

__device__ __forceinline__ Span span_of(unsigned char* region,
                                        const float* src, size_t n) {
  const uint32_t mis = (uint32_t)(reinterpret_cast<uintptr_t>(src) & 15);
  Span s;
  s.dst = reinterpret_cast<float*>(region + mis);
  s.src = src;
  s.n = n;
  const size_t to16 = ((16 - mis) & 15) / 4;
  s.head = (uint32_t)(to16 < n ? to16 : n);
  s.body = (uint32_t)(((n - s.head) * 4) & ~(size_t)15);
  return s;
}

// ragged float e (0-2: the head, 3-5: the tail) of the span, if it has one
__device__ __forceinline__ void span_ragged(const Span& s, int e) {
  const size_t tail0 = s.head + s.body / 4;
  const size_t i = e < 3 ? (size_t)e : tail0 + (size_t)(e - 3);
  if (e < 3 ? i < s.head : i < s.n) s.dst[i] = s.src[i];
}

// rotate_tile (f15_rows.cuh) with Mg in shared memory: one column of M's
// row j per step
template <int ROWS, int KB_>
__device__ __forceinline__ void rotate_shared(float (&acc)[ROWS][KB_],
                                              const float* z, const int* zr,
                                              const float* Mg, int m,
                                              int k0) {
  int kc[KB_];
#pragma unroll
  for (int c = 0; c < KB_; ++c) kc[c] = min(k0 + c, m - 1);
  float mj[KB_];
#pragma unroll
  for (int c = 0; c < KB_; ++c) mj[c] = Mg[kc[c]];
  rotate_step<true>(acc, z, zr, 0, mj);
  for (int j = 1; j < m; ++j) {
    const float* Mj = Mg + (size_t)j * m;
#pragma unroll
    for (int c = 0; c < KB_; ++c) mj[c] = Mj[kc[c]];
    rotate_step<false>(acc, z, zr, j, mj);
  }
}

// rotate_tile_pairs (f15_rows.cuh) with Mg in shared memory: even m, z and
// Mg 8-byte aligned; two steps of j at a time, each row's z[j], z[j + 1]
// and each pair of M's columns by one 8-byte load
template <int ROWS, int KB_>
__device__ __forceinline__ void rotate_pairs_shared(float (&acc)[ROWS][KB_],
                                                    const float* z,
                                                    const int* zr,
                                                    const float* Mg, int m,
                                                    int k0) {
  static_assert(KB_ % 2 == 0, "columns go in pairs");
  constexpr int P = KB_ / 2;
  int kp[P];  // a pair past m repeats m - 2, m - 1
#pragma unroll
  for (int q = 0; q < P; ++q) kp[q] = min(k0 + 2 * q, m - 2);
  float2 m0[P], m1[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    m0[q] = *reinterpret_cast<const float2*>(Mg + kp[q]);
    m1[q] = *reinterpret_cast<const float2*>(Mg + m + kp[q]);
  }
  rotate_pair_step<true>(acc, z, zr, 0, m0, m1);
#pragma unroll 2
  for (int j = 2; j < m; j += 2) {
    const float* Mj = Mg + (size_t)j * m;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      m0[q] = *reinterpret_cast<const float2*>(Mj + kp[q]);
      m1[q] = *reinterpret_cast<const float2*>(Mj + m + kp[q]);
    }
    rotate_pair_step<false>(acc, z, zr, j, m0, m1);
  }
}

// ordered_sum (f15_rows.cuh) for groups of at most 32 terms (sum_group's),
// each group's terms loaded at once ahead of its adds: the same adds in the
// same order
__device__ __forceinline__ float group_sum(const float* t, int n,
                                           int group) {
  float total = 0.0f;
  for (int g0 = 0; g0 < n; g0 += group) {
    const int len = min(group, n - g0);
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = i < len ? t[g0 + i] : 0.0f;
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < len) part = __fadd_rn(part, v[i]);
    total = __fadd_rn(total, part);
  }
  return total;
}

// wait for a copy's barrier phase; the clock of the trapping wait
// (async_copy.cuh) is read only where the copy has not landed yet
__device__ __forceinline__ void wait_copy(uint64_t* bar, uint32_t parity) {
  if (!hopper::mbar_try_wait(bar, parity))
    hopper::mbar_wait_or_trap(bar, parity, COPY_TIMEOUT_NS);
}

__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// GATHER: z gathered from device memory, no rows staged (a template
// argument, so that the staged instance reads its rows from shared memory
// by shared-memory loads)
template <bool GATHER>
__global__ void __launch_bounds__(THREADS)
f15_kernel(const float* __restrict__ pop, const float* __restrict__ o,
           const int* __restrict__ perm, const float* __restrict__ M,
           float* __restrict__ out, int n_rows, int D, int m, int G,
           int k_group, int R, int gpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(R, D, m, gpb, GATHER);
  uint64_t* bar_x = reinterpret_cast<uint64_t*>(smem);
  uint64_t* bar_m = bar_x + 1;  // the ring's two halves
  unsigned char* ring = smem + lay.ring;
  const int tid = threadIdx.x;
  const int tiles = (n_rows + R - 1) / R;
  const int nb = (G + gpb - 1) / gpb;  // batches per tile
  const int my_tiles =
      (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int batches = my_tiles * nb;
  const int quads = (m + KB - 1) / KB;
  const bool pairs = m % 2 == 0 && (reinterpret_cast<uintptr_t>(M) & 7) == 0;
  const size_t mm = (size_t)m * m;
  const int h = tid - COMPUTE;  // a helper's index, negative in compute warps

  if (tid == 0) {
    hopper::mbar_init(bar_x, 1);
    hopper::mbar_init(bar_m, 1);
    hopper::mbar_init(bar_m + 1, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // batch q of this block: its tile (the block's q / nb-th), the tile's
  // rows, its first group and its groups
  struct Batch {
    int tile, rows, g0, pb;
    bool last;
  };
  auto batch = [&](int q) {
    Batch b;
    b.tile = (int)blockIdx.x + (q / nb) * (int)gridDim.x;
    b.rows = min(R, n_rows - b.tile * R);
    b.g0 = (q % nb) * gpb;
    b.pb = min(gpb, G - b.g0);
    b.last = q % nb == nb - 1;
    return b;
  };
  // batch q's z, then its terms: buf[q % 2], (group, row, column)
  auto buf = [&](int q) {
    return reinterpret_cast<float*>(smem + lay.buf) +
           (size_t)(q & 1) * R * gpb * m;
  };
  // batch q's rotations (contiguous in device memory) in the ring's half
  // q % 2; group g0 + p's at .dst + p * m * m
  auto ring_span = [&](int q) {
    const Batch b = batch(q);
    return span_of(ring + (size_t)(q & 1) * lay.half, M + (size_t)b.g0 * mm,
                   (size_t)b.pb * mm);
  };
  // the rotations of batch q into the ring's half q % 2: one bulk copy
  // (one thread) and the ragged ends (helpers)
  auto issue_ring = [&](int q) {
    const Span s = ring_span(q);
    hopper::mbar_expect_tx(bar_m + (q & 1), s.body);
    if (s.body)
      hopper::bulk_copy(s.dst + s.head, s.src + s.head, s.body,
                        bar_m + (q & 1));
  };
  auto ragged_ring = [&](int q) {
    if (h < 6) span_ragged(ring_span(q), h);
  };
  // (helpers) batch q's tile's rows into xs (none where z is gathered)
  const float* xs = nullptr;
  auto stage_rows = [&](int q) {
    if constexpr (!GATHER) {
      const Batch b = batch(q);
      const Span s = span_of(smem + lay.xs, pop + (size_t)b.tile * R * D,
                             (size_t)b.rows * D);
      if (h == HELPERS - 1) {
        hopper::mbar_expect_tx(bar_x, s.body);
        if (s.body)
          hopper::bulk_copy(s.dst + s.head, s.src + s.head, s.body, bar_x);
      }
      if (h >= 0 && h < 6) span_ragged(s, h);
      xs = s.dst;
    }
  };
  // (helpers) batch q's z = x[perm] - o: from the staged rows, a thread per
  // column of the batch, down the rows, four columns' indices and shifts
  // loaded at once; or gathered from device memory
  constexpr int COLS = 4;
  auto build_z = [&](int q) {
    const Batch b = batch(q);
    const int cols = b.pb * m;
    float* zg = buf(q);
    if constexpr (GATHER) {
      // from device memory: a thread per column, as below, each column's
      // index and shift loaded once, then 8 rows of its columns at a time
      // (32 loads in flight)
      constexpr int GR = 8;
      const float* x0 = pop + (size_t)b.tile * R * D;
      for (int c0 = h; c0 < cols; c0 += COLS * HELPERS) {
        int col[COLS];
        float oc[COLS];
#pragma unroll
        for (int k = 0; k < COLS; ++k) {
          const int c = min(c0 + k * HELPERS, cols - 1);
          col[k] = __ldg(perm + (size_t)b.g0 * m + c);
        }
#pragma unroll
        for (int k = 0; k < COLS; ++k) oc[k] = __ldg(o + col[k]);
        for (int r0 = 0; r0 < b.rows; r0 += GR) {
          float v[GR][COLS];
#pragma unroll
          for (int i = 0; i < GR; ++i)
#pragma unroll
            for (int k = 0; k < COLS; ++k)
              v[i][k] = __ldg(x0 + (size_t)min(r0 + i, b.rows - 1) * D +
                              col[k]);
#pragma unroll
          for (int k = 0; k < COLS; ++k) {
            const int c = c0 + k * HELPERS;
            float* dst = zg + (size_t)(c / m) * (R - 1) * m + c;
#pragma unroll
            for (int i = 0; i < GR; ++i)
              if (c < cols && r0 + i < b.rows)
                dst[(size_t)(r0 + i) * m] = __fsub_rn(v[i][k], oc[k]);
          }
        }
      }
    } else {
      for (int c0 = h; c0 < cols; c0 += COLS * HELPERS) {
        int col[COLS];
        float oc[COLS];
#pragma unroll
        for (int k = 0; k < COLS; ++k) {
          const int c = min(c0 + k * HELPERS, cols - 1);
          col[k] = __ldg(perm + (size_t)b.g0 * m + c);
        }
#pragma unroll
        for (int k = 0; k < COLS; ++k) oc[k] = __ldg(o + col[k]);
#pragma unroll
        for (int k = 0; k < COLS; ++k) {
          const int c = c0 + k * HELPERS;
          if (c >= cols) break;
          const float* src = xs + col[k];
          // row 0 of z[p][.][j], c = p * m + j
          float* dst = zg + (size_t)(c / m) * (R - 1) * m + c;
#pragma unroll 4
          for (int r = 0; r < b.rows; ++r)
            dst[(size_t)r * m] = __fsub_rn(src[(size_t)r * D], oc[k]);
        }
      }
    }
  };
  // (helpers) batch q's terms summed, a thread per (group, row), each in
  // ordered_sum's order; after the tile's last batch, a thread per row adds
  // its group sums in group order and writes the total
  float* gs = reinterpret_cast<float*>(smem + lay.gs);
  auto sum_terms = [&](int q) {
    const Batch b = batch(q);
    for (int i = h; i < b.pb * b.rows; i += HELPERS) {
      const int p = i / b.rows, r = i - p * b.rows;
      gs[(size_t)(b.g0 + p) * R + r] =
          group_sum(buf(q) + ((size_t)p * R + r) * m, m, k_group);
    }
    if (!b.last) return;
    named_barrier(2, HELPERS);
    for (int r = h; r < b.rows; r += HELPERS) {
      float total = 0.0f;
      for (int g = 0; g < G; ++g)
        total = __fadd_rn(total, gs[(size_t)g * R + r]);
      out[(size_t)b.tile * R + r] = total;
    }
  };

  // (helpers) batch q's z, from its tile's rows (waited for at the tile's
  // first batch); after a tile's last batch's z, the next tile's rows come
  // in, a batch ahead of their use
  auto next_z = [&](int q) {
    if (!GATHER && q % nb == 0)
      wait_copy(bar_x, (q / nb) & 1);
    build_z(q);
    if (batch(q).last && q + 1 < batches) {
      named_barrier(2, HELPERS);  // every helper has read the rows
      stage_rows(q + 1);
    }
  };

  // the first batch's rows, rotations and z
  if (h >= 0) {
    stage_rows(0);
    if (h == HELPERS - 1) issue_ring(0);
    ragged_ring(0);
    named_barrier(2, HELPERS);  // the rows' ragged ends
    next_z(0);
  }
  __syncthreads();
  for (int q = 0; q < batches; ++q) {
    if (h < 0) {
      // compute warps: batch q's micro-tiles, a task per thread
      const Batch b = batch(q);
      const int rbk = (b.rows + RB - 1) / RB;
      const int tasks = b.pb * rbk * quads;
      float* zt = buf(q);
      // batch q + 1's rotations go out now, a whole batch ahead of their
      // use (a helper would issue them late: the compute warps leave the
      // helpers few issue slots)
      if (tid == 0 && q + 1 < batches) issue_ring(q + 1);
      int zr[RB];
      float acc[RB][KB];
      const int quad = tid % quads, t2 = tid / quads;
      const int rb = t2 % rbk, p = t2 / rbk, k0 = quad * KB;
      if (tid < tasks) {
        wait_copy(bar_m + (q & 1), (q >> 1) & 1);
        const float* Mg = ring_span(q).dst + (size_t)p * mm;
#pragma unroll
        for (int i = 0; i < RB; ++i)
          zr[i] = (p * R + min(rb * RB + i, b.rows - 1)) * m;
        if (pairs)
          rotate_pairs_shared<RB, KB>(acc, zt, zr, Mg, m, k0);
        else
          rotate_shared<RB, KB>(acc, zt, zr, Mg, m, k0);
        // every term (those of repeated rows and columns too), so the
        // compiler can interleave them
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int c = 0; c < KB; ++c) acc[i][c] = rastrigin_term(acc[i][c]);
      }
      named_barrier(1, COMPUTE);  // z read: the terms take its place
      if (tid < tasks) {
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int c = 0; c < KB; ++c)
            if (rb * RB + i < b.rows && k0 + c < m)
              zt[(size_t)zr[i] + k0 + c] = acc[i][c];
      }
    } else {
      // helpers: batch q + 1's rotations' ragged ends, batch q - 1's sums,
      // then batch q + 1's z in place of those terms
      if (q + 1 < batches) ragged_ring(q + 1);
      if (q > 0) sum_terms(q - 1);
      named_barrier(2, HELPERS);
      if (q + 1 < batches) next_z(q + 1);
    }
    __syncthreads();
  }
  if (h >= 0) sum_terms(batches - 1);
}

// ---- the sliced route: any m and any D --------------------------------------
// f15_kernel holds two batches of whole rotations in shared memory, so it
// takes no m above 169 (two rotations of 115 KB fill the ring), no D whose
// group sums and buffers do not fit beside them even with z gathered, and
// no m above 1536 (a group's micro-tiles outnumber its compute threads).
// This route takes every (n, D, m): a block of SLICED_THREADS loops over
// tiles of R rows; for each group in order, each slice of C columns of its
// rotation (C a multiple of ordered_sum's group, or m), and each chunk of
// SLICE_J rows of M, it
// gathers z = x[perm] - o of the chunk from device memory and stages M's
// J x C block, and each thread carries its micro-tile's sums in registers
// across the chunks, j in order. After a slice, its terms go to shared
// memory and one thread per row adds them, in ordered_sum's groups, to its
// group's sum; after a group, the group's sum to the row's total. So the
// roundings and their order are those of the plain version, and shared
// memory stays under 150 KB at any shape (R x C <= 4096; the launch model,
// kernels/rastrigin/f15.py::sliced_shape, picks R and C).
constexpr int SLICED_THREADS = 256;
constexpr int SLICE_J = 32;
static_assert(KB == 4, "a micro-tile's columns are one float4 of M's block");
constexpr int ZP = SLICE_J + 1;  // pitch of z: a micro-tile's rows on
                                 // distinct banks

// pitch of M's block: C rounded up to whole micro-tile columns (16-byte rows)
__host__ __device__ inline int sliced_pitch(int C) { return (C + 3) & ~3; }

// bytes of the sliced route's shared memory: z (R x ZP), M's block
// (J x pitch), the slice's terms (R x (C + 1)); R a multiple of RB
// kernels/rastrigin/f15.py::sliced_smem_bytes computes the same total.
__host__ __device__ inline size_t sliced_bytes(int R, int C) {
  return 4 * ((size_t)R * ZP + (size_t)SLICE_J * sliced_pitch(C) +
              (size_t)R * (C + 1));
}

// row jj of M's staged block at this thread's KB columns from k0, one
// 16-byte load
__device__ __forceinline__ void m_row(float (&mj)[KB], const float* ms,
                                      int jj, int CP, int k0) {
  const float4 v = *reinterpret_cast<const float4*>(ms + jj * CP + k0);
  mj[0] = v.x;
  mj[1] = v.y;
  mj[2] = v.z;
  mj[3] = v.w;
}

__global__ void __launch_bounds__(SLICED_THREADS)
f15_sliced_kernel(const float* __restrict__ pop, const float* __restrict__ o,
                  const int* __restrict__ perm, const float* __restrict__ M,
                  float* __restrict__ out, int n_rows, int D, int m, int G,
                  int k_group, int R, int C) {
  extern __shared__ __align__(16) float fs[];
  const int CP = sliced_pitch(C);
  float* zs = fs;                     // [R][ZP]
  float* ms = zs + (size_t)R * ZP;    // [SLICE_J][CP]
  float* ts = ms + (size_t)SLICE_J * CP;  // [R][C + 1]
  const int tid = threadIdx.x;
  const int tiles = (n_rows + R - 1) / R;
  const int rbk = R / RB;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * R, rows = min(R, n_rows - row0);
    float total = 0.0f, gsum = 0.0f;  // thread r < rows: row r's sums
    for (int g = 0; g < G; ++g) {
      const int* pg = perm + (size_t)g * m;
      const float* Mg = M + (size_t)g * m * m;
      for (int c0 = 0; c0 < m; c0 += C) {
        const int cs = min(C, m - c0);
        const int quads = (cs + KB - 1) / KB;
        const bool active = tid < rbk * quads;
        const int rb = tid / quads, k0 = (tid - rb * quads) * KB;
        int zr[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) zr[i] = (rb * RB + i) * ZP;
        float acc[RB][KB];
        for (int j0 = 0; j0 < m; j0 += SLICE_J) {
          const int jn = min(SLICE_J, m - j0);
          __syncthreads();  // the last chunk's z and M, the last terms, read
          // z of the chunk (rows past the tile's as 0), then M's block
          // (columns past the slice as 0)
          for (int i = tid; i < R * SLICE_J; i += SLICED_THREADS) {
            const int r = i / SLICE_J, jj = i - r * SLICE_J;
            float z = 0.0f;
            if (r < rows && jj < jn) {
              const int col = __ldg(pg + j0 + jj);
              z = __fsub_rn(__ldg(pop + (size_t)(row0 + r) * D + col),
                            __ldg(o + col));
            }
            zs[r * ZP + jj] = z;
          }
          for (int i = tid; i < jn * CP; i += SLICED_THREADS) {
            const int jj = i / CP, c = i - jj * CP;
            ms[i] = c < cs ? __ldg(Mg + (size_t)(j0 + jj) * m + c0 + c)
                           : 0.0f;
          }
          __syncthreads();
          if (active) {
            float mj[KB];
            int jj = 0;
            if (j0 == 0) {
              m_row(mj, ms, 0, CP, k0);
              rotate_step<true>(acc, zs, zr, 0, mj);
              jj = 1;
            }
            for (; jj < jn; ++jj) {
              m_row(mj, ms, jj, CP, k0);
              rotate_step<false>(acc, zs, zr, jj, mj);
            }
          }
        }
        if (active) {
#pragma unroll
          for (int i = 0; i < RB; ++i)
#pragma unroll
            for (int c = 0; c < KB; ++c)
              if (rb * RB + i < rows && k0 + c < cs)
                ts[(rb * RB + i) * (C + 1) + k0 + c] =
                    rastrigin_term(acc[i][c]);
        }
        __syncthreads();
        // the slice starts one of ordered_sum's groups: add its groups'
        // sums in order to the row's group sum
        if (tid < rows) {
          const float* t = ts + tid * (C + 1);
          for (int a = 0; a < cs; a += k_group) {
            const int e = min(a + k_group, cs);
            float part = 0.0f;
            for (int i = a; i < e; ++i) part = __fadd_rn(part, t[i]);
            gsum = __fadd_rn(gsum, part);
          }
        }
      }
      if (tid < rows) {
        total = __fadd_rn(total, gsum);
        gsum = 0.0f;
      }
    }
    if (tid < rows) out[row0 + tid] = total;
  }
}

}  // namespace

// bytes of shared memory of a block: the tiled route at rows, gpb (cols 0;
// gather 1 where z is gathered from device memory) or the sliced route at
// rows, cols
extern "C" int f15_smem_bytes(int rows, int D, int m, int gpb, int cols,
                              int gather) {
  return cols > 0 ? (int)sliced_bytes(rows, cols)
                  : (int)layout(rows, D, m, gpb, gather).bytes;
}

// blocks of the F15 kernel (cols 0: the tiled route's, staged or gathered,
// else the sliced route's) an SM holds at `smem` bytes of shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an error
extern "C" int f15_blocks_per_sm(int smem, int cols, int gather) {
  int dev = 0, optin = 0, blocks = 0;
  const void* fn = cols > 0 ? (const void*)f15_sliced_kernel
                   : gather ? (const void*)f15_kernel<true>
                            : (const void*)f15_kernel<false>;
  const int threads = cols > 0 ? SLICED_THREADS : THREADS;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    (size_t)smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// the card's SMs, shared memory per SM, per block (opt-in) and reserved
// per block, into out[0..3]; 0 or a cudaError_t
extern "C" int f15_device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = cudaDeviceGetAttribute(out + i, attrs[i], dev);
  return (int)err;
}

// The tiled route (cols 0: tiles of `rows` rows, batches of `gpb` groups,
// the rows staged in shared memory or, gather 1, z gathered from device
// memory) or the sliced route (cols > 0: tiles of `rows` rows, a multiple of
// 4, slices of `cols` columns, a multiple of k_group or m, rows * cols <=
// 4096), `blocks` blocks looping over the tiles.
extern "C" int f15_launch(const void* pop, const void* o, const void* perm,
                          const void* M, void* out, int n_rows, int D, int m,
                          int G, int k_group, int rows, int gpb, int cols,
                          int gather, int blocks, void* stream) {
  if (blocks < 1 || k_group < 1 || k_group > 32 || rows < 1 ||
      blocks > (n_rows + rows - 1) / rows)
    return (int)cudaErrorInvalidValue;
  if (cols > 0) {
    if (rows % RB || cols > m || (cols < m && cols % k_group) ||
        (rows / RB) * ((cols + KB - 1) / KB) > SLICED_THREADS)
      return (int)cudaErrorInvalidValue;
    const size_t smem = sliced_bytes(rows, cols);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          f15_sliced_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    f15_sliced_kernel<<<blocks, SLICED_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)pop, (const float*)o, (const int*)perm, (const float*)M,
        (float*)out, n_rows, D, m, G, k_group, rows, cols);
    return (int)cudaGetLastError();
  }
  if (rows > HELPERS || gpb < 1 || gpb > G ||
      gpb * ((rows + RB - 1) / RB) * ((m + KB - 1) / KB) > COMPUTE)
    return (int)cudaErrorInvalidValue;
  const size_t smem = layout(rows, D, m, gpb, gather != 0).bytes;
  auto kernel = gather ? f15_kernel<true> : f15_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)pop, (const float*)o, (const int*)perm, (const float*)M,
      (float*)out, n_rows, D, m, G, k_group, rows, gpb);
  return (int)cudaGetLastError();
}
