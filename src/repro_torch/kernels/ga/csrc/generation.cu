// One whole GA generation per island, binary genomes, a cluster of CTAs per
// island.
//
// Replaces: src/repro/kernels/ga/generation.py::generation_kernel (the Pallas
// bodies _generation_kernel and _generation_eval_kernel), which the island
// model reaches through kernels/ga/ops.py::generation[_eval] under
// EAConfig(impl="pallas"), vmapped over islands.
//
// What it computes (kernels/ga/common.py::generation_math): the elite of the
// valid lanes, tournament or roulette parents, two-point or uniform crossover
// behind a rate gate, bit-flip mutation and, optionally, the trap / onemax /
// royal_road fitness of the new rows. All randomness is the counter-based
// Threefry-2x32 of rand.py, drawn on chip from two seed words per island with
// the salts of the protocol; the plain version draws the same bits from the
// same counters.
//
// Bound on the H100: integer operations. The kernel moves about 2*I*n*L bytes
// (a population in, a population out), 0.66 MB at the main path's 8 x 256 x
// 160, which is 0.2 us at 3.35 TB/s. It runs one Threefry (67 int32
// operations as compiled: a funnel shift per rotate, the key sums hoisted,
// the last round's x1 dead) per child gene for the mutation draw, one more
// per gene under uniform crossover, and 2k + 3 per child row for the plan:
// about 25 M int32 operations at the main-path shape, 0.73 us at 128 int32
// operations per SM per clock. What held the first design (one block per
// island) back was not that work but the card it left idle and the serial
// steps on each block's path: 8 blocks on 132 SMs at the main path, the
// island's tile copied one byte per thread, the elite found by one thread,
// one thread per row summing the fitness.
//
// Design: a cluster of C = min(16, n) CTAs per island (grid C x islands,
// cluster C x 1 x 1, launched by cudaLaunchKernelEx; C above 8 needs the
// non-portable cluster size), so 8 islands fill 128 SMs. Every CTA needs the
// whole island to gather parents from, so the island's (n, L) int8 tile comes
// into every CTA's shared memory at once by one TMA bulk copy multicast to
// the cluster (cp.async.bulk ... .multicast::cluster), issued by CTA 0 and
// completing on each CTA's mbarrier (waited with a timeout that traps, so a
// copy that never lands fails the launch; the timeout is wall-clock time, see
// async_copy.cuh). The bulk copy wants 16-byte sizes and addresses and an
// island starts at byte isl*n*L: the tile sits in shared memory at the
// source's offset modulo 16, the aligned middle comes in bulk and the ragged
// ends (under 16 bytes each) by plain loads. While the copy flies, each CTA
// builds the roulette CDF (the eighth warp, in the plain version's segmented
// order, plan_rows.cuh::roulette_cdf_warp) and draws the plan of its own
// ceil(n / C) rows. Only a
// CTA that holds rows below `elite` (CTA 0, and the next ones where a CTA has
// fewer rows than elite) finds the elite, beside the CDF (an arg-max across
// seven warps, plan_rows.cuh::elite_rows); the others read no elite row and
// skip it. Children go 4 genes per thread: a parent's 4 bytes by two aligned
// 32-bit shared loads and a funnel shift, each gene its own draw at counter
// (row - elite) * L + col, and one 32-bit store into device memory,
// consecutive threads on consecutive words. The fused fitness runs a warp per
// row over the CTA's new rows, read back from L2: one trap block per lane,
// the blocks added in ordered_sum's order (row_evals.cuh). So shared memory
// per CTA is the tile, the plan of its rows, masked fitness and CDF: n * L +
// 8n + 20 n / C bytes and about 170 more, under the first design's 2nL + 28n
// wherever that came near the card's 227 KB, so every island the first design
// ran still runs. Round-to-nearest intrinsics keep the compiler from
// contracting any f32 step into an FMA.
//
// Measured (chip_smoke.py phase 6, CUDA events, on an NVIDIA H100 80GB HBM3
// at 700.00 W): 0.01535 ms at 8 x 256 x 160 with fused trap and 16 CTAs per
// island, against 0.1317 ms for the first design and 0.01935 ms for 8 CTAs
// per island, timed in turns when C was chosen; 0.0147 ms per generation
// inside paper-8's step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper/csrc/async_copy.cuh"
#include "plan_rows.cuh"
#include "row_evals.cuh"
#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// the elite's warps; the last warp builds the roulette CDF beside them
constexpr int ELITE_WARPS = WARPS - 1;
constexpr int MAX_CLUSTER = 16;
// a tile that has not landed by then never will
constexpr uint64_t TILE_TIMEOUT_NS = 2000000000ull;

struct Params {
  int n, L, elite, selection, tournament_k, crossover;
  float crossover_rate, mutation_rate;
  BinaryEval ev;
  int rows;  // rows per CTA, ceil(n / C)
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// the words ahead of the byte regions: the tile's mbarrier (4), masked and
// cum (2n), the elite, the arg-max scratch and the plan of the CTA's rows
__host__ __device__ inline size_t words_bytes(int n, int elite, int rows) {
  return align16(4 * (4 + 2 * (size_t)n + elite + 4 * ELITE_WARPS +
                      5 * (size_t)rows));
}

__host__ __device__ inline size_t smem_bytes(int n, int L, int elite,
                                             int rows) {
  // + the tile, at the source's offset modulo 16, with room for the
  // funnel-shift loads' second word
  return words_bytes(n, elite, rows) + (size_t)n * L + 32;
}

// 4 bytes of shared memory from any address, by two aligned 32-bit loads
__device__ __forceinline__ uint32_t load4(const int8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
  return __funnelshift_r(w[0], w[1], (uint32_t)(a & 3) * 8);
}

struct Child {
  Params p;
  uint32_t k0, k1;
  int row0;
  const int8_t* tile;
  const int *idx_a, *idx_b, *cut1, *cut2, *gate;

  // gene col of the CTA's row t, from its parents' genes pa and pb
  __device__ __forceinline__ int8_t gene(int t, int col, int8_t pa,
                                         int8_t pb) const {
    const int row = row0 + t;
    int8_t kid = pa;
    if (row >= p.elite) {
      const uint32_t ctr =
          (uint32_t)(row - p.elite) * (uint32_t)p.L + (uint32_t)col;
      if (gate[t]) {
        const bool take =
            p.crossover == 0
                ? (col >= cut1[t] && col < cut2[t])
                : bernoulli_at(k0, k1, ctr, SALT_CROSSOVER, 0.5f);
        kid = take ? pb : pa;
      }
      if (bernoulli_at(k0, k1, ctr, SALT_MUTATE, p.mutation_rate))
        kid = (int8_t)(1 - kid);
    }
    return kid;
  }

  // the gene at flat index i of the CTA's rows, its parents read bytewise
  __device__ __forceinline__ int8_t gene_at(int i) const {
    const int t = i / p.L, col = i - t * p.L;
    return gene(t, col, tile[idx_a[t] * p.L + col],
                tile[idx_b[t] * p.L + col]);
  }

  // genes i .. i + 3, packed little-endian
  __device__ __forceinline__ uint32_t word_at(int i) const {
    const int t = i / p.L, col = i - t * p.L;
    uint32_t out = 0;
    if (col + 4 <= p.L) {  // one row: its parents' 4 bytes at once
      const uint32_t pa = load4(tile + idx_a[t] * p.L + col);
      const uint32_t pb = gate[t] ? load4(tile + idx_b[t] * p.L + col) : pa;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out |= (uint32_t)(uint8_t)gene(t, col + c, (int8_t)(pa >> (8 * c)),
                                       (int8_t)(pb >> (8 * c)))
               << (8 * c);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out |= (uint32_t)(uint8_t)gene_at(i + c) << (8 * c);
    }
    return out;
  }
};

__global__ void __launch_bounds__(THREADS)
generation_kernel(const int8_t* __restrict__ pop,
                  const float* __restrict__ fitness,
                  const int64_t* __restrict__ seed, int seed_stride,
                  const int* __restrict__ pop_size,
                  int8_t* __restrict__ new_pop, float* __restrict__ fit_out,
                  Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = p.n, L = p.L, elite = p.elite, R = p.rows;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* masked = reinterpret_cast<float*>(smem + 16);
  float* cum = masked + n;
  int* elite_idx = reinterpret_cast<int*>(cum + n);
  float* red = reinterpret_cast<float*>(elite_idx + elite);
  int* idx_a = reinterpret_cast<int*>(red + 4 * ELITE_WARPS);
  int* idx_b = idx_a + R;
  int* cut1 = idx_b + R;
  int* cut2 = cut1 + R;
  int* gate = cut2 + R;
  unsigned char* tile_region = smem + words_bytes(n, elite, R);

  const int isl = blockIdx.y;
  const int rank = (int)hopper::cluster_rank();
  const int row0 = rank * R;
  const int rows = max(0, min(R, n - row0));
  // the key words are int64 holding 32-bit values: keep the low word
  const int64_t* words = seed + (size_t)isl * seed_stride;
  const uint32_t k0 = (uint32_t)words[0], k1 = (uint32_t)words[1];
  const int size = pop_size[isl];
  const uint32_t maxval = (uint32_t)max(size, 1);
  const float* fit = fitness + (size_t)isl * n;

  // the tile: ragged head, 16-byte-aligned body by the bulk copy, ragged
  // tail; the body lands 16-byte-aligned in every CTA of the cluster
  const int8_t* src = pop + (size_t)isl * n * L;
  const size_t tile_n = (size_t)n * L;
  const uint32_t mis = (uint32_t)(reinterpret_cast<uintptr_t>(src) & 15);
  int8_t* tile = reinterpret_cast<int8_t*>(tile_region + mis);
  const size_t to16 = (16 - mis) & 15;
  const uint32_t head = (uint32_t)(to16 < tile_n ? to16 : tile_n);
  const uint32_t body = (uint32_t)((tile_n - head) & ~(size_t)15);
  const size_t tail0 = (size_t)head + body;

  // ---- phase 0: the barrier, masked fitness and the ragged ends
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
    if (body) hopper::mbar_expect_tx(bar, body);
  }
  for (int r = threadIdx.x; r < n; r += THREADS)
    masked[r] = r < size ? fit[r] : neg_inf();
  for (uint32_t i = threadIdx.x; i < head; i += THREADS) tile[i] = src[i];
  for (size_t i = tail0 + threadIdx.x; i < tile_n; i += THREADS)
    tile[i] = src[i];
  // every CTA's barrier is set before the copy completes on it
  hopper::cluster_arrive();
  hopper::cluster_wait();
  if (rank == 0 && threadIdx.x == 0 && body)
    hopper::bulk_copy_multicast(tile + head, src + head, body, bar,
                                (uint16_t)((1u << gridDim.x) - 1));

  // ---- phase 1a: the elite beside the roulette CDF, while the tile lands;
  // the elite only where this CTA's rows start below it (uniform per CTA)
  if (threadIdx.x < ELITE_WARPS * 32) {
    if (row0 < elite)
      elite_rows(masked, n, elite, ELITE_WARPS, red, elite_idx);
  } else if (p.selection == 1) {
    roulette_cdf_warp(masked, n, cum);
  }
  __syncthreads();

  // ---- phase 1b: parents, cuts and gate of the CTA's rows
  for (int t = threadIdx.x; t < rows; t += THREADS) {
    const int row = row0 + t;
    if (row < elite) {
      idx_a[t] = idx_b[t] = elite_idx[row];
      cut1[t] = cut2[t] = gate[t] = 0;
    } else {
      const RowPlan rp = child_row_plan(k0, k1, row - elite, masked, cum, n,
                                        maxval, p.selection, p.tournament_k,
                                        p.crossover, L, p.crossover_rate);
      idx_a[t] = rp.a;
      idx_b[t] = rp.b;
      cut1[t] = rp.cut1;
      cut2[t] = rp.cut2;
      gate[t] = rp.gate;
    }
  }
  __syncthreads();
  if (body) hopper::mbar_wait_or_trap(bar, 0, TILE_TIMEOUT_NS);
  // this CTA's copy has landed; CTA 0 leaves only when every CTA's has
  hopper::cluster_arrive();

  // ---- phase 2: crossover and mutation, 4 genes per thread
  int8_t* dst = new_pop + ((size_t)isl * n + row0) * L;
  const uint32_t out_mis = (uint32_t)(reinterpret_cast<uintptr_t>(dst) & 3);
  const int total = rows * L;
  const int lead = min(total, (int)((4 - out_mis) & 3));
  const int n_words = (total - lead) >> 2;
  const int tail = lead + 4 * n_words;
  const Child child{p, k0, k1, row0, tile, idx_a, idx_b, cut1, cut2, gate};
  for (int w = threadIdx.x; w < n_words; w += THREADS) {
    const int i = lead + 4 * w;
    *reinterpret_cast<uint32_t*>(dst + i) = child.word_at(i);
  }
  for (int u = threadIdx.x; u < lead + total - tail; u += THREADS) {
    const int i = u < lead ? u : tail + (u - lead);
    dst[i] = child.gene_at(i);
  }

  // ---- phase 3: fused fitness of the CTA's rows, a warp per row, read
  // back from device memory (L2) after the block's barrier
  if (p.ev.kind != EVAL_NONE) {
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int t = warp; t < rows; t += WARPS) {
      const float f = binary_row_fitness_warp(dst + (size_t)t * L, p.ev,
                                              lane);
      if (lane == 0) fit_out[(size_t)isl * n + row0 + t] = f;
    }
  }
  hopper::cluster_wait();
}

}  // namespace

// the CTAs per island: one per row, at most MAX_CLUSTER
inline int cluster_size(int n) { return n < MAX_CLUSTER ? n : MAX_CLUSTER; }

extern "C" int generation_smem_bytes(int n, int L, int elite) {
  const int cluster = cluster_size(n);
  return (int)smem_bytes(n, L, elite, (n + cluster - 1) / cluster);
}

extern "C" int generation_max_smem_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

extern "C" int generation_launch(
    const void* pop, const void* fitness, const void* seed, int seed_stride,
    const void* pop_size, void* new_pop, void* fit_out, int n_islands, int n,
    int L, int elite, int selection, int tournament_k, int crossover,
    float crossover_rate, float mutation_rate, int eval_kind, int trap_l,
    int trap_group, float a, float b, float z, float l_minus_z, int royal_r,
    void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int cluster = cluster_size(n);
  const BinaryEval ev{eval_kind, L, trap_l, trap_group, a, b, z, l_minus_z,
                      royal_r};
  const int rows = (n + cluster - 1) / cluster;
  const Params p{n,         L,           elite,          selection,
                 tournament_k, crossover, crossover_rate, mutation_rate,
                 ev,        rows};
  const size_t smem = smem_bytes(n, L, elite, rows);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(generation_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(generation_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n_islands);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, generation_kernel, (const int8_t*)pop,
                           (const float*)fitness, (const int64_t*)seed,
                           seed_stride, (const int*)pop_size,
                           (int8_t*)new_pop, (float*)fit_out, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
