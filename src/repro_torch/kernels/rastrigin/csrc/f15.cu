// CEC2010-F15 of a float population, a few rows per block.
//
// Replaces: src/repro/kernels/rastrigin/rastrigin.py::f15_kernel (the Pallas
// body _f15_kernel) and the shift / permute / pad that its wrapper
// kernels/rastrigin/ops.py::f15 runs before it. The island model reaches it
// through core/problems.py::make_f15(impl="pallas") at set-up and at each W²
// restart.
//
// Bound on the H100: operations. Per row of D = G * m genes the rotation is
// G * m * m multiply-adds: 50,000 at D = 1000, m = 50, so 1e9 f32
// operations at Fig. 4's 10,000 rows, 15 us at 67 TFLOP/s. The bytes are
// the population read once, 40 MB there (12 us at 3.35 TB/s), and the
// 200 KB rotation stack, which stays in L2: at 4 rows per block it is read
// 2500 times there, 500 MB through L2 per call.
//
// Design: a block takes ROWS rows. It stages each row shifted and permuted
// (z[j] = x[perm[j]] - o[perm[j]], the gather read straight from device
// memory) in shared memory, then f15_rows rotates, applies the term and
// sums in the plain version's order (kernels/rastrigin/ref.py). That tail
// is register-blocked (f15_rows.cuh, shared with the float
// generation kernel): each block reads the rotation stack once, a thread's
// 4 columns of M per step serving all ROWS rows, where it read the whole
// stack once per row before. This kernel's own launch (ROWS rows per
// block, 256 threads, the grid) is unchanged. No padding: the TPU padded m
// to its 128-lane matrix unit, which a CUDA core does not need. The
// product runs on the CUDA cores as separate multiplies and adds, not on
// the tensor cores, so the kernel and its plain version agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "f15_rows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;

__host__ __device__ inline size_t f15_smem_bytes(int D) {
  return 2 * (size_t)ROWS * (size_t)D * sizeof(float);  // zp + terms
}

__global__ void __launch_bounds__(THREADS)
f15_kernel(const float* __restrict__ pop, const float* __restrict__ o,
           const int* __restrict__ perm, const float* __restrict__ M,
           float* __restrict__ out, int n_rows, int D, int m, int G,
           int k_group) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* zp = reinterpret_cast<float*>(smem);
  float* terms = zp + (size_t)ROWS * D;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, n_rows - row0);
  const float* src = pop + (size_t)row0 * D;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, j = i - r * D;
    const int p = perm[j];
    zp[i] = __fsub_rn(src[(size_t)r * D + p], o[p]);
  }
  __syncthreads();
  f15_rows<ROWS>(zp, terms, rows, D, m, G, k_group, M, out + row0, 1.0f);
}

}  // namespace

extern "C" int f15_launch(const void* pop, const void* o, const void* perm,
                          const void* M, void* out, int n_rows, int D, int m,
                          int G, int k_group, void* stream) {
  const size_t smem = f15_smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        f15_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_rows + ROWS - 1) / ROWS;
  f15_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)pop, (const float*)o, (const int*)perm, (const float*)M,
      (float*)out, n_rows, D, m, G, k_group);
  return (int)cudaGetLastError();
}
