// Hopper (sm_90) asynchronous copies in inline PTX, shared by the kernels
// that use them: mbarriers (the tensor-core flash kernel's TMA ring in
// kernels/flash_attention/csrc/flash_tc.cu through wgmma.cuh, the binary
// generation kernel in kernels/ga/csrc/generation.cu and the WKV6 kernel's
// ring in kernels/rwkv6/csrc/wkv.cuh), the plain bulk copy from device memory
// into the shared memory of this CTA (the F15 kernel's rows and rotations,
// kernels/rastrigin/csrc/f15.cu) or of every CTA of a cluster, and the
// cluster's barrier and rank.
#pragma once

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the cluster and its async proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// arrive once and expect `bytes` of TMA traffic on the barrier's phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// mbar_wait that gives up after `timeout_ns` of the device's clock and
// traps: the launch then fails and the host's next synchronise raises,
// instead of the card hanging on a copy that never lands. The clock is
// %globaltimer, wall-clock time: a CTA that is preempted, time-sliced with
// another context or stopped under a debugger can pass the limit with no
// fault and trap, and a trap is a sticky error that ends the whole CUDA
// context, not just this launch. A limit of seconds (the generation
// kernel's 2 s, against a copy of microseconds) keeps that to stalls of
// that length; counting polls instead would tie the limit to how long
// each try_wait suspends, which the architecture leaves open.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  uint32_t parity,
                                                  uint64_t timeout_ns) {
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > timeout_ns) __trap();
}

// ---- bulk copies ------------------------------------------------------------
// `bytes` (a multiple of 16) from device memory at `src` into the shared
// memory at `dst` of every CTA of the cluster whose bit is set in `mask`,
// at the same offset in each, completing `bytes` on each one's barrier at
// the offset of `bar`. `src`, `dst` and `bytes` must be 16-byte aligned.
__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// `bytes` (a multiple of 16) from device memory at `src` into this CTA's
// shared memory at `dst`, completing `bytes` on the barrier `bar`. `src`,
// `dst` and `bytes` must be 16-byte aligned.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- clusters ---------------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster's barrier, split: every thread of every CTA arrives, then
// waits until all have arrived. Release and acquire order the memory
// operations before the arrive against those after the wait, cluster-wide.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace hopper
