// Shared-memory mbarriers and one-dimensional bulk copies (Hopper's TMA
// without a tensor map), for the kernels of hashgrid.cu and rasterize.cu
// and, through wgmma.cuh, the attention kernels.
//
// A bulk copy moves a contiguous run of global memory into shared memory;
// source, destination and size must be 16-byte multiples. Its completion
// is counted in bytes on an mbarrier: the issuing thread announces the
// bytes with `mbar_expect_tx`, every copy completes its share, and a
// waiter sees the barrier's phase flip.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpn {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Initialise the barrier at shared address `bar` for `count` arrivals and
// make it visible to the async proxy. The caller syncs the threads that
// will use it before anyone waits.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of copies to complete the phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.
// Traps after 4 s, so that a lost copy ends the kernel with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t k = 1;; ++k) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (k % 1024 == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 4000000000ull)
        __trap();
    }
  }
}

// Orders this thread's earlier generic accesses to shared memory before
// later async-proxy writes (a bulk copy into a buffer just read).
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One bulk copy of `bytes` (a 16-byte multiple, < 2^20) from global `src`
// to shared address `dst`, completed on the barrier at `bar`.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes from global `src` to shared address `dst` by cp.async (L2 only),
// in this thread's current group.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `N` of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tpn
