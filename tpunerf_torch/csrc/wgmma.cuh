// Hopper's warpgroup matrix products (wgmma) in bf16 with f32 sums, and the
// ring of swizzled shared-memory tiles that cp.async fills for them: the
// pieces the tensor-core attention kernels share (attention.cu's forward
// #4, attention_bwd.cu's backward #12 and #13).
//
// A tile holds R rows of DP bf16 (the head dim zero-padded to DP) in
// wgmma's swizzled layout: atoms of W bytes a row (the widest of 128 and
// 32 that DP fills) stacked along the head dim, each R rows deep; the
// 16-byte chunk cw of a row sits at (cw ^ row bits) within its atom row,
// the XOR that cp.async applies on the way in and wgmma undoes on the way
// out. A tile starts on a whole number of atoms of 8 rows (1024-byte
// boundaries for 128-byte atoms, 256 for 32). One tile serves both operand
// orders: K-major (the head dim is the product's depth: q·kᵀ) and MN-major
// (the rows are the depth: p·v).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace tpn {

// 16 bytes global -> shared; `bytes` = 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes global -> shared; `bytes` = 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// The ring's barriers: full[s] at full0 + 8s for `nfull` arrivals and
// empty[s] at empty0 + 8s for `nempty`, then one fence that makes them
// visible to the async proxy (mbar_init fences each). One thread runs it;
// the block syncs before anyone waits.
__device__ __forceinline__ void ring_init(uint32_t full0, uint32_t empty0,
                                          int stages, uint32_t nfull,
                                          uint32_t nempty) {
  for (int s = 0; s < stages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     full0 + 8 * s),
                 "r"(nfull)
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     empty0 + 8 * s),
                 "r"(nempty)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrives on `bar` once every earlier cp.async of this thread has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most `N` committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes, so that the
// compiler moves no access to them across a wgmma issue or wait.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(r[i]);
}

// named barriers between two consumer warpgroups (256 threads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
// a barrier of one warpgroup (128 threads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

template <int DP>
struct Swz {
  static_assert(DP % 16 == 0 && DP <= 128, "padded head dim");
  static constexpr int W = DP % 64 == 0 ? 128 : 32;  // atom row, bytes
  static constexpr int CW = W / 16;                 // 16-byte chunks in it
  static constexpr uint64_t kMode = W == 128 ? 1 : 3;
};

// byte offset of the i-th 16-byte chunk in atom-major order
template <int DP>
__device__ __forceinline__ uint32_t swz(uint32_t i) {
  const uint32_t o = 16 * i;
  return o ^ (((o >> 7) & (Swz<DP>::CW - 1)) << 4);
}

// A tile of R rows read K-major: k-step kk takes head-dim columns
// 16kk..16kk+15 (the A or B operand of q·kᵀ)
template <int DP>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int R, int kk) {
  constexpr int W = Swz<DP>::W;
  const uint32_t off = (kk * 32 / W) * R * W + (kk * 32) % W;
  return make_desc(tile + off, 16, 8 * W, Swz<DP>::kMode);
}

// A tile of R rows read MN-major (N = head dim): k-step kk takes rows
// 16kk..16kk+15 (the B operand of p·v)
template <int DP>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int R, int kk) {
  constexpr int W = Swz<DP>::W;
  return make_desc(tile + kk * 16 * W, R * W, 8 * W, Swz<DP>::kMode);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// The bf16 A fragments of a 64 × 16·K f32 accumulator tile: k-step kk takes
// its column blocks 2kk and 2kk + 1 (the accumulator's layout is the A
// fragments' layout, so no shuffle).
template <int K>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[K][4],
                                           const float (&c)[8 * K]) {
#pragma unroll
  for (int n = 0; n < 2 * K; ++n) {
    a[n / 2][2 * (n % 2)] = pack_bf16(c[4 * n], c[4 * n + 1]);
    a[n / 2][2 * (n % 2) + 1] = pack_bf16(c[4 * n + 2], c[4 * n + 3]);
  }
}

// wgmma m64nNk16, bf16 in, f32 accumulate. `ss`: A and B from shared
// memory (both K-major); `rs`: A from registers, B MN-major in shared
// memory. `acc` = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n48(float (&d)[24], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// S (64 × N) = A·Bᵀ over DP/16 k-steps, A and B K-major tiles of 64 and N
// rows
template <int DP, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint32_t a,
                                         uint32_t b) {
  static_assert(N == 48 || N == 64 || N == 128, "score tile width");
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if constexpr (N == 48)
      wgmma_ss_n48(d, desc_k<DP>(a, 64, kk), desc_k<DP>(b, N, kk), kk > 0);
    else if constexpr (N == 64)
      wgmma_ss_n64(d, desc_k<DP>(a, 64, kk), desc_k<DP>(b, N, kk), kk > 0);
    else
      wgmma_ss_n128(d, desc_k<DP>(a, 64, kk), desc_k<DP>(b, N, kk), kk > 0);
  }
}

// d (64 × N) += A·Bᵀ for one k-step: A bf16 fragments, B read K-major
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
// S (64 × N) = A·Bᵀ over DP/16 k-steps: A bf16 fragments (64 rows × DP), B
// a K-major tile of N rows
template <int DP, int N>
__device__ __forceinline__ void wgmma_scores(float (&d)[N / 2],
                                             const uint32_t (&a)[DP / 16][4],
                                             uint32_t b) {
  static_assert(N == 64, "score tile width");
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_rs_n64_kmajor(d, a[kk], desc_k<DP>(b, N, kk), kk > 0);
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 × DP) += A·B for one k-step: A bf16 fragments, B a tile of R rows
// read MN-major (k-step kk: rows 16kk..16kk+15)
template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t (&a)[4], uint32_t b,
                                         int R, int kk) {
  const uint64_t db = desc_mn<DP>(b, R, kk);
  if constexpr (DP == 16) wgmma_rs_n16(d, a, db, 1);
  if constexpr (DP == 48) wgmma_rs_n48(d, a, db, 1);
  if constexpr (DP == 64) wgmma_rs_n64(d, a, db, 1);
  if constexpr (DP == 128) wgmma_rs_n128(d, a, db, 1);
}

// Copies `rows` rows of DP bf16 (row r at src + r*sn) into a tile at
// `dst`. Chunk i (16 bytes) goes to swz(i): consecutive threads fill
// consecutive chunks of a row of an atom. Rows >= nvalid and columns >= D
// are zero-filled.
template <int DP>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long sn, int rows, int nvalid,
                                          int D, int t, int nthreads) {
  constexpr int CW = Swz<DP>::CW;
  for (int i = t; i < rows * (DP / 8); i += nthreads) {
    const int r = (i / CW) % rows, c = ((i / (CW * rows)) * CW + i % CW) * 8;
    const bool ok = r < nvalid && c < D;
    cp_async16(dst + swz<DP>(i), ok ? src + r * sn + c : src, ok ? 16 : 0);
  }
}

}  // namespace tpn
