// Non-causal attention forward, softmax(q k^T * scale) v, for Hopper.
//
// Replaces the Pallas TPU flash-attention kernel that the JAX package calls
// from tpunerf/guidance/unet.py:_flash_sdpa (pl.pallas_call inside JAX's
// jax.experimental.pallas.ops.tpu.flash_attention), used by
// Attention.__call__ for the UNet's long self-attention (N = 4096 tokens at
// the 64x64 latent, 5 layers per UNet pass). Forward only: the UNet sits
// under a stop-gradient in SDS.
//
// Two entries, one per input type; q, k, v and the output are addressed
// through (batch, head, token) strides with a contiguous head dimension, so
// the UNet passes its (B, N, H, D) projections without a transpose copy.
//
// bf16 (the UNet's type): a flash-attention forward on the tensor cores.
// What bounds it: at (2, 8, 4096, 40) the two products are 4*B*H*N^2*D =
// 42.9 GFLOP, 43 us at the 989 TFLOP/s bf16 peak, but the softmax needs
// B*H*N^2 = 268 M exponentials, 64 us at 16 ex2 a clock per SM at 1980 MHz:
// the special-function unit, not the tensor cores, is the floor at D = 40.
// Design:
// * one block per (batch*head, 128-query tile): warpgroups 0 and 1 are
//   consumers of 64 queries each, warpgroup 2 the producer; setmaxnreg
//   moves registers from the producer to the consumers;
// * the producer streams 128-key tiles of K and V into a ring of shared
//   memory stages with cp.async (16 B a thread, zero-fill past N and D, so
//   the strided projections need no tensor map); each copy signals the
//   stage's `full` mbarrier when it lands (cp.async.mbarrier.arrive), and
//   the consumers release a stage through its `empty` mbarrier;
// * S = Q K^T is wgmma m64n128k16 with Q and K from shared memory, the head
//   dim zero-padded to DP (16, 48, 64 or 128) in shared memory only: zero
//   columns leave the logits unchanged;
// * O += P V is wgmma m64nDPk16 with P from registers (the f32 accumulator
//   layout of S is the bf16 A-fragment layout, so no shuffle) and V from
//   shared memory as an MN-major operand;
// * tiles are stored in wgmma's swizzled layouts (32-byte atoms for DP 16
//   and 48, 128-byte for 64 and 128), which cp.async writes chunk by chunk;
//   the unswizzled layout of 8x8 core matrices ran slower;
// * the online softmax keeps the running max and sum in f32; the scale is
//   applied to the f32 logits; per score one max, one FFMA (scale, subtract
//   the max), one ex2.approx, one add to the row sum and half a packed bf16
//   convert; the probabilities are rounded to bf16, as the plain path rounds
//   them before P.V; keys past N get -inf logits;
// * each warpgroup issues S_j and P_{j-1} V_{j-1} together and runs the
//   softmax of S_j while the second product is in flight; the two
//   warpgroups take turns to issue (named barriers), so that one's
//   exponentials overlap the other's products.
//
// f32 (the tiny card checks, unet_dtype float32, the VAE at C <= 128):
// the first, exact design (1e-5): one thread per query, both products on the
// CUDA cores in f32, K and V converted in shared memory.
//
// Every launch is on the caller's stream, allocates nothing, and returns
// cudaGetLastError(). A barrier wait that never completes traps instead of
// hanging the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, h, n;
};

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- f32 ---

constexpr int kQT = 64;  // queries per block, one per thread
constexpr int kKC = 16;  // keys per online-softmax update

template <int DP>
__global__ void __launch_bounds__(kQT)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int N, int D,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     float scale_log2) {
  constexpr int KT = DP <= 64 ? 64 : 32;  // keys per shared-memory tile
  __shared__ float s_k[KT][DP];
  __shared__ float s_v[KT][DP];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int qi = blockIdx.x * kQT + threadIdx.x;
  const bool active = qi < N;

  float qr[DP], acc[DP];
  {
    const float* qp =
        q + b * sq.b + h * sq.h + (long long)(active ? qi : 0) * sq.n;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      qr[c] = c < D ? qp[c] : 0.0f;
      acc[c] = 0.0f;
    }
  }
  float m = -INFINITY, l = 0.0f;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for (int k0 = 0; k0 < N; k0 += KT) {
    __syncthreads();
    for (int i = threadIdx.x; i < KT * DP; i += kQT) {
      const int r = i / DP, c = i % DP;
      const int key = k0 + r;
      const bool ok = key < N && c < D;
      s_k[r][c] = ok ? kb[(long long)key * sk.n + c] : 0.0f;
      s_v[r][c] = ok ? vb[(long long)key * sv.n + c] : 0.0f;
    }
    __syncthreads();
    const int nk = min(KT, N - k0);
    for (int j0 = 0; j0 < nk; j0 += kKC) {
      float s[kKC];
      float mc = m;
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        float d = 0.0f;
#pragma unroll
        for (int c = 0; c < DP; ++c) d = fmaf(qr[c], s_k[j0 + j][c], d);
        s[j] = j0 + j < nk ? d * scale_log2 : -INFINITY;
        mc = fmaxf(mc, s[j]);
      }
      // mc is finite: j0 < nk, so this chunk holds at least one key
      const float corr = exp2f(m - mc);
      l *= corr;
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] *= corr;
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        const float p = exp2f(s[j] - mc);
        l += p;
#pragma unroll
        for (int c = 0; c < DP; ++c) acc[c] = fmaf(p, s_v[j0 + j][c], acc[c]);
      }
      m = mc;
    }
  }
  if (active) {
    float* op = o + b * so.b + h * so.h + (long long)qi * so.n;
    const float inv = 1.0f / l;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < D) op[c] = acc[c] * inv;
    }
    // m and l are in log2 units of the scaled logits
    if (lse) lse[(long long)bh * N + qi] = (m + log2f(l)) * kLn2;
  }
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int N, int D, Strides sq,
                       Strides sk, Strides sv, Strides so, float scale_log2,
                       cudaStream_t stream) {
  dim3 grid((unsigned)((N + kQT - 1) / kQT), (unsigned)(B * H));
  attention_fwd_kernel<DP><<<grid, kQT, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, H, N,
      D, sq, sk, sv, so, scale_log2);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bf16 ---

constexpr int kWQ = 64;          // queries per consumer warpgroup
constexpr int kKT = 128;         // keys per K/V tile
constexpr int kProducers = 128;  // one producer warpgroup

template <int DP>
struct Bf16Cfg {
  static constexpr int kStages = DP <= 64 ? 4 : 3;
  static constexpr int kTileBytes = kKT * DP * 2;  // one K or V tile
  // consumer warpgroups (three, at 160 registers a thread, spill and
  // serialise their wgmma: slower)
  static constexpr int kWG = 2;
  static constexpr int kBQ = kWG * kWQ;            // queries per block
  static constexpr int kThreads = (kWG + 1) * 128;
  static constexpr int kQBytes = kWQ * DP * 2;     // one warpgroup's Q
  static constexpr int kBarBytes = 1024;  // full[], empty[]; tiles aligned
  static constexpr int kQOff = kBarBytes;
  static constexpr int kKVOff = kQOff + kWG * kQBytes;
  // + 1024: the kernel rounds the base of shared memory up to 1024 bytes
  static constexpr int kSmem = kKVOff + kStages * 2 * kTileBytes + 1024;
  static_assert(DP % 16 == 0 && DP <= 128, "padded head dim");
  static_assert(2 * kStages * 8 <= kBarBytes, "barriers");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; `bytes` = 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
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

// Waits for the completion of the barrier's phase of parity `parity`.
// Traps after 4 s, so that a lost arrival ends the kernel with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n % 1024 == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 4000000000ull)
        __trap();
    }
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

// Tiles of R rows x DP bf16 in wgmma's swizzled K-major layout: atoms of W
// bytes a row (the widest of 128 and 32 that DP fills) stacked along the
// head dim, each R rows deep; the 16-byte chunk cw of row r sits at
// (cw ^ (row bits)) within its row, the XOR cp.async applies on the way in
// and wgmma undoes on the way out. Tiles start on 1024-byte boundaries.
template <int DP>
struct Swz {
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

// Q or K tile of R rows: k-step kk takes head-dim columns 16kk..16kk+15
template <int DP>
__device__ __forceinline__ uint64_t desc_qk(uint32_t tile, int R, int kk) {
  constexpr int W = Swz<DP>::W;
  const uint32_t off = (kk * 32 / W) * R * W + (kk * 32) % W;
  return make_desc(tile + off, 16, 8 * W, Swz<DP>::kMode);
}

// V tile, read MN-major (N = head dim): k-step kk takes keys 16kk..16kk+15
template <int DP>
__device__ __forceinline__ uint64_t desc_v(uint32_t tile, int kk) {
  constexpr int W = Swz<DP>::W;
  return make_desc(tile + kk * 16 * W, kKT * W, 8 * W, Swz<DP>::kMode);
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

// wgmma m64nNk16, bf16 in, f32 accumulate. `ss`: A and B from shared
// memory (both K-major); `rs`: A from registers, B MN-major in shared
// memory. `acc` = 0 overwrites d.
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

template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
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

template <int DP>
__global__ void __launch_bounds__(Bf16Cfg<DP>::kThreads, 1)
attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int H, int N, int D,
                          Strides sq, Strides sk, Strides sv, Strides so,
                          float scale_log2) {
  using Cfg = Bf16Cfg<DP>;
  constexpr int S = Cfg::kStages;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t full0 = base, empty0 = base + 8 * S;
  const uint32_t kv0 = base + Cfg::kKVOff;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  constexpr int WG = Cfg::kWG;
  const int q0 = blockIdx.x * Cfg::kBQ;
  const int nt = (N + kKT - 1) / kKT;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, kProducers);
      mbar_init(empty0 + 8 * s, WG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WG) {
    // ---- producer: K and V tiles into the ring -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
    const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
    for (int j = 0; j < nt; ++j) {
      const int s = j % S;
      mbar_wait(empty0 + 8 * s, ((j / S) & 1) ^ 1);
      const uint32_t kd = kv0 + s * 2 * Cfg::kTileBytes;
      const long long k0 = (long long)j * kKT;
      load_rows<DP>(kd, kb + k0 * sk.n, sk.n, kKT, N - j * kKT, D, t,
                    kProducers);
      load_rows<DP>(kd + Cfg::kTileBytes, vb + k0 * sv.n, sv.n, kKT,
                    N - j * kKT, D, t, kProducers);
      cp_async_arrive(full0 + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ---- consumers: 64 queries each -------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int warp = t / 32, lane = t % 32;
    const int qw = q0 + wg * kWQ;  // this warpgroup's first query
    const uint32_t qs = base + Cfg::kQOff + wg * Cfg::kQBytes;
    load_rows<DP>(qs, q + b * sq.b + h * sq.h + (long long)qw * sq.n, sq.n,
                  kWQ, N - qw, D, t, 128);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
    // this thread's two rows: warp * 16 + lane / 4 (+ 8)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    float sc[kKT / 2];         // S_j, then P_j in f32
    uint32_t pa[kKT / 16][4];  // P_j in bf16, wgmma's A fragments

    auto stage_kd = [&](int j) {  // K tile of key tile j; V follows it
      return kv0 + (j % S) * 2 * Cfg::kTileBytes;
    };
    // waits for key tile j and for this warpgroup's turn to issue
    auto acquire = [&](int j) {
      mbar_wait(full0 + 8 * (j % S), (j / S) & 1);
      fence_proxy_async();
      named_sync(1 + WG + wg);
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
    };
    // the next warpgroup's turn; the last one skips its last, which
    // warpgroup 0 would never take
    auto release_turn = [&](int j) {
      if (wg + 1 < WG || j + 1 < nt) named_arrive(1 + WG + (wg + 1) % WG);
    };
    auto issue_qk = [&](int j) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n128(sc, desc_qk<DP>(qs, kWQ, kk),
                      desc_qk<DP>(stage_kd(j), kKT, kk), kk > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {
      const uint32_t vd = stage_kd(j) + Cfg::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk)
        wgmma_rs<DP>(acc, pa[kk], desc_v<DP>(vd, kk));
      wgmma_commit();
    };
    // S_j -> P_j (f32, in place), the running max and sum; `corr` gets
    // the factor by which the output so far is rescaled
    auto softmax = [&](int j, float (&corr)[2]) {
      fence_regs(sc);
      const int valid = N - j * kKT;
      if (valid < kKT) {
#pragma unroll
        for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * n + 2 * (lane % 4) + (e & 1) >= valid)
              sc[4 * n + e] = -INFINITY;
      }
      // row max and sum over kPart independent chains, so that two warps
      // a scheduler are not held by one chain's latency
      constexpr int kPart = 4;
      float mp[2][kPart];
#pragma unroll
      for (int c = 0; c < kPart; ++c) {
        mp[0][c] = fmaxf(sc[4 * c], sc[4 * c + 1]);
        mp[1][c] = fmaxf(sc[4 * c + 2], sc[4 * c + 3]);
      }
#pragma unroll
      for (int n = kPart; n < kKT / 8; ++n) {
        mp[0][n % kPart] =
            fmaxf(mp[0][n % kPart], fmaxf(sc[4 * n], sc[4 * n + 1]));
        mp[1][n % kPart] =
            fmaxf(mp[1][n % kPart], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = fmaxf(fmaxf(mp[i][0], mp[i][1]), fmaxf(mp[i][2], mp[i][3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // finite: every tile holds at least one key; exp2(-inf) = 0 on
        // the first tile
        const float mn = fmaxf(m[i], mx * scale_log2);
        corr[i] = ex2(m[i] - mn);
        m[i] = mn;
      }
      float sp[2][kPart] = {};
#pragma unroll
      for (int e = 0; e < kKT / 2; ++e) {
        const int i = (e / 2) % 2;  // row of accumulator element e
        sc[e] = ex2(fmaf(sc[e], scale_log2, -m[i]));
        sp[i][(e / 4) % kPart] += sc[e];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        l[i] = l[i] * corr[i] + ((sp[i][0] + sp[i][1]) + (sp[i][2] + sp[i][3]));
    };
    // k-step kk of P.V takes the score columns of accumulator blocks 2kk
    // and 2kk + 1
    auto pack = [&]() {
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n) {
        pa[n / 2][2 * (n % 2)] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
        pa[n / 2][2 * (n % 2) + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
      }
    };

    // Iteration j issues S_j = Q K_j^T and O += P_{j-1} V_{j-1} together,
    // runs the softmax of S_j while the second product is in flight, then
    // rescales O and packs P_j. The warpgroups take turns to issue (named
    // barrier 1 + WG + wg, warpgroup 0 first). The first iteration is
    // peeled: every wgmma group is then committed unconditionally, which
    // ptxas needs to keep the products asynchronous (else it serialises
    // them, C7514).
    if (wg == WG - 1) named_arrive(1 + WG);
    float corr[2];
    acquire(0);
    issue_qk(0);
    release_turn(0);
    wgmma_wait<0>();
    softmax(0, corr);
    pack();
    for (int j = 1; j < nt; ++j) {
      acquire(j);
      issue_qk(j);
      issue_pv(j - 1);
      release_turn(j);
      wgmma_wait<1>();  // S_j has landed
      softmax(j, corr);
      wgmma_wait<0>();  // O += P_{j-1} V_{j-1} has landed
      fence_regs(acc);
      mbar_arrive(empty0 + 8 * ((j - 1) % S));
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[4 * n] *= corr[0];
        acc[4 * n + 1] *= corr[0];
        acc[4 * n + 2] *= corr[1];
        acc[4 * n + 3] *= corr[1];
      }
      pack();
    }
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    issue_pv(nt - 1);
    wgmma_wait<0>();
    fence_regs(acc);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = qw + warp * 16 + lane / 4 + 8 * i;
      if (row >= N) continue;
      // the quad's four lanes hold the same m and l: one writes the row's
      // log-sum-exp (m and l are in log2 units of the scaled logits)
      if (lse && lane % 4 == 0)
        lse[(long long)bh * N + row] = (m[i] + log2f(l[i])) * kLn2;
      const float inv = 1.0f / l[i];
      __nv_bfloat16* op = o + b * so.b + h * so.h + (long long)row * so.n;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int c = 8 * n + 2 * (lane % 4);
        if (c < D)
          *reinterpret_cast<__nv_bfloat162*>(op + c) = __floats2bfloat162_rn(
              acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
      }
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int N, int D, Strides sq,
                        Strides sk, Strides sv, Strides so, float scale_log2,
                        cudaStream_t stream) {
  constexpr int smem = Bf16Cfg<DP>::kSmem;
  // once per instantiation (a static's initialiser runs once)
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  constexpr int bq = Bf16Cfg<DP>::kBQ;
  dim3 grid((unsigned)((N + bq - 1) / bq), (unsigned)(B * H));
  attention_fwd_bf16_kernel<DP><<<grid, Bf16Cfg<DP>::kThreads, smem,
                                   stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, H, N, D, sq, sk, sv,
      so, scale_log2);
  return cudaGetLastError();
}

bool aligned16(const void* p, Strides s) {
  // cp.async moves 16-byte chunks: 8 bf16
  return ((uintptr_t)p & 15) == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.n % 8 == 0;
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16. q, k, v, o are (B, H, N, D) views with
// the given (batch, head, token) element strides and a contiguous head dim.
// bf16 takes D % 8 == 0, 16-byte aligned q, k, v and strides that are
// multiples of 8, and scale > 0. `lse`, when not null, gets each query
// row's log-sum-exp of the scaled logits, (B, H, N) f32 contiguous: the
// backward's residual.
int attention_fwd(int dtype, const void* q, const void* k, const void* v,
                  void* o, void* lse, int B, int H, int N, int D,
                  long long q_sb,
                  long long q_sh, long long q_sn, long long k_sb,
                  long long k_sh, long long k_sn, long long v_sb,
                  long long v_sh, long long v_sn, long long o_sb,
                  long long o_sh, long long o_sn, float scale, void* stream) {
  if (N <= 0 || B * H <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > 128 || B * H > 65535) return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn},
      sv{v_sb, v_sh, v_sn}, so{o_sb, o_sh, o_sn};
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
#define TPUNERF_ATTN_CASE(DP)                                               \
  if (D <= DP)                                                              \
    return (int)launch_f32<DP>(q, k, v, o, (float*)lse, B, H, N, D, sq, sk, \
                               sv, so, scale_log2, s);
    TPUNERF_ATTN_CASE(40)
    TPUNERF_ATTN_CASE(64)
    TPUNERF_ATTN_CASE(128)
#undef TPUNERF_ATTN_CASE
  }
  if (dtype == 1) {
    if (D % 8 != 0 || !(scale > 0.0f) || !aligned16(q, sq) ||
        !aligned16(k, sk) || !aligned16(v, sv) || ((uintptr_t)o & 3) ||
        so.b % 2 || so.h % 2 || so.n % 2)
      return (int)cudaErrorInvalidValue;
#define TPUNERF_ATTN_CASE(DP)                                               \
  if (D <= DP)                                                              \
    return (int)launch_bf16<DP>(q, k, v, o, (float*)lse, B, H, N, D, sq, sk,\
                                sv, so, scale_log2, s);
    TPUNERF_ATTN_CASE(16)
    TPUNERF_ATTN_CASE(48)
    TPUNERF_ATTN_CASE(64)
    TPUNERF_ATTN_CASE(128)
#undef TPUNERF_ATTN_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
