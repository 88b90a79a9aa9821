// Non-causal attention backward for Hopper: #12 attention_bwd_dkv and #13
// attention_bwd_dq.
//
// Replaces the two Pallas TPU kernels of JAX's flash-attention backward that
// the JAX package runs whenever it differentiates through the UNet's long
// self-attention (tpunerf/guidance/unet.py:_flash_sdpa sets their block
// sizes; text-token optimisation and null-text inversion take such
// gradients): `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq` in
// jax/experimental/pallas/ops/tpu/flash_attention.py. The split into two
// kernels is JAX's own: every output row is summed by one thread in a fixed
// order, with no float atomics, so each result is the same bit for bit from
// call to call.
//
// With P = exp(s·q·kᵀ − lse) (lse from the forward kernel), Δ = rowsum(dO ∘
// O) (a torch reduction, as JAX leaves it to XLA) and dS = s·P ∘ (dO·Vᵀ − Δ):
//   #12: one block per (batch·head, tile of keys); it walks every query in
//        tiles through shared memory and accumulates dV = Pᵀ·dO and
//        dK = dSᵀ·Q in registers;
//   #13: one block per (batch·head, tile of queries); it walks the keys in
//        tiles and accumulates dQ = dS·K.
// In bf16, P and dS are rounded to bf16 before their products, as JAX's
// kernels cast them to the inputs' dtype; everything else is f32.
//
// What bounds them: at the UNet's (2, 8, 4096, 40) the seven products over
// the N² score matrix (S and dP in both kernels, dV, dK, dQ) are 7·2·N²·D·BH
// = 150 GFLOP: 0.152 ms on the bf16 tensor cores (67 TFLOP/s of f32 FMAs
// on the CUDA cores: 2.2 ms); the 2·BH·N² exponentials are 0.128 ms on the
// special-function units (16 a clock per SM), as much again as the products
// at this head dim, so the two must overlap. Three designs:
// * bf16 at padded head dims 48 and 64 (the UNet's D = 40, and 64): wgmma,
//   warp-specialised, with a cp.async ring ("bf16 on wgmma" below);
// * bf16 at D > 64 (no path runs it): mma.sync m16n8k16 ("bf16 on the
//   tensor cores" below), whose two 64 × 128 gradient accumulators would not
//   fit beside the score tiles in a wgmma warpgroup's registers; the same
//   kernels at every head dim are kept as the entries *_mma, timed beside
//   the wgmma ones;
// * f32 (a VAE mid-attention at C <= 128, unet_dtype float32), on the CUDA
//   cores: a row (a key in #12, a query in #13) is TPK adjacent threads,
//   each holding DP/TPK of its head-dim columns in registers, in float4
//   chunks interleaved so that the TPK threads read neighbouring 16-byte
//   words of a shared tile row (no bank conflict; the block's other rows
//   read the same words, broadcast); the row's dot products are summed
//   over the TPK lanes by shuffles. The head dim is zero-padded to DP in
//   shared memory and in registers.
//
// Inputs are (B, H, N, D) views with a contiguous head dim and any (batch,
// head, token) strides (in bf16 multiples of 8 on 16-byte aligned bases, as
// the forward kernel takes them); outputs likewise. Every launch is on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace tpn;

struct Strides {
  long long b, h, n;
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBwdThreads = 128;
constexpr int kBwdTile = 32;  // queries (#12) or keys (#13) a shared tile

// A row is TPK adjacent threads; thread `part` of it holds the float4
// chunks part, part + TPK, part + 2·TPK, ... of the DP padded columns.
template <int DP, int TPK>
struct BwdCfg {
  static constexpr int kChunks = DP / (4 * TPK);   // float4 chunks a thread
  static constexpr int kCols = 4 * kChunks;        // columns a thread
  static constexpr int kRows = kBwdThreads / TPK;  // rows a block
  static_assert(DP % (4 * TPK) == 0, "padded head dim");
  static_assert(TPK <= 32 && (TPK & (TPK - 1)) == 0, "lanes a row");
};

// the sum over the TPK lanes of a row; every lane gets the same value
template <int TPK>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPK; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// this thread's columns of one row (zero past D, or everywhere if !valid)
template <int DP, int TPK>
__device__ __forceinline__ void load_row(float (&r)[BwdCfg<DP, TPK>::kCols],
                                         const float* src, bool valid, int D,
                                         int part) {
#pragma unroll
  for (int i = 0; i < BwdCfg<DP, TPK>::kChunks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * (part + TPK * i) + e;
      r[4 * i + e] = valid && c < D ? src[c] : 0.0f;
    }
}

template <int DP, int TPK>
__device__ __forceinline__ void store_row(float* dst, const float* r, int D,
                                          int part) {
#pragma unroll
  for (int i = 0; i < BwdCfg<DP, TPK>::kChunks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * (part + TPK * i) + e;
      if (c < D) dst[c] = r[4 * i + e];
    }
}

// kBwdTile rows of DP columns into shared memory as f32 (row r at src +
// r·sn; rows >= nvalid and columns >= D zero)
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long sn, int nvalid, int D) {
  for (int i = threadIdx.x; i < kBwdTile * DP; i += kBwdThreads) {
    const int r = i / DP, c = i % DP;
    dst[i] = r < nvalid && c < D ? src[r * sn + c] : 0.0f;
  }
}

// The two dot products of this thread's columns with shared row j (x·a,
// y·b), four partial sums each, then summed over the row's lanes.
template <int DP, int TPK>
__device__ __forceinline__ void dots(const float4* a4, const float4* b4,
                                     const float (&x)[BwdCfg<DP, TPK>::kCols],
                                     const float (&y)[BwdCfg<DP, TPK>::kCols],
                                     int part, float& xa, float& yb) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < BwdCfg<DP, TPK>::kChunks; ++i) {
    const float4 a = a4[part + TPK * i], b = b4[part + TPK * i];
    s[0] = fmaf(a.x, x[4 * i], s[0]);
    s[1] = fmaf(a.y, x[4 * i + 1], s[1]);
    s[2] = fmaf(a.z, x[4 * i + 2], s[2]);
    s[3] = fmaf(a.w, x[4 * i + 3], s[3]);
    d[0] = fmaf(b.x, y[4 * i], d[0]);
    d[1] = fmaf(b.y, y[4 * i + 1], d[1]);
    d[2] = fmaf(b.z, y[4 * i + 2], d[2]);
    d[3] = fmaf(b.w, y[4 * i + 3], d[3]);
  }
  xa = row_sum<TPK>((s[0] + s[1]) + (s[2] + s[3]));
  yb = row_sum<TPK>((d[0] + d[1]) + (d[2] + d[3]));
}

// acc += w·(shared row a4), on this thread's columns
template <int DP, int TPK>
__device__ __forceinline__ void axpy(float (&acc)[BwdCfg<DP, TPK>::kCols],
                                     float w, const float4* a4, int part) {
#pragma unroll
  for (int i = 0; i < BwdCfg<DP, TPK>::kChunks; ++i) {
    const float4 a = a4[part + TPK * i];
    acc[4 * i] = fmaf(w, a.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(w, a.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, a.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, a.w, acc[4 * i + 3]);
  }
}

// #12: dK and dV of kRows keys; the queries stream through shared memory.
template <int DP, int TPK>
__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int N, int D, Strides sq,
                         Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, float scale, float scale_log2) {
  using Cfg = BwdCfg<DP, TPK>;
  constexpr int DC = Cfg::kCols;
  __shared__ __align__(16) float s_q[kBwdTile * DP];
  __shared__ __align__(16) float s_do[kBwdTile * DP];
  __shared__ float s_lse2[kBwdTile], s_delta[kBwdTile];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int part = threadIdx.x % TPK;
  const int key = blockIdx.x * Cfg::kRows + threadIdx.x / TPK;
  const bool active = key < N;
  const long long kr = active ? key : 0;
  float kv[DC], vv[DC], dka[DC], dva[DC];
  load_row<DP, TPK>(kv, k + b * sk.b + h * sk.h + kr * sk.n, active, D,
                       part);
  load_row<DP, TPK>(vv, v + b * sv.b + h * sv.h + kr * sv.n, active, D,
                       part);
#pragma unroll
  for (int c = 0; c < DC; ++c) dka[c] = dva[c] = 0.0f;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lb = lse + (long long)bh * N;
  const float* db = delta + (long long)bh * N;
  for (int q0 = 0; q0 < N; q0 += kBwdTile) {
    const int nq = min(kBwdTile, N - q0);
    __syncthreads();
    load_tile<DP>(s_q, qb + (long long)q0 * sq.n, sq.n, nq, D);
    load_tile<DP>(s_do, dob + (long long)q0 * sdo.n, sdo.n, nq, D);
    if (threadIdx.x < kBwdTile) {
      const bool ok = threadIdx.x < nq;
      s_lse2[threadIdx.x] = ok ? lb[q0 + threadIdx.x] * kLog2e : 0.0f;
      s_delta[threadIdx.x] = ok ? db[q0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < nq; ++j) {
      const float4* q4 = reinterpret_cast<const float4*>(s_q + j * DP);
      const float4* do4 = reinterpret_cast<const float4*>(s_do + j * DP);
      float s, dp;
      dots<DP, TPK>(q4, do4, kv, vv, part, s, dp);
      const float p = exp2f(fmaf(s, scale_log2, -s_lse2[j]));
      const float ds = (dp - s_delta[j]) * p * scale;
      axpy<DP, TPK>(dva, p, do4, part);
      axpy<DP, TPK>(dka, ds, q4, part);
    }
  }
  if (active) {
    store_row<DP, TPK>(dk + b * sdk.b + h * sdk.h + kr * sdk.n, dka, D,
                          part);
    store_row<DP, TPK>(dv + b * sdv.b + h * sdv.h + kr * sdv.n, dva, D,
                          part);
  }
}

// #13: dQ of kRows queries; the keys stream through shared memory.
template <int DP, int TPK>
__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int H, int N, int D, Strides sq, Strides sk,
                        Strides sv, Strides sdo, Strides sdq, float scale,
                        float scale_log2) {
  using Cfg = BwdCfg<DP, TPK>;
  constexpr int DC = Cfg::kCols;
  __shared__ __align__(16) float s_k[kBwdTile * DP];
  __shared__ __align__(16) float s_v[kBwdTile * DP];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int part = threadIdx.x % TPK;
  const int row = blockIdx.x * Cfg::kRows + threadIdx.x / TPK;
  const bool active = row < N;
  const long long qr = active ? row : 0;
  float qv[DC], dov[DC], dqa[DC];
  load_row<DP, TPK>(qv, q + b * sq.b + h * sq.h + qr * sq.n, active, D,
                       part);
  load_row<DP, TPK>(dov, dout + b * sdo.b + h * sdo.h + qr * sdo.n,
                       active, D, part);
#pragma unroll
  for (int c = 0; c < DC; ++c) dqa[c] = 0.0f;
  // an inactive row has q = dO = 0, lse2 = Δ = 0: P = 1, dS = 0
  const float lse2 = active ? lse[(long long)bh * N + row] * kLog2e : 0.0f;
  const float dl = active ? delta[(long long)bh * N + row] : 0.0f;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  for (int k0 = 0; k0 < N; k0 += kBwdTile) {
    const int nk = min(kBwdTile, N - k0);
    __syncthreads();
    load_tile<DP>(s_k, kb + (long long)k0 * sk.n, sk.n, nk, D);
    load_tile<DP>(s_v, vb + (long long)k0 * sv.n, sv.n, nk, D);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float4* k4 = reinterpret_cast<const float4*>(s_k + j * DP);
      const float4* v4 = reinterpret_cast<const float4*>(s_v + j * DP);
      float s, dp;
      dots<DP, TPK>(k4, v4, qv, dov, part, s, dp);
      const float p = exp2f(fmaf(s, scale_log2, -lse2));
      const float ds = (dp - dl) * p * scale;
      axpy<DP, TPK>(dqa, ds, k4, part);
    }
  }
  if (active)
    store_row<DP, TPK>(dq + b * sdq.b + h * sdq.h + qr * sdq.n, dqa, D,
                          part);
}

template <int DP, int TPK>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int H, int N, int D,
                       const Strides* s, float scale, cudaStream_t stream) {
  constexpr int rows = BwdCfg<DP, TPK>::kRows;
  dim3 grid((unsigned)((N + rows - 1) / rows), (unsigned)(B * H));
  attention_bwd_dkv_kernel<DP, TPK><<<grid, kBwdThreads, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, H, N, D, s[0], s[1], s[2], s[3], s[4], s[5], scale,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int DP, int TPK>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int H, int N, int D, const Strides* s,
                      float scale, cudaStream_t stream) {
  constexpr int rows = BwdCfg<DP, TPK>::kRows;
  dim3 grid((unsigned)((N + rows - 1) / rows), (unsigned)(B * H));
  attention_bwd_dq_kernel<DP, TPK><<<grid, kBwdThreads, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dq, H, N, D, s[0], s[1], s[2], s[3], s[4], scale, scale * kLog2e);
  return cudaGetLastError();
}

// ------------------------------------------- bf16 on the tensor cores ---
//
// The same two kernels with the products on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate): a block is 4 warps, a warp 16 rows (16
// keys in #12, 16 queries in #13). Tiles are bf16 in shared memory, rows
// padded by 8 elements so that the fragment loads of a warp fall in distinct
// banks, copied in 16-byte chunks (D % 8 == 0, 16-byte aligned rows, as the
// forward kernel takes them). The score products (S, dP) read both operands
// from shared memory; P and dS go from the f32 accumulators to bf16 A
// fragments in registers (the C layout of two n8 tiles is the A layout of
// one k16 step) for dV, dK and dQ, whose B operands are read across rows of
// the Q/dO or K tiles.

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // keys (#12) or queries (#13)
constexpr int kMmaTile = 32;             // queries (#12) or keys (#13)

template <int DP>
struct MmaCfg {
  static constexpr int RS = DP + 8;  // a shared row, elements
  // #12: K, V (kMmaRows rows), Q, dO (kMmaTile rows), lse2, Δ; #13: Q, dO
  // (kMmaRows), K, V (kMmaTile)
  static constexpr int kSmem =
      2 * (kMmaRows + kMmaTile) * RS * 2 + 2 * kMmaTile * 4;
  static_assert(DP % 16 == 0 && DP <= 128, "padded head dim");
};

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of one column, rows r and r + 1 (r at p, the next RS further)
template <int RS>
__device__ __forceinline__ uint32_t ld_col2(const __nv_bfloat16* p) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
  return (uint32_t)u[0] | ((uint32_t)u[RS] << 16);
}

// `rows` rows of D bf16 (row r at src + r·sn) into a shared tile of row
// stride RS, zero past nvalid rows and past D, in 16-byte chunks
template <int DP>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long sn, int rows,
                                               int nvalid, int D) {
  constexpr int CH = DP / 8, RS = MmaCfg<DP>::RS;
  for (int i = threadIdx.x; i < rows * CH; i += 32 * kMmaWarps) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid && c < D)
      v = *reinterpret_cast<const uint4*>(src + r * sn + c);
    *reinterpret_cast<uint4*>(dst + r * RS + c) = v;
  }
}

// A fragment (16 rows from `row0`, k-step kk) of a shared tile
template <int RS>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int row0,
                                       int kk, int g, int t) {
  const __nv_bfloat16* p = tile + (row0 + g) * RS + 16 * kk + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * RS);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * RS + 8);
}

// S = A·Bᵀ of 16 rows of `a_tile` against the kMmaTile rows of `b_tile`
// (both K-major over the head dim): (kMmaTile / 8) n-tiles
template <int DP>
__device__ __forceinline__ void score_tile(float (&acc)[kMmaTile / 8][4],
                                           const __nv_bfloat16* a_tile,
                                           int row0,
                                           const __nv_bfloat16* b_tile, int g,
                                           int t) {
  constexpr int RS = MmaCfg<DP>::RS;
#pragma unroll
  for (int j = 0; j < kMmaTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    frag_a<RS>(a, a_tile, row0, kk, g, t);
#pragma unroll
    for (int j = 0; j < kMmaTile / 8; ++j) {
      const __nv_bfloat16* p = b_tile + (8 * j + g) * RS + 16 * kk + 2 * t;
      mma16816(acc[j], a, ld32(p), ld32(p + 8));
    }
  }
}

// acc (16 rows × DP) += A·X, A the bf16 fragments of a 16 × kMmaTile score
// tile, X the kMmaTile × DP shared tile read across its rows
template <int DP>
__device__ __forceinline__ void acc_tile(float (&acc)[DP / 8][4],
                                         const uint32_t (&a)[kMmaTile / 16][4],
                                         const __nv_bfloat16* x, int g,
                                         int t) {
  constexpr int RS = MmaCfg<DP>::RS;
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int kq = 0; kq < kMmaTile / 16; ++kq) {
      const __nv_bfloat16* p = x + (16 * kq + 2 * t) * RS + 8 * dn + g;
      mma16816(acc[dn], a[kq], ld_col2<RS>(p), ld_col2<RS>(p + 8 * RS));
    }
}

// the bf16 A fragments of a 16 × kMmaTile f32 accumulator tile
__device__ __forceinline__ void to_frags(uint32_t (&a)[kMmaTile / 16][4],
                                         const float (&c)[kMmaTile / 8][4]) {
#pragma unroll
  for (int kq = 0; kq < kMmaTile / 16; ++kq) {
    a[kq][0] = pack_bf16(c[2 * kq][0], c[2 * kq][1]);
    a[kq][1] = pack_bf16(c[2 * kq][2], c[2 * kq][3]);
    a[kq][2] = pack_bf16(c[2 * kq + 1][0], c[2 * kq + 1][1]);
    a[kq][3] = pack_bf16(c[2 * kq + 1][2], c[2 * kq + 1][3]);
  }
}

// rows row0 + g (+ 8) of a 16 × DP accumulator tile to global (row stride
// sn), columns < D, rows < N
template <int DP>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, long long sn,
                                           const float (&acc)[DP / 8][4],
                                           int row0, int N, int D, int g,
                                           int t) {
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g + 8 * (e >> 1), c = 8 * dn + 2 * t + (e & 1);
      if (r < N && c < D) dst[r * sn + c] = __float2bfloat16_rn(acc[dn][e]);
    }
}

// #12 on the tensor cores: dK, dV of kMmaRows keys; the queries stream
// through shared memory in tiles of kMmaTile. A warp's accumulators hold
// Sᵀ and dPᵀ (its 16 keys × the tile's queries), then dV and dK.
template <int DP>
__global__ void __launch_bounds__(32 * kMmaWarps)
attention_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int H, int N,
                             int D, Strides sq, Strides sk, Strides sv,
                             Strides sdo, Strides sdk, Strides sdv,
                             float scale, float scale_log2) {
  constexpr int RS = MmaCfg<DP>::RS;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_v = s_k + kMmaRows * RS;
  __nv_bfloat16* s_q = s_v + kMmaRows * RS;
  __nv_bfloat16* s_do = s_q + kMmaTile * RS;
  float* s_lse2 = reinterpret_cast<float*>(s_do + kMmaTile * RS);
  float* s_delta = s_lse2 + kMmaTile;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, row0 = 16 * warp;
  const int k0 = blockIdx.x * kMmaRows;
  load_tile_bf16<DP>(s_k, k + b * sk.b + h * sk.h + (long long)k0 * sk.n,
                     sk.n, kMmaRows, N - k0, D);
  load_tile_bf16<DP>(s_v, v + b * sv.b + h * sv.h + (long long)k0 * sv.n,
                     sv.n, kMmaRows, N - k0, D);
  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = dva[dn][e] = 0.0f;

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lb = lse + (long long)bh * N;
  const float* db = delta + (long long)bh * N;
  for (int q0 = 0; q0 < N; q0 += kMmaTile) {
    const int nq = min(kMmaTile, N - q0);
    __syncthreads();
    load_tile_bf16<DP>(s_q, qb + (long long)q0 * sq.n, sq.n, kMmaTile, nq,
                       D);
    load_tile_bf16<DP>(s_do, dob + (long long)q0 * sdo.n, sdo.n, kMmaTile,
                       nq, D);
    if (threadIdx.x < kMmaTile) {
      const bool ok = threadIdx.x < nq;
      // a query past N: P = exp2(-inf) = 0, dS = 0
      s_lse2[threadIdx.x] = ok ? lb[q0 + threadIdx.x] * kLog2e : INFINITY;
      s_delta[threadIdx.x] = ok ? db[q0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();
    float st[kMmaTile / 8][4], dpt[kMmaTile / 8][4];
    score_tile<DP>(st, s_k, row0, s_q, g, t);
    score_tile<DP>(dpt, s_v, row0, s_do, g, t);
#pragma unroll
    for (int j = 0; j < kMmaTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);  // query in the tile
        const float p = exp2f(fmaf(st[j][e], scale_log2, -s_lse2[col]));
        dpt[j][e] = (dpt[j][e] - s_delta[col]) * p * scale;
        st[j][e] = p;
      }
    uint32_t pa[kMmaTile / 16][4], dsa[kMmaTile / 16][4];
    to_frags(pa, st);
    to_frags(dsa, dpt);
    acc_tile<DP>(dva, pa, s_do, g, t);
    acc_tile<DP>(dka, dsa, s_q, g, t);
  }
  store_tile<DP>(dk + b * sdk.b + h * sdk.h + (long long)k0 * sdk.n, sdk.n,
                 dka, row0, N - k0, D, g, t);
  store_tile<DP>(dv + b * sdv.b + h * sdv.h + (long long)k0 * sdv.n, sdv.n,
                 dva, row0, N - k0, D, g, t);
}

// #13 on the tensor cores: dQ of kMmaRows queries; the keys stream through
// shared memory in tiles of kMmaTile.
template <int DP>
__global__ void __launch_bounds__(32 * kMmaWarps)
attention_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int H, int N,
                            int D, Strides sq, Strides sk, Strides sv,
                            Strides sdo, Strides sdq, float scale,
                            float scale_log2) {
  constexpr int RS = MmaCfg<DP>::RS;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_do = s_q + kMmaRows * RS;
  __nv_bfloat16* s_k = s_do + kMmaRows * RS;
  __nv_bfloat16* s_v = s_k + kMmaTile * RS;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, row0 = 16 * warp;
  const int q0 = blockIdx.x * kMmaRows;
  load_tile_bf16<DP>(s_q, q + b * sq.b + h * sq.h + (long long)q0 * sq.n,
                     sq.n, kMmaRows, N - q0, D);
  load_tile_bf16<DP>(s_do,
                     dout + b * sdo.b + h * sdo.h + (long long)q0 * sdo.n,
                     sdo.n, kMmaRows, N - q0, D);
  // this thread's two rows (g, g + 8 of the warp's 16); a row past N has
  // q = dO = 0 and lse2 = Δ = 0: P = 1, dS = 0, and is not stored
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + row0 + g + 8 * i;
    lse2[i] = r < N ? lse[(long long)bh * N + r] * kLog2e : 0.0f;
    dl[i] = r < N ? delta[(long long)bh * N + r] : 0.0f;
  }
  float dqa[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dn][e] = 0.0f;

  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  for (int k0 = 0; k0 < N; k0 += kMmaTile) {
    const int nk = min(kMmaTile, N - k0);
    __syncthreads();
    load_tile_bf16<DP>(s_k, kb + (long long)k0 * sk.n, sk.n, kMmaTile, nk,
                       D);
    load_tile_bf16<DP>(s_v, vb + (long long)k0 * sv.n, sv.n, kMmaTile, nk,
                       D);
    __syncthreads();
    float s[kMmaTile / 8][4], dp[kMmaTile / 8][4];
    score_tile<DP>(s, s_q, row0, s_k, g, t);
    score_tile<DP>(dp, s_do, row0, s_v, g, t);
#pragma unroll
    for (int j = 0; j < kMmaTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = 8 * j + 2 * t + (e & 1);  // key in tile
        const float p =
            col < nk ? exp2f(fmaf(s[j][e], scale_log2, -lse2[i])) : 0.0f;
        dp[j][e] = (dp[j][e] - dl[i]) * p * scale;
      }
    uint32_t dsa[kMmaTile / 16][4];
    to_frags(dsa, dp);
    acc_tile<DP>(dqa, dsa, s_k, g, t);
  }
  store_tile<DP>(dq + b * sdq.b + h * sdq.h + (long long)q0 * sdq.n, sdq.n,
                 dqa, row0, N - q0, D, g, t);
}

// the dynamic shared memory of an instance, opened once (a static's
// initialiser runs once)
template <typename Kernel>
cudaError_t open_smem(Kernel kernel, int bytes) {
  return bytes <= 48 * 1024
             ? cudaSuccess
             : cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   bytes);
}

template <int DP>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv, int B,
                           int H, int N, int D, const Strides* s, float scale,
                           cudaStream_t stream) {
  constexpr int smem = MmaCfg<DP>::kSmem;
  static const cudaError_t attr =
      open_smem(attention_bwd_dkv_mma_kernel<DP>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((unsigned)((N + kMmaRows - 1) / kMmaRows), (unsigned)(B * H));
  attention_bwd_dkv_mma_kernel<DP><<<grid, 32 * kMmaWarps, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, lse, delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, N, D, s[0], s[1], s[2], s[3],
      s[4], s[5], scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, int B, int H, int N,
                          int D, const Strides* s, float scale,
                          cudaStream_t stream) {
  constexpr int smem = MmaCfg<DP>::kSmem;
  static const cudaError_t attr =
      open_smem(attention_bwd_dq_mma_kernel<DP>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((unsigned)((N + kMmaRows - 1) / kMmaRows), (unsigned)(B * H));
  attention_bwd_dq_mma_kernel<DP><<<grid, 32 * kMmaWarps, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, lse, delta,
      (__nv_bfloat16*)dq, H, N, D, s[0], s[1], s[2], s[3], s[4], scale,
      scale * kLog2e);
  return cudaGetLastError();
}

// ------------------------------------------- bf16 on wgmma (#12, #13) ---
//
// One kernel template for both: a block holds kWgRows rows in each of its
// two consumer warpgroups (the "resident" rows: keys in #12, queries in
// #13) and a producer warp streams the other side (queries with their lse
// and Δ in #12, keys in #13) through a ring of shared-memory stages. With
// A1, A2 the resident operands and B1, B2 the streamed ones:
//   #12: A1 = K, A2 = V, B1 = Q, B2 = dO; Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ,
//        dV += Pᵀ·dO, dK += dSᵀ·Q (lse and Δ by column);
//   #13: A1 = Q, A2 = dO, B1 = K, B2 = V; S = Q·Kᵀ, dP = dO·Vᵀ,
//        dQ += dS·K (lse and Δ by row).
// Design:
// * the producer warp copies each tile with cp.async (16 B a thread, zero
//   past N and D, so the strided projections need no tensor map), in
//   wgmma's swizzled layout (wgmma.cuh), and signals the stage's `full`
//   mbarrier as the copies land; the consumers free it through `empty`;
// * the score products are wgmma m64nTk16 over the padded head dim, A1 and
//   A2 from registers (#13 at DP = 48) or from shared memory (SS, the
//   others), B1 and B2 K-major from the stage;
// * P and dS are computed in f32 from the accumulators, rounded to bf16
//   and fed to the gradient products as register A fragments (the
//   accumulator layout is the A layout), with B1 and B2 read MN-major by
//   wgmma's transpose: no column-wise shared loads;
// * each warpgroup issues tile j's score products with tile j − 1's
//   gradient products and computes P_j and dS_j while the latter are in
//   flight; the two warpgroups take turns to issue (named barriers), so
//   that one's exponentials overlap the other's products.
// Registers decide the tile sizes: with 9 warps per block (3 on one of the
// SM's 4 register-file partitions) ptxas gives a thread at most 168, and a
// producer warpgroup's setmaxnreg did not raise that. Beyond it ptxas
// serialises the wgmma (C7512): #12 at 64-query tiles held 144 registers
// in flight (S, dP, P, dS, dV, dK) and ran serialised, so its tiles are 48
// queries; #13 takes 64 keys. A design without the producer warp (8 warps,
// 255 registers, 64- and 128-row tiles) ran slower.
// The bounds above hold for both; what the kernels reach is in PERF.md.

constexpr int kWgRows = 64;   // resident rows a consumer warpgroup
constexpr int kWgCons = 2;    // consumer warpgroups
constexpr int kWgProducers = 32;  // one producer warp
constexpr int kWgThreads = kWgCons * 128 + kWgProducers;
template <int DP, bool DKV>
struct WgCfg {
  // streamed rows a tile: #12's two accumulators leave room for 48 (at 64,
  // the registers its wgmma hold in flight outgrow 168 and ptxas serialises
  // them, C7512)
  static constexpr int T = DKV ? 48 : 64;
  static constexpr int kStages = 4;
  static constexpr int kTile = T * DP * 2;        // one streamed tile, bytes
  static constexpr int kVec = DKV ? 2 * T * 4 : 0;  // lse, Δ of a tile
  // a stage: B1, B2, then (#12) lse and Δ; stages on 1024-byte boundaries
  static constexpr int kStage = (2 * kTile + kVec + 1023) / 1024 * 1024;
  static constexpr int kBarBytes = 1024;          // full[], empty[]
  // where A1 and A2 live: #13 at DP = 48 holds Q and dO as A fragments in
  // registers (RS); the others read them from shared memory (SS, each
  // warpgroup's two tiles after the ring), whose fragments would not fit
  // within 168 registers beside their accumulators
  static constexpr bool kSS = DKV || DP == 64;
  static constexpr int kRes = kSS ? kWgRows * DP * 2 : 0;  // one A tile
  static constexpr int kResOff = kBarBytes + kStages * kStage;
  // + 1024: the kernel rounds the base of shared memory up to 1024 bytes
  static constexpr int kSmem = kResOff + kWgCons * 2 * kRes + 1024;
  // a tile starts on a whole number of swizzle atoms (8 rows of W bytes)
  static_assert(kTile % (8 * Swz<DP>::W) == 0, "tile alignment");
  static_assert(2 * kStages * 8 <= kBarBytes, "barriers");
};

// The wgmma A fragments of rows [0, 64) × DP of a (row stride sn) tensor in
// global memory, zero past nvalid rows and past D: warp w holds rows 16w..,
// fragment element i at row g + 8(i & 1), column 16kk + 2t + 8(i >> 1).
template <int DP>
__device__ __forceinline__ void load_frags(uint32_t (&a)[DP / 16][4],
                                           const __nv_bfloat16* src,
                                           long long sn, int nvalid, int D,
                                           int warp, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * warp + g + 8 * (i & 1);
      const int c = 16 * kk + 2 * t + 8 * (i >> 1);
      a[kk][i] = r < nvalid && c < D ? ld32(src + r * sn + c) : 0u;
    }
}

// rows [0, 64) of a 64 × DP accumulator tile (this warpgroup's) to global
// (row stride sn) in bf16, rows < nvalid, columns < D
template <int DP>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst, long long sn,
                                          const float (&acc)[DP / 2],
                                          int nvalid, int D, int warp,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + lane / 4 + 8 * i;
    if (r >= nvalid) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = 8 * n + 2 * (lane % 4);
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + r * sn + c) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
    }
  }
}

template <int DP, bool DKV>
__global__ void __launch_bounds__(kWgThreads, 1)
attention_bwd_wgmma_kernel(const __nv_bfloat16* __restrict__ a1,
                           const __nv_bfloat16* __restrict__ a2,
                           const __nv_bfloat16* __restrict__ b1,
                           const __nv_bfloat16* __restrict__ b2,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ out0,
                           __nv_bfloat16* __restrict__ out1, int H, int N,
                           int D, Strides sa1, Strides sa2, Strides sb1,
                           Strides sb2, Strides so0, Strides so1, float scale,
                           float scale_log2) {
  using Cfg = WgCfg<DP, DKV>;
  constexpr int S = Cfg::kStages, T = Cfg::T, WG = kWgCons;
  extern __shared__ __align__(16) uint8_t smem[];  // based on 1024 below
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint8_t* gbase = smem + (base - smem_addr(smem));  // generic
  const uint32_t full0 = base, empty0 = base + 8 * S;
  const uint32_t ring = base + Cfg::kBarBytes;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nt = (N + T - 1) / T;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const float* lb = lse + (long long)bh * N;
  const float* db = delta + (long long)bh * N;
  auto stage = [&](int j) { return ring + (j % S) * Cfg::kStage; };

  if (threadIdx.x == 0) ring_init(full0, empty0, S, kWgProducers, WG * 128);
  __syncthreads();

  if (wg == WG) {
    // ---- producer warp: B1, B2 (and lse, Δ) tiles into the ring ----------
    // A thread copies the same kChunks 16-byte chunks of every tile (chunk
    // t + 32k in load_rows' order): their offsets are computed once.
    constexpr int CW = Swz<DP>::CW, kChunks = T * (DP / 8) / kWgProducers;
    uint32_t soff[kChunks];
    int row[kChunks];
    bool col_ok[kChunks];
    long long g1[kChunks], g2[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int i = t + kWgProducers * k;
      const int r = (i / CW) % T, c = ((i / (CW * T)) * CW + i % CW) * 8;
      soff[k] = swz<DP>(i);
      row[k] = r;
      col_ok[k] = c < D;
      g1[k] = r * sb1.n + c;
      g2[k] = r * sb2.n + c;
    }
    const __nv_bfloat16* p1 = b1 + b * sb1.b + h * sb1.h;
    const __nv_bfloat16* p2 = b2 + b * sb2.b + h * sb2.h;
    for (int j = 0; j < nt; ++j) {
      mbar_wait(empty0 + 8 * (j % S), ((j / S) & 1) ^ 1);
      const uint32_t st = stage(j);
      const int nvalid = N - j * T;
      const __nv_bfloat16* s1 = p1 + (long long)j * T * sb1.n;
      const __nv_bfloat16* s2 = p2 + (long long)j * T * sb2.n;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        // rows past N and columns past D are zero-filled
        const bool ok = col_ok[k] && row[k] < nvalid;
        cp_async16(st + soff[k], ok ? s1 + g1[k] : s1, ok ? 16 : 0);
        cp_async16(st + Cfg::kTile + soff[k], ok ? s2 + g2[k] : s2,
                   ok ? 16 : 0);
      }
      if constexpr (DKV) {
        // lse, then Δ, of the tile's queries; zero past N, where Q and dO
        // are zero rows: P = 1 and dS = 0 there add nothing to dV and dK
#pragma unroll
        for (int i = t; i < 2 * T; i += kWgProducers) {
          const int qi = j * T + i % T;
          const bool ok = qi < N;
          cp_async4(st + 2 * Cfg::kTile + 4 * i,
                    (i < T ? lb : db) + (ok ? qi : 0), ok ? 4 : 0);
        }
      }
      cp_async_arrive(full0 + 8 * (j % S));
    }
    cp_async_wait_all();
  } else {
    // ---- consumers: kWgRows resident rows each ----------------------------
    const int warp = t / 32, lane = t % 32;
    const int rw = blockIdx.x * (WG * kWgRows) + wg * kWgRows;  // first row
    // A1 and A2 for the whole walk: #12 in shared memory (this warpgroup's
    // two tiles), #13 as wgmma A fragments in registers
    constexpr bool kSS = Cfg::kSS;
    const __nv_bfloat16* r1 = a1 + b * sa1.b + h * sa1.h + (long long)rw * sa1.n;
    const __nv_bfloat16* r2 = a2 + b * sa2.b + h * sa2.h + (long long)rw * sa2.n;
    const uint32_t res = base + Cfg::kResOff + wg * 2 * Cfg::kRes;
    uint32_t f1[kSS ? 1 : DP / 16][4], f2[kSS ? 1 : DP / 16][4];
    if constexpr (kSS) {
      load_rows<DP>(res, r1, sa1.n, kWgRows, N - rw, D, t, 128);
      load_rows<DP>(res + Cfg::kRes, r2, sa2.n, kWgRows, N - rw, D, t, 128);
      cp_async_wait_all();
      fence_proxy_async_smem();
      warpgroup_sync(3 + wg);
    } else {
      load_frags<DP>(f1, r1, sa1.n, N - rw, D, warp, lane);
      load_frags<DP>(f2, r2, sa2.n, N - rw, D, warp, lane);
    }
    // #13: this thread's two rows' lse·log2e and Δ·s (a row past N has
    // zero Q and dO and both 0: P = 1, dS = 0, and is not stored)
    float rl2[2] = {0.0f, 0.0f}, rd[2] = {0.0f, 0.0f};
    if constexpr (!DKV) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rw + 16 * warp + lane / 4 + 8 * i;
        if (r < N) {
          rl2[i] = lb[r] * kLog2e;
          rd[i] = db[r] * scale;
        }
      }
    }
    float acc0[DP / 2], acc1[DKV ? DP / 2 : 1];  // dV, dK (#12) or dQ (#13)
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc0[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < (DKV ? DP / 2 : 1); ++i) acc1[i] = 0.0f;
    float sx[T / 2], sy[T / 2];          // S and dP, then P and dS, f32
    uint32_t fx[T / 16][4], fy[T / 16][4];  // P (#12) and dS, bf16 A frags

    auto fence_all = [&]() {
      if constexpr (!kSS) {
        fence_regs(f1);
        fence_regs(f2);
      }
      fence_regs(sx);
      fence_regs(sy);
      fence_regs(fy);
      fence_regs(acc0);
      if constexpr (DKV) {
        fence_regs(fx);
        fence_regs(acc1);
      }
    };
    // waits for tile j and for this warpgroup's turn to issue
    auto acquire = [&](int j) {
      mbar_wait(full0 + 8 * (j % S), (j / S) & 1);
      fence_proxy_async_smem();
      named_sync(1 + wg);
      fence_all();
      wgmma_fence();
    };
    // the next warpgroup's turn; the last one skips its last, which
    // warpgroup 0 would never take
    auto release_turn = [&](int j) {
      if (wg + 1 < WG || j + 1 < nt) named_arrive(1 + (wg + 1) % WG);
    };
    auto issue_scores = [&](int j) {
      if constexpr (kSS) {
        wgmma_ss<DP, T>(sx, res, stage(j));
        wgmma_ss<DP, T>(sy, res + Cfg::kRes, stage(j) + Cfg::kTile);
      } else {
        wgmma_scores<DP, T>(sx, f1, stage(j));
        wgmma_scores<DP, T>(sy, f2, stage(j) + Cfg::kTile);
      }
      wgmma_commit();
    };
    auto issue_grads = [&](int j) {
      const uint32_t st = stage(j);
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) {
        if constexpr (DKV) {
          wgmma_rs<DP>(acc0, fx[kk], st + Cfg::kTile, T, kk);  // dV += Pᵀ·dO
          wgmma_rs<DP>(acc1, fy[kk], st, T, kk);               // dK += dSᵀ·Q
        } else {
          wgmma_rs<DP>(acc0, fy[kk], st, T, kk);               // dQ += dS·K
        }
      }
      wgmma_commit();
    };
    // S, dP of tile j -> P, dS (f32, in place): P = exp2(S·s·log2e −
    // lse·log2e), dS = (dP·s − Δ·s)·P, where the plain version computes
    // (dP − Δ)·P·s (the two differ in the last bits of dS before its bf16
    // rounding)
    auto grads_of = [&](int j) {
      fence_regs(sx);
      fence_regs(sy);
      if constexpr (DKV) {
        // column c of the tile is query j·T + c: its lse and Δ from the stage
        const float* sl = reinterpret_cast<const float*>(
            gbase + (stage(j) - base) + 2 * Cfg::kTile);
#pragma unroll
        for (int n = 0; n < T / 8; ++n) {
          const int c = 8 * n + 2 * (lane % 4);
          const float2 l = *reinterpret_cast<const float2*>(sl + c);
          const float2 dl = *reinterpret_cast<const float2*>(sl + T + c);
          const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
          const float d2[2] = {dl.x * scale, dl.y * scale};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(sx[4 * n + e], scale_log2, -l2[e & 1]));
            sy[4 * n + e] = fmaf(sy[4 * n + e], scale, -d2[e & 1]) * p;
            sx[4 * n + e] = p;
          }
        }
      } else {
        // keys past N (zero rows of K and V) get P = 0
        const int valid = N - j * T;
        if (valid < T) {
#pragma unroll
          for (int n = 0; n < T / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (8 * n + 2 * (lane % 4) + (e & 1) >= valid)
                sx[4 * n + e] = -INFINITY;
        }
#pragma unroll
        for (int e = 0; e < T / 2; ++e) {
          const int i = (e / 2) % 2;  // row of accumulator element e
          const float p = ex2(fmaf(sx[e], scale_log2, -rl2[i]));
          sy[e] = fmaf(sy[e], scale, -rd[i]) * p;
        }
      }
    };
    auto pack = [&]() {
      if constexpr (DKV) pack_frags(fx, sx);
      pack_frags(fy, sy);
    };

    // Iteration j issues tile j's two score products and tile j − 1's
    // gradient products together, computes P_j and dS_j while the second
    // group is in flight, then packs them. The warpgroups take turns to
    // issue (named barrier 1 + wg, warpgroup 0 first), so that one's
    // exponentials overlap the other's products. The first iteration is
    // peeled: every wgmma group is then committed unconditionally, which
    // ptxas needs to keep the products asynchronous (else it serialises
    // them, C7514).
    if (wg == WG - 1) named_arrive(1);
    acquire(0);
    issue_scores(0);
    release_turn(0);
    wgmma_wait<0>();
    grads_of(0);
    pack();
    for (int j = 1; j < nt; ++j) {
      acquire(j);
      issue_scores(j);
      issue_grads(j - 1);
      release_turn(j);
      wgmma_wait<1>();  // S_j and dP_j have landed
      grads_of(j);
      wgmma_wait<0>();  // tile j − 1's gradient products have landed
      fence_all();
      mbar_arrive(empty0 + 8 * ((j - 1) % S));
      pack();
    }
    fence_all();
    wgmma_fence();
    issue_grads(nt - 1);
    wgmma_wait<0>();
    fence_all();

    store_acc<DP>(out0 + b * so0.b + h * so0.h + (long long)rw * so0.n, so0.n,
                  acc0, N - rw, D, warp, lane);
    if constexpr (DKV)
      store_acc<DP>(out1 + b * so1.b + h * so1.h + (long long)rw * so1.n,
                    so1.n, acc1, N - rw, D, warp, lane);
  }
}

template <int DP, bool DKV>
cudaError_t launch_wgmma(const void* a1, const void* a2, const void* b1,
                         const void* b2, const float* lse,
                         const float* delta, void* out0, void* out1, int B,
                         int H, int N, int D, Strides sa1, Strides sa2,
                         Strides sb1, Strides sb2, Strides so0, Strides so1,
                         float scale, cudaStream_t stream) {
  constexpr int smem = WgCfg<DP, DKV>::kSmem;
  static const cudaError_t attr =
      open_smem(attention_bwd_wgmma_kernel<DP, DKV>, smem);
  if (attr != cudaSuccess) return attr;
  constexpr int rows = kWgCons * kWgRows;
  dim3 grid((unsigned)((N + rows - 1) / rows), (unsigned)(B * H));
  attention_bwd_wgmma_kernel<DP, DKV><<<grid, kWgThreads, smem, stream>>>(
      (const __nv_bfloat16*)a1, (const __nv_bfloat16*)a2,
      (const __nv_bfloat16*)b1, (const __nv_bfloat16*)b2, lse, delta,
      (__nv_bfloat16*)out0, (__nv_bfloat16*)out1, H, N, D, sa1, sa2, sb1, sb2,
      so0, so1, scale, scale * kLog2e);
  return cudaGetLastError();
}

// #12 and #13 in bf16 (s: the strides of q, k, v, dout, then the
// gradients): wgmma at padded head dims 48 and 64; at 128 the mma.sync
// kernels, whose two 64 × 128 accumulators would not fit beside the score
// tiles in a warpgroup's registers
template <int DP>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int B,
                            int H, int N, int D, const Strides* s,
                            float scale, cudaStream_t stream) {
  if constexpr (DP == 128)
    return launch_dkv_mma<128>(q, k, v, dout, lse, delta, dk, dv, B, H, N, D,
                               s, scale, stream);
  else
    return launch_wgmma<DP, true>(k, v, q, dout, lse, delta, dv, dk, B, H, N,
                                  D, s[1], s[2], s[0], s[3], s[5], s[4],
                                  scale, stream);
}

template <int DP>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, int B, int H, int N,
                           int D, const Strides* s, float scale,
                           cudaStream_t stream) {
  if constexpr (DP == 128)
    return launch_dq_mma<128>(q, k, v, dout, lse, delta, dq, B, H, N, D, s,
                              scale, stream);
  else
    return launch_wgmma<DP, false>(q, dout, k, v, lse, delta, dq, nullptr, B,
                                   H, N, D, s[0], s[3], s[1], s[2], s[4],
                                   s[4], scale, stream);
}

// 16-byte copies of bf16 rows: 16-byte aligned base, strides of multiples
// of 8 elements, D % 8 == 0
bool aligned16(const void* p, const Strides& s) {
  return ((uintptr_t)p & 15) == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.n % 8 == 0;
}

#define TPUNERF_ATTN_BWD_MMA(LAUNCH, ...)                   \
  if (D <= 48) return (int)LAUNCH<48>(__VA_ARGS__);        \
  if (D <= 64) return (int)LAUNCH<64>(__VA_ARGS__);        \
  return (int)LAUNCH<128>(__VA_ARGS__);

// one instance per padded head dim: 20, 16 and 16 columns a thread
#define TPUNERF_ATTN_BWD_DISPATCH(LAUNCH, ...)         \
  if (D <= 40) return (int)LAUNCH<40, 2>(__VA_ARGS__); \
  if (D <= 64) return (int)LAUNCH<64, 4>(__VA_ARGS__); \
  return (int)LAUNCH<128, 8>(__VA_ARGS__);

// The entries' checks and dispatch. `mma`: bf16 on the mma.sync kernels at
// every head dim (the earlier design, kept for timing only).
int dkv_entry(int dtype, bool mma, const void* q, const void* k,
              const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, int B, int H, int N,
              int D, const long long* strides, float scale, void* stream) {
  if (N <= 0 || B * H <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > 128 || B * H > 65535) return (int)cudaErrorInvalidValue;
  Strides s[6];
  for (int i = 0; i < 6; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (dtype == 0 && !mma) {
    TPUNERF_ATTN_BWD_DISPATCH(launch_dkv, q, k, v, dout, l, dl, dk, dv, B, H,
                              N, D, s, scale, st)
  }
  if (dtype == 1) {
    const void* ptrs[6] = {q, k, v, dout, dk, dv};
    for (int i = 0; i < 6; ++i)
      if (!aligned16(ptrs[i], s[i])) return (int)cudaErrorInvalidValue;
    if (D % 8) return (int)cudaErrorInvalidValue;
    if (mma) {
      TPUNERF_ATTN_BWD_MMA(launch_dkv_mma, q, k, v, dout, l, dl, dk, dv, B, H,
                           N, D, s, scale, st)
    }
    TPUNERF_ATTN_BWD_MMA(launch_dkv_bf16, q, k, v, dout, l, dl, dk, dv, B, H,
                         N, D, s, scale, st)
  }
  return (int)cudaErrorInvalidValue;
}

int dq_entry(int dtype, bool mma, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta, void* dq,
             int B, int H, int N, int D, const long long* strides,
             float scale, void* stream) {
  if (N <= 0 || B * H <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > 128 || B * H > 65535) return (int)cudaErrorInvalidValue;
  Strides s[5];
  for (int i = 0; i < 5; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (dtype == 0 && !mma) {
    TPUNERF_ATTN_BWD_DISPATCH(launch_dq, q, k, v, dout, l, dl, dq, B, H, N,
                              D, s, scale, st)
  }
  if (dtype == 1) {
    const void* ptrs[5] = {q, k, v, dout, dq};
    for (int i = 0; i < 5; ++i)
      if (!aligned16(ptrs[i], s[i])) return (int)cudaErrorInvalidValue;
    if (D % 8) return (int)cudaErrorInvalidValue;
    if (mma) {
      TPUNERF_ATTN_BWD_MMA(launch_dq_mma, q, k, v, dout, l, dl, dq, B, H, N,
                           D, s, scale, st)
    }
    TPUNERF_ATTN_BWD_MMA(launch_dq_bf16, q, k, v, dout, l, dl, dq, B, H, N, D,
                         s, scale, st)
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16. q, k, v, dout (the output's gradient)
// and the gradients are (B, H, N, D) views with the given (batch, head,
// token) element strides (`strides`: 3 a tensor, in argument order) and a
// contiguous head dim, D <= 128. lse and delta are (B, H, N) f32
// contiguous: the forward's log-sum-exp and rowsum(dout * out). bf16 runs
// on the tensor cores and takes D % 8 == 0, 16-byte aligned tensors and
// strides that are multiples of 8; f32 runs on the CUDA cores.
int attention_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int H, int N, int D,
                      const long long* strides, float scale, void* stream) {
  return dkv_entry(dtype, false, q, k, v, dout, lse, delta, dk, dv, B, H, N,
                   D, strides, scale, stream);
}

int attention_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int N, int D,
                     const long long* strides, float scale, void* stream) {
  return dq_entry(dtype, false, q, k, v, dout, lse, delta, dq, B, H, N, D,
                  strides, scale, stream);
}

// The earlier bf16 design (mma.sync at every head dim), on the same
// arguments; bf16 only. No path calls it: it is timed beside the entries
// above.
int attention_bwd_dkv_mma(int dtype, const void* q, const void* k,
                          const void* v, const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int B, int H,
                          int N, int D, const long long* strides, float scale,
                          void* stream) {
  return dkv_entry(dtype, true, q, k, v, dout, lse, delta, dk, dv, B, H, N,
                   D, strides, scale, stream);
}

int attention_bwd_dq_mma(int dtype, const void* q, const void* k,
                         const void* v, const void* dout, const void* lse,
                         const void* delta, void* dq, int B, int H, int N,
                         int D, const long long* strides, float scale,
                         void* stream) {
  return dq_entry(dtype, true, q, k, v, dout, lse, delta, dq, B, H, N, D,
                  strides, scale, stream);
}

}  // extern "C"
