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

#include "wgmma.cuh"

namespace {

using namespace tpn;

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
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t full0 = base, empty0 = base + 8 * S;
  const uint32_t kv0 = base + Cfg::kKVOff;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  constexpr int WG = Cfg::kWG;
  const int q0 = blockIdx.x * Cfg::kBQ;
  const int nt = (N + kKT - 1) / kKT;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) ring_init(full0, empty0, S, kProducers, WG * 128);
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
    cp_async_wait_all();
  } else {
    // ---- consumers: 64 queries each -------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int warp = t / 32, lane = t % 32;
    const int qw = q0 + wg * kWQ;  // this warpgroup's first query
    const uint32_t qs = base + Cfg::kQOff + wg * Cfg::kQBytes;
    load_rows<DP>(qs, q + b * sq.b + h * sq.h + (long long)qw * sq.n, sq.n,
                  kWQ, N - qw, D, t, 128);
    cp_async_wait_all();
    fence_proxy_async_smem();
    warpgroup_sync(1 + wg);

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
      fence_proxy_async_smem();
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
      wgmma_ss<DP, kKT>(sc, qs, stage_kd(j));
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {
      const uint32_t vd = stage_kd(j) + Cfg::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk)
        wgmma_rs<DP>(acc, pa[kk], vd, kKT, kk);
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
    pack_frags(pa, sc);
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
      pack_frags(pa, sc);
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
