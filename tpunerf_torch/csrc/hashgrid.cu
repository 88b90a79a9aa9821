// Multiresolution hash-grid encode, forward and table gradient, for Hopper.
//
// Replaces the Pallas TPU kernels of tpunerf/kernels/hashgrid.py:
//   forward  _kernel_packed / _kernel, launched by _hash_encode_pallas
//            (#1, hashgrid_fwd_kernel);
//   backward _bwd_kernel, launched by _hash_bwd_pallas (custom VJP _bwd)
//            (#2, hashgrid_bwd_kernel + hashgrid_bwd_reduce_kernel);
//   the backward's cost-split experiment, the kernel of _make_kernel
//   launched by hash_bwd_variant in scripts/exp_hash_bwd.py (#11): since
//   its redesign hashgrid_bwd_split, which takes today's #2 apart on #2's
//   own grid (see hashgrid_bwd_split_kernel below); its first design, which
//   took the first #2 apart, stays as hashgrid_bwd_variant.
// The first, level-per-block forward stays as hashgrid_fwd_level_kernel (C
// symbol hashgrid_fwd_level), only to be timed beside #1; the first
// backward is #11's mode `full` at 8192 points per block.
//
// What bounds them on this card: at the default config (L=12, T=2^11,
// F=2) and N = 262,144 points per step, the forward reads x (3 MB) and
// writes (N, 24) f32 (25 MB): ~28 MB, ~8.5 us at 3.35 TB/s. The backward
// reads x and g (~28 MB) and writes the 192 KiB table gradient. Both are
// bounded by bytes; what held the first, level-per-block kernels far above that was, in the
// forward, one level per block (each output row written by L blocks in
// F-float pieces, x read L times, a level staged per 2048 points) and, in
// the backward, the shared-memory f32 atomicAdd, which Hopper runs as a
// compare-and-swap loop (ATOMS.CAST.SPIN; 92 % of that kernel's time, PERF.md).
//
// Design of both:
// * the table is cut into parts (kernels/hashgrid.py:table_parts): whole
//   levels, as many as fit shared memory (every level of the default
//   table in the forward, 6 of 12 in the backward), or, where one level
//   does not fit, slot ranges of it. blockIdx.y is the part; a persistent
//   grid of about one block per SM and part gives each block one
//   contiguous chunk of points (the host sizes it from
//   hashgrid_resident_blocks, asked once per kernel, config and card);
// * thread t of a block takes level t mod nl of every (blockDim / nl)-th
//   point of the chunk: level fastest, so a warp reads whole g rows and
//   writes whole output rows, and the lanes of a point share its x;
// * the hash is computed in uint32, as in the reference; the table stays
//   f32 (the TPU kernel's bf16 pair packing, 128-lane window sweeps and
//   one-hot matmul are TPU devices, not semantics).
// Forward: the part's table is staged once per block by cp.async.bulk
// (1-D bulk copies completed on an mbarrier; no tensor map), each corner
// is one 64-bit shared load at F = 2.
// Backward, fixed point on native integer shared atomics (ATOMS.ADD):
// * pass 1 reads the block's g and takes G = max |g| per level over its
//   finite entries; the level's exponent s is the largest with
//   2^s * G < 2^30 (at most 126);
// * pass 2 adds each update v = rint(w * g_f * 2^s) to the slot's 64-bit
//   sum, held as a uint32 low word, biased by 2^31, and an int32 high
//   word: the low word's atomicAdd returns its old value, so the carry out
//   of it is exact, and the high word gets (carry - [v < 0]) only where
//   that is not 0, which is rare (the bias keeps small running sums off
//   the wrap). A 64-bit shared atomicAdd would be a CAS loop
//   (ATOMS.CAST.SPIN.64). Splitting v into 16-bit halves on two words
//   needs no returned value but doubles the adds; it is not used here,
//   though it was the faster of the two at uniform x (PERF.md section 5
//   gives the readings and what is still unmeasured);
// * the sums are feature-major in shared memory, (F, nl, nj), so a warp's
//   adds of one feature spread over all 32 banks;
// * the block's exact sums hi * 2^32 + lo - 2^31 are converted back (one f32
//   rounding, then an exact * 2^-s) into its partial slice; a second
//   kernel adds the slices in block order, so the result does not depend
//   on the order of the atomics (it equals hash_bwd_fixed_point_plain of
//   kernels/hashgrid.py bit for bit).
// No overflow, by construction: the trilinear weights are <= 1, so
// |w * g_f| <= G and |v| <= 2^s * G + 1/2 < 2^30 fits int32. A slot takes
// at most 8 updates a point and a block at most kBwdMaxPoints = 8192
// points, so its sum stays within 8 * 8192 * 2^30 = 2^46 and the high
// word within 2^46 / 2^32 + 1 = 2^14 + 1, far inside int32. The rounding
// error is at most 2^-s / 2 < G * 2^-30 an update.
// Non-finite g (inf or NaN): pass 2 skips it, and, only in a block that
// saw one, a third pass adds each such update w * g_f to the block's
// converted slice by a global f32 atomic, so that exactly the slots it
// reaches become inf or NaN, as in the plain version's f32 sums.
//
// Every launch is on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <algorithm>

#include "mbarrier.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kMaxParts = 64;
constexpr int kThreads = 256;       // the level-per-block kernels, #11
constexpr int kFwdThreads = 1024;   // #1
constexpr int kBwdThreads = 1024;   // #2
constexpr int kFwdPointsPerThread = 8;
constexpr int kBwdMaxPoints = 8192;  // #2: the bound on its sums (above)
constexpr int kSmemOptIn = 227 * 1024;   // shared memory a block, Hopper
constexpr uint32_t kLoBias = 0x80000000u;
constexpr uint32_t kBulkBytes = 32768;   // per cp.async.bulk
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;

struct Levels {
  int res[kMaxLevels];
  int dense[kMaxLevels];
};

// A part of the table: levels [l0, l0 + nl), slots [j0, j0 + nj) of each.
struct Parts {
  int l0[kMaxParts];
  int nl[kMaxParts];
  int j0[kMaxParts];
  int nj[kMaxParts];
};

// Corner `c` of the cell around xl: table slot and trilinear weight.
struct Cell {
  int x0[3];
  float w[3];
};

__device__ __forceinline__ Cell make_cell(const float* __restrict__ x,
                                          long long p, float resf, int res) {
  Cell cell;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float xl = __fmul_rn(x[p * 3 + a], resf);
    const float f = floorf(xl);
    cell.w[a] = __fsub_rn(xl, f);
    int i = (int)f;
    i = i < 0 ? 0 : (i > res ? res : i);
    cell.x0[a] = i;
  }
  return cell;
}

__device__ __forceinline__ void corner(const Cell& cell, int c, int res,
                                       bool dense, uint32_t mask, int& idx,
                                       float& w) {
  const int dx = (c >> 2) & 1, dy = (c >> 1) & 1, dz = c & 1;
  const int ix = min(cell.x0[0] + dx, res);
  const int iy = min(cell.x0[1] + dy, res);
  const int iz = min(cell.x0[2] + dz, res);
  if (dense) {
    idx = (ix * (res + 1) + iy) * (res + 1) + iz;
  } else {
    const uint32_t h = (uint32_t)ix ^ ((uint32_t)iy * kPrime1) ^
                       ((uint32_t)iz * kPrime2);
    idx = (int)(h & mask);
  }
  const float wx = dx ? cell.w[0] : 1.0f - cell.w[0];
  const float wy = dy ? cell.w[1] : 1.0f - cell.w[1];
  const float wz = dz ? cell.w[2] : 1.0f - cell.w[2];
  w = __fmul_rn(__fmul_rn(wx, wy), wz);
}

// The level-per-block forward, kept under its own C symbol
// (hashgrid_fwd_level) so that chip_smoke.py can time it beside
// hashgrid_fwd_kernel; nothing in the package calls it. One thread per (point, level), the level in
// blockIdx.y, that level's T*F slice staged per block of 2048 points.
template <int F>
__global__ void __launch_bounds__(kThreads)
hashgrid_fwd_level_kernel(const float* __restrict__ x,
                          const float* __restrict__ table,
                          float* __restrict__ out, long long n, int L, int T,
                          Levels lv) {
  extern __shared__ float s_tab[];
  const int level = blockIdx.y;
  const float* tab = table + (size_t)level * T * F;
  for (int i = threadIdx.x; i < T * F; i += kThreads) s_tab[i] = tab[i];
  __syncthreads();

  const int res = lv.res[level];
  const bool dense = lv.dense[level] != 0;
  const float resf = (float)res;
  const uint32_t mask = (uint32_t)(T - 1);
  const long long base = (long long)blockIdx.x * kThreads * kFwdPointsPerThread;
  for (int k = 0; k < kFwdPointsPerThread; ++k) {
    const long long p = base + (long long)k * kThreads + threadIdx.x;
    if (p >= n) break;
    const Cell cell = make_cell(x, p, resf, res);
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int idx;
      float w;
      corner(cell, c, res, dense, mask, idx, w);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += w * s_tab[idx * F + f];
    }
    float* o = out + p * (long long)(L * F) + level * F;
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[f];
  }
}

// The F features of one slot: one 64-bit shared load at F = 2, 128-bit
// loads at F = 4 and 8.
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ s,
                                         float (&r)[F]) {
  if constexpr (F == 2) {
    const float2 t = *reinterpret_cast<const float2*>(s);
    r[0] = t.x;
    r[1] = t.y;
  } else if constexpr (F % 4 == 0) {
#pragma unroll
    for (int k = 0; k < F / 4; ++k) {
      const float4 t = reinterpret_cast<const float4*>(s)[k];
      r[4 * k] = t.x;
      r[4 * k + 1] = t.y;
      r[4 * k + 2] = t.z;
      r[4 * k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) r[f] = s[f];
  }
}

template <int F>
__device__ __forceinline__ void store_row(float* __restrict__ o,
                                          const float (&r)[F]) {
  if constexpr (F == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(r[0], r[1]);
  } else if constexpr (F % 4 == 0) {
#pragma unroll
    for (int k = 0; k < F / 4; ++k)
      reinterpret_cast<float4*>(o)[k] =
          make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = r[f];
  }
}

// Stages `bytes` of global memory at src into shared memory at dst: by
// cp.async.bulk copies completed on the mbarrier at `bar` where src and
// the size are 16-byte aligned (dst always is), else by plain loads. Ends
// with the data visible to every thread of the block.
__device__ void stage(float* dst, const float* __restrict__ src,
                      uint32_t bytes, uint64_t* bar) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0) {
    const uint32_t b = tpn::smem_addr(bar);
    if (threadIdx.x == 0) {
      tpn::mbar_init(b, 1);
      tpn::mbar_expect_tx(b, bytes);
      const uint32_t d = tpn::smem_addr(dst);
      for (uint32_t off = 0; off < bytes; off += kBulkBytes) {
        tpn::bulk_g2s(d + off, reinterpret_cast<const char*>(src) + off,
                      min(kBulkBytes, bytes - off), b);
      }
    }
    __syncthreads();   // the barrier is initialised before anyone waits
    tpn::mbar_wait(b, 0);
  } else {
    for (uint32_t i = threadIdx.x; i < bytes / 4; i += blockDim.x)
      dst[i] = src[i];
    __syncthreads();
  }
}

// Kernel #1. Block (bx, part) stages the part's levels whole and encodes
// points [bx * chunk, (bx + 1) * chunk). Thread t takes level t mod nl of
// every (blockDim / nl)-th point from t / nl on, so that a warp writes
// whole contiguous output rows (nl = L) and its lanes of one point share
// its x.
template <int F>
__global__ void __launch_bounds__(kFwdThreads, 1)
hashgrid_fwd_kernel(const float* __restrict__ x,
                    const float* __restrict__ table, float* __restrict__ out,
                    long long n, int L, int T, Levels lv, Parts parts,
                    long long chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_tab = reinterpret_cast<float*>(smem + 16);
  const int part = blockIdx.y;
  const int l0 = parts.l0[part], nl = parts.nl[part];
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = min(n, begin + chunk);
  if (begin >= end) return;   // uniform across the block
  stage(s_tab, table + (size_t)l0 * T * F,
        (uint32_t)((size_t)nl * T * F * sizeof(float)), bar);

  const int q = blockDim.x / nl;   // points per pass
  const int t = threadIdx.x;
  if (t >= q * nl) return;
  const int li = t % nl;
  const int level = l0 + li;
  const int res = lv.res[level];
  const bool dense = lv.dense[level] != 0;
  const float resf = (float)res;
  const uint32_t mask = (uint32_t)(T - 1);
  const float* tab = s_tab + (size_t)li * T * F;
  const long long row = (long long)L * F;
  for (long long p = begin + t / nl; p < end; p += q) {
    const Cell cell = make_cell(x, p, resf, res);
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int idx;
      float w;
      corner(cell, c, res, dense, mask, idx, w);
      float r[F];
      load_row<F>(tab + idx * F, r);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += w * r[f];
    }
    store_row<F>(out + p * row + level * F, acc);
  }
}

// 2^s as a float, for -126 <= s <= 127.
__device__ __forceinline__ float pow2(int s) {
  return __int_as_float((s + 127) << 23);
}

// The fixed-point exponent of a level in a block: the largest s <= 126
// with 2^s * G < 2^30, where G = max |g| (the bits of a finite float >= 0)
// over the block's points; 0 where G = 0. See the bound above.
__device__ __forceinline__ int fixed_exponent(int gmax_bits) {
  if (gmax_bits == 0) return 0;
  const int e = (gmax_bits >> 23) - 127;   // G < 2^(e + 1)
  return min(29 - e, 126);
}

// Pass 1 of #2 (and of the split's gmax): max |g| of `level` over the
// finite g of points begin + t / nl, + q, ... < end, as the bits of a
// non-negative float (inf and NaN at and above 0x7f800000); `odd` is set
// where a non-finite g was seen.
template <int F>
__device__ __forceinline__ int level_gmax(const float* __restrict__ g,
                                          long long begin, long long end,
                                          int q, int t, int nl, int level,
                                          long long row, bool& odd) {
  int m = 0;
#pragma unroll 4
  for (long long p = begin + t / nl; p < end; p += q) {
    float gf[F];
    load_row<F>(g + p * row + level * F, gf);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int b = __float_as_int(fabsf(gf[f]));
      odd |= b >= 0x7f800000;
      m = max(m, b < 0x7f800000 ? b : 0);
    }
  }
  return m;
}

// Pass 2 of #2 without its adds (and the split's addr): for the same
// points, every corner whose slot idx lies in [j0, j0 + nj) and every
// feature, the fixed-point update v = rint(w * g_f * scale), handed to
// add(f, j = idx - j0, idx, v); non-finite g count as 0 where zero_odd.
template <int F, typename Add>
__device__ __forceinline__ void level_updates(
    const float* __restrict__ x, const float* __restrict__ g, long long begin,
    long long end, int q, int t, int nl, int level, long long row, int T,
    const Levels& lv, int j0, int nj, float scale, bool zero_odd, Add add) {
  const int res = lv.res[level];
  const bool dense = lv.dense[level] != 0;
  const float resf = (float)res;
  const uint32_t mask = (uint32_t)(T - 1);
#pragma unroll 2
  for (long long p = begin + t / nl; p < end; p += q) {
    float gf[F];
    load_row<F>(g + p * row + level * F, gf);
    if (zero_odd) {
#pragma unroll
      for (int f = 0; f < F; ++f)
        if (!(fabsf(gf[f]) <= FLT_MAX)) gf[f] = 0.0f;
    }
    const Cell cell = make_cell(x, p, resf, res);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int idx;
      float w;
      corner(cell, c, res, dense, mask, idx, w);
      const uint32_t j = (uint32_t)(idx - j0);
      if (j >= (uint32_t)nj) continue;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        add(f, j, idx,
            __float2int_rn(__fmul_rn(__fmul_rn(w, gf[f]), scale)));
      }
    }
  }
}

// v onto the 64-bit sum held as a low word biased by 2^31 and a carry
// word, by native 32-bit shared atomics (see the header).
__device__ __forceinline__ void fixed_add(uint32_t* lo, int* hi, int v) {
  if (v == 0) return;
  const uint32_t u = (uint32_t)v;
  const uint32_t old = atomicAdd(lo, u);
  const int carry = (int)(old + u < old) - (v < 0);
  if (carry != 0) atomicAdd(hi, carry);
}

// The block's exact sums hi * 2^32 + lo - 2^31 of (F, nl, nj) values into
// its slice: one f32 rounding, then * 2^-s of the value's level.
__device__ __forceinline__ void flush_sums(float* __restrict__ dst,
                                           const uint32_t* s_lo,
                                           const int* s_hi,
                                           const int* s_gmax, int words,
                                           int nl, int nj) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const long long sum =
        (long long)s_hi[i] * 4294967296ll + s_lo[i] - (long long)kLoBias;
    dst[i] = __fmul_rn((float)sum,
                       pow2(-fixed_exponent(s_gmax[(i / nj) % nl])));
  }
}

// Kernel #2. Block (bx, part) accumulates the table gradient of the
// part's levels and slots over points [bx * chunk, (bx + 1) * chunk), with
// kernel #1's thread mapping, and writes its sums to its own slice of
// `partial` (stride floats, feature-major: (F, nl, nj));
// hashgrid_bwd_reduce_kernel adds the slices.
template <int F>
__global__ void __launch_bounds__(kBwdThreads, 1)
hashgrid_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ partial, long long n, int L, int T,
                    Levels lv, Parts parts, long long chunk, int stride) {
  extern __shared__ __align__(16) uint32_t s_words[];
  const int part = blockIdx.y;
  const int l0 = parts.l0[part], nl = parts.nl[part];
  const int j0 = parts.j0[part], nj = parts.nj[part];
  const int words = nl * nj * F;
  uint32_t* s_lo = s_words;
  int* s_hi = reinterpret_cast<int*>(s_words + words);
  int* s_gmax = s_hi + words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    s_lo[i] = kLoBias;
    s_hi[i] = 0;
  }
  if (threadIdx.x < nl) s_gmax[threadIdx.x] = 0;
  __syncthreads();

  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = min(n, begin + chunk);
  const int q = blockDim.x / nl;   // points per pass
  const int t = threadIdx.x;
  const bool active = t < q * nl;
  const int li = t % nl;
  const int level = l0 + li;
  const long long row = (long long)L * F;
  // pass 1: G = max |g| per level over the block's finite g
  bool odd = false;   // a non-finite g seen
  if (active) {
    atomicMax(&s_gmax[li],
              level_gmax<F>(g, begin, end, q, t, nl, level, row, odd));
  }
  const bool any_odd = __syncthreads_or(odd);
  const int fstride = nl * nj;
  // pass 2: the g tile again (from L2), the addresses, the integer adds
  if (active) {
    const float scale = pow2(fixed_exponent(s_gmax[li]));
    uint32_t* lo = s_lo + li * nj;
    int* hi = s_hi + li * nj;
    // pass 3 adds the non-finite g
    level_updates<F>(x, g, begin, end, q, t, nl, level, row, T, lv, j0, nj,
                     scale, any_odd, [&](int f, uint32_t j, int, int v) {
                       fixed_add(&lo[f * fstride + j], &hi[f * fstride + j],
                                 v);
                     });
  }
  __syncthreads();
  float* dst = partial + ((size_t)part * gridDim.x + blockIdx.x) * stride;
  flush_sums(dst, s_lo, s_hi, s_gmax, words, nl, nj);
  if (!any_odd) return;   // uniform across the block
  // pass 3: each update of a non-finite g onto the converted slice
  __syncthreads();
  if (!active) return;
  const int res = lv.res[level];
  const bool dense = lv.dense[level] != 0;
  const float resf = (float)res;
  const uint32_t mask = (uint32_t)(T - 1);
  for (long long p = begin + t / nl; p < end; p += q) {
    float gf[F];
    load_row<F>(g + p * row + level * F, gf);
    bool hit = false;
#pragma unroll
    for (int f = 0; f < F; ++f) hit |= !(fabsf(gf[f]) <= FLT_MAX);
    if (!hit) continue;
    const Cell cell = make_cell(x, p, resf, res);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int idx;
      float w;
      corner(cell, c, res, dense, mask, idx, w);
      const uint32_t j = (uint32_t)(idx - j0);
      if (j >= (uint32_t)nj) continue;
#pragma unroll
      for (int f = 0; f < F; ++f)
        if (!(fabsf(gf[f]) <= FLT_MAX))
          atomicAdd(&dst[f * fstride + li * nj + j], __fmul_rn(w, gf[f]));
    }
  }
}

// dtable[l, j, f] = the sum, in block order from 0, of the partial slices
// of the part that holds (l, j); 0 where no block ran.
__global__ void __launch_bounds__(256)
hashgrid_bwd_reduce_kernel(const float* __restrict__ partial,
                           float* __restrict__ dtable, int L, int T, int F,
                           Parts parts, int n_parts, int blocks, int stride) {
  const long long total = (long long)L * T * F;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int f = (int)(e % F);
    const int j = (int)((e / F) % T);
    const int l = (int)(e / ((long long)T * F));
    int part = 0;
    while (part + 1 < n_parts &&
           !(l >= parts.l0[part] && l < parts.l0[part] + parts.nl[part] &&
             j >= parts.j0[part] && j < parts.j0[part] + parts.nj[part]))
      ++part;
    const int i = (f * parts.nl[part] + l - parts.l0[part]) * parts.nj[part] +
                  j - parts.j0[part];
    const float* src = partial + (size_t)part * blocks * stride + i;
    float acc = 0.0f;
#pragma unroll 8
    for (int b = 0; b < blocks; ++b) acc += src[(size_t)b * stride];
    dtable[e] = acc;
  }
}

// The table gradient's cost split. The Pallas experiment times the TPU
// kernel's one-hot building (VPU) and its contraction (MXU) apart; here
// the backward's two parts are
//   the address part: load x and g, floor and clamp, hash, the 8 weights;
//   the accumulation part: shared-memory atomicAdds, then the flush of one
//   global atomicAdd per non-zero slot.
// Modes (one thread per (point, level), a level per blockIdx.y, as in
// the first hashgrid_bwd_kernel, with points_per_block a multiple of
// kThreads):
//   kFull   the first #2: a shared f32 copy of the level's gradient, updated
//           by atomicAdd and flushed by global atomicAdds; at 8192 points
//           per block it is the first hashgrid_bwd, launch for launch;
//   kGlobal every update an atomicAdd straight to global dtable, no shared
//           copy: the design the header rejects, measured;
//   kAddr   the address part alone: make_cell and corner as kFull, folded
//           into Σ idx (uint32, wrapping) and Σ w·g_f per thread, then one
//           global atomic per value and block into sums (L, 1 + F) (word 0
//           uint32, words 1..F f32), so the compiler keeps the work;
//   kAccum  the accumulation part alone: kFull's 8·F shared atomics per
//           point and its flush, on stand-ins from h = fmix32(p·8 + c): the
//           slot h & (T − 1) and, for every feature, the payload with bits
//           0x3F800000 | (h >> 9), in [1, 2). Neither x nor g is read, so
//           no load is timed twice in addr + accum. The mixer spreads the
//           slots over the table and the banks as the spatial hash does;
//           the low bits of (p·8 + c)·kPrime1 alone take 2 values mod 16
//           across a warp (16-way bank conflicts).
// Bounds, default config at N = 262,144: kFull, kGlobal and kAddr move
// hashgrid_bwd's ~28.5 MB (~8.5 us at 3.35 TB/s); kFull and kAccum issue
// N·L·8·F = 50.3 M shared atomics, ~6 us at one warp-wide shared atomic per
// SM per clock. A simple kernel: it measures the parts and is not tuned.
enum VariantMode { kFull = 0, kGlobal = 1, kAddr = 2, kAccum = 3 };

// MurmurHash3's 32-bit finaliser.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

template <int F, int Mode>
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_variant_kernel(const float* __restrict__ x,
                            const float* __restrict__ g,
                            float* __restrict__ dtable,
                            unsigned int* __restrict__ sums, long long n,
                            int L, int T, Levels lv, int points_per_thread) {
  constexpr bool kShared = Mode == kFull || Mode == kAccum;
  extern __shared__ float s_acc[];
  const int level = blockIdx.y;
  if (kShared) {
    for (int i = threadIdx.x; i < T * F; i += kThreads) s_acc[i] = 0.0f;
    __syncthreads();
  }

  const int res = lv.res[level];
  const bool dense = lv.dense[level] != 0;
  const float resf = (float)res;
  const uint32_t mask = (uint32_t)(T - 1);
  unsigned int idx_sum = 0;
  float wg_sum[F];
#pragma unroll
  for (int f = 0; f < F; ++f) wg_sum[f] = 0.0f;
  const long long base = (long long)blockIdx.x * kThreads * points_per_thread;
  for (int k = 0; k < points_per_thread; ++k) {
    const long long p = base + (long long)k * kThreads + threadIdx.x;
    if (p >= n) break;
    if (Mode == kAccum) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t h = fmix32((uint32_t)(p * 8 + c));
        const int idx = (int)(h & mask);
        const float v = __uint_as_float(0x3F800000u | (h >> 9));
#pragma unroll
        for (int f = 0; f < F; ++f) atomicAdd(&s_acc[idx * F + f], v);
      }
      continue;
    }
    float gf[F];
    const float* gp = g + p * (long long)(L * F) + level * F;
#pragma unroll
    for (int f = 0; f < F; ++f) gf[f] = gp[f];
    const Cell cell = make_cell(x, p, resf, res);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int idx;
      float w;
      corner(cell, c, res, dense, mask, idx, w);
      if (Mode == kAddr) idx_sum += (unsigned int)idx;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float v = w * gf[f];
        if (Mode == kFull) {
          atomicAdd(&s_acc[idx * F + f], v);
        } else if (Mode == kGlobal) {
          atomicAdd(&dtable[((size_t)level * T + idx) * F + f], v);
        } else {
          wg_sum[f] += v;
        }
      }
    }
  }

  if (kShared) {
    __syncthreads();
    float* dt = dtable + (size_t)level * T * F;
    for (int i = threadIdx.x; i < T * F; i += kThreads) {
      const float v = s_acc[i];
      if (v != 0.0f) atomicAdd(&dt[i], v);
    }
  }
  if (Mode == kAddr) {
    // warp sums by shuffles, then the block's 8 warps through shared memory
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      idx_sum += __shfl_down_sync(0xffffffffu, idx_sum, off);
#pragma unroll
      for (int f = 0; f < F; ++f)
        wg_sum[f] += __shfl_down_sync(0xffffffffu, wg_sum[f], off);
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      reinterpret_cast<unsigned int*>(s_acc)[warp * (1 + F)] = idx_sum;
#pragma unroll
      for (int f = 0; f < F; ++f) s_acc[warp * (1 + F) + 1 + f] = wg_sum[f];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned int si = 0;
      float sw[F];
#pragma unroll
      for (int f = 0; f < F; ++f) sw[f] = 0.0f;
      for (int w = 0; w < kThreads / 32; ++w) {
        si += reinterpret_cast<const unsigned int*>(s_acc)[w * (1 + F)];
#pragma unroll
        for (int f = 0; f < F; ++f) sw[f] += s_acc[w * (1 + F) + 1 + f];
      }
      unsigned int* out = sums + (size_t)level * (1 + F);
      atomicAdd(out, si);
#pragma unroll
      for (int f = 0; f < F; ++f)
        atomicAdd(reinterpret_cast<float*>(out) + 1 + f, sw[f]);
    }
  }
}

template <int F, int Mode>
cudaError_t launch_variant(const float* x, const float* g, float* dtable,
                           unsigned int* sums, long long n, int L, int T,
                           const Levels& lv, int points_per_block,
                           cudaStream_t stream) {
  auto kernel = hashgrid_bwd_variant_kernel<F, Mode>;
  size_t smem = 0;
  if (Mode == kFull || Mode == kAccum) smem = (size_t)T * F * sizeof(float);
  if (Mode == kAddr) smem = (kThreads / 32) * (1 + F) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks_x = (n + points_per_block - 1) / points_per_block;
  dim3 grid((unsigned)blocks_x, (unsigned)L);
  if (blocks_x > 0)
    kernel<<<grid, kThreads, smem, stream>>>(x, g, dtable, sums, n, L, T, lv,
                                             points_per_block / kThreads);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_variant_mode(int mode, const float* x, const float* g,
                                float* dtable, unsigned int* sums, long long n,
                                int L, int T, const Levels& lv, int ppb,
                                cudaStream_t s) {
  switch (mode) {
    case kFull: return launch_variant<F, kFull>(x, g, dtable, sums, n, L, T, lv, ppb, s);
    case kGlobal: return launch_variant<F, kGlobal>(x, g, dtable, sums, n, L, T, lv, ppb, s);
    case kAddr: return launch_variant<F, kAddr>(x, g, dtable, sums, n, L, T, lv, ppb, s);
    case kAccum: return launch_variant<F, kAccum>(x, g, dtable, sums, n, L, T, lv, ppb, s);
    default: return cudaErrorInvalidValue;
  }
}

// Today's #2 split into its parts (`hashgrid_bwd_split`), each run alone
// on #2's own grid (blocks a part, chunks, level-fastest threads, parts of
// table_parts):
//   kSplitFull    both kernels of #2 (hashgrid_bwd_kernel and the reduce);
//   kSplitGmax    pass 1 alone: g read once, each block's max |g| per
//                 level into gmax (blocks, L) f32;
//   kSplitAddr    pass 2 without the adds: g read again, x, make_cell, the 8
//                 corners, the rounded fixed-point updates v with the
//                 exponent of a given gmax, folded per block and level into
//                 the sums over the updates of idx (uint32, wrapping) and of
//                 v (int64), by one global atomic of each a thread;
//   kSplitAccum   pass 2's shared adds alone, low word and carry word
//                 (fixed_add), then the conversion into slices (flush_sums,
//                 exponent 28 at every level), on stand-ins from
//                 h = fmix32(p * 8 + c): the slot h & (T - 1) and, for every
//                 feature, v = (int32)h >> 3, of either sign and below
//                 2^28, the size of #2's updates of N(0, 1) g. Neither x nor
//                 g is read, so no load is timed twice;
//   kSplitReduce  hashgrid_bwd_reduce_kernel alone over given slices.
// Integer sums make every mode exact: each equals its plain version bit for
// bit, and full equals #2.
enum SplitMode {
  kSplitFull = 0, kSplitGmax = 1, kSplitAddr = 2, kSplitAccum = 3,
  kSplitReduce = 4
};

template <int F, int Mode>
__global__ void __launch_bounds__(kBwdThreads, 1)
hashgrid_bwd_split_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,
                          const float* __restrict__ gmax_in,   // (blocks, L)
                          float* __restrict__ gmax_out,        // (blocks, L)
                          uint32_t* __restrict__ idx_sums,     // (blocks, L)
                          unsigned long long* __restrict__ v_sums,
                          float* __restrict__ partial, long long n, int L,
                          int T, Levels lv, Parts parts, long long chunk,
                          int stride) {
  extern __shared__ __align__(16) uint32_t s_words[];
  const int part = blockIdx.y;
  const int l0 = parts.l0[part], nl = parts.nl[part];
  const int j0 = parts.j0[part], nj = parts.nj[part];
  const int words = nl * nj * F;
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = min(n, begin + chunk);
  const int q = blockDim.x / nl;   // points per pass
  const int t = threadIdx.x;
  const bool active = t < q * nl;
  const int li = t % nl;
  const int level = l0 + li;
  const long long row = (long long)L * F;
  const size_t out = (size_t)blockIdx.x * L + level;
  if constexpr (Mode == kSplitGmax) {
    int* s_gmax = reinterpret_cast<int*>(s_words);
    if (t < nl) s_gmax[t] = 0;
    __syncthreads();
    bool odd = false;
    if (active) {
      atomicMax(&s_gmax[li],
                level_gmax<F>(g, begin, end, q, t, nl, level, row, odd));
    }
    __syncthreads();
    if (t < nl) gmax_out[(size_t)blockIdx.x * L + l0 + t] =
        __int_as_float(s_gmax[t]);
  } else if constexpr (Mode == kSplitAddr) {
    if (!active) return;
    const float scale =
        pow2(fixed_exponent(__float_as_int(gmax_in[out])));
    uint32_t si = 0;
    long long sv = 0;
    level_updates<F>(x, g, begin, end, q, t, nl, level, row, T, lv, j0, nj,
                     scale, true, [&](int, uint32_t, int idx, int v) {
                       si += (uint32_t)idx;
                       sv += v;
                     });
    atomicAdd(idx_sums + out, si);
    atomicAdd(v_sums + out, (unsigned long long)sv);
  } else {  // kSplitAccum
    uint32_t* s_lo = s_words;
    int* s_hi = reinterpret_cast<int*>(s_words + words);
    int* s_gmax = s_hi + words;
    for (int i = t; i < words; i += blockDim.x) {
      s_lo[i] = kLoBias;
      s_hi[i] = 0;
    }
    // G = 2: exponent 29 - 1
    if (t < nl) s_gmax[t] = __float_as_int(2.0f);
    __syncthreads();
    if (active) {
      const int fstride = nl * nj;
      uint32_t* lo = s_lo + li * nj;
      int* hi = s_hi + li * nj;
      const uint32_t mask = (uint32_t)(T - 1);
#pragma unroll 2
      for (long long p = begin + t / nl; p < end; p += q) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint32_t h = fmix32((uint32_t)(p * 8 + c));
          const uint32_t j = (h & mask) - (uint32_t)j0;
          if (j >= (uint32_t)nj) continue;
          const int v = (int)h >> 3;
#pragma unroll
          for (int f = 0; f < F; ++f)
            fixed_add(&lo[f * fstride + j], &hi[f * fstride + j], v);
        }
      }
    }
    __syncthreads();
    float* dst = partial + ((size_t)part * gridDim.x + blockIdx.x) * stride;
    flush_sums(dst, s_lo, s_hi, s_gmax, words, nl, nj);
    for (int i = words + t; i < stride; i += blockDim.x) dst[i] = 0.0f;
  }
}

Levels make_levels(int L, const int* res, const int* dense) {
  Levels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.res[l] = l < L ? res[l] : 0;
    lv.dense[l] = l < L ? dense[l] : 0;
  }
  return lv;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int points_per_block, const float* a,
                   const float* b, float* c, long long n, int L, int T, int F,
                   const Levels& lv, cudaStream_t stream) {
  const size_t smem = (size_t)T * F * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks_x = (n + points_per_block - 1) / points_per_block;
  dim3 grid((unsigned)blocks_x, (unsigned)L);
  if (blocks_x > 0) kernel<<<grid, kThreads, smem, stream>>>(a, b, c, n, L, T, lv);
  return cudaGetLastError();
}

// The parts from the host's arrays; refuses more than kMaxParts, a part
// outside the table or a level count above kMaxLevels.
cudaError_t make_parts(int L, int T, int n_parts, const int* l0,
                       const int* nl, const int* j0, const int* nj,
                       Parts& parts, int& max_words_per_value) {
  if (L > kMaxLevels || n_parts < 1 || n_parts > kMaxParts)
    return cudaErrorInvalidValue;
  max_words_per_value = 0;
  for (int k = 0; k < kMaxParts; ++k) {
    const bool on = k < n_parts;
    parts.l0[k] = on ? l0[k] : 0;
    parts.nl[k] = on ? nl[k] : 0;
    parts.j0[k] = on ? j0[k] : 0;
    parts.nj[k] = on ? nj[k] : 0;
    if (!on) continue;
    if (nl[k] < 1 || l0[k] < 0 || l0[k] + nl[k] > L || nj[k] < 1 ||
        j0[k] < 0 || j0[k] + nj[k] > T)
      return cudaErrorInvalidValue;
    max_words_per_value = std::max(max_words_per_value, nl[k] * nj[k]);
  }
  return cudaSuccess;
}

// Dynamic shared memory: #1 an mbarrier (16 bytes with its padding) and
// the part's f32 table; #2 the low and high words of each value and the
// per-level maxima.
size_t fwd_smem(int F, int max_words_per_value) {
  return 16 + (size_t)max_words_per_value * F * sizeof(float);
}

size_t bwd_smem(int F, int max_words_per_value) {
  return (size_t)max_words_per_value * F * 2 * sizeof(uint32_t) +
         kMaxLevels * sizeof(int);
}

// Blocks of `kernel` (threads a block, smem bytes each) that the current
// card holds at once: its SMs times the blocks an SM takes. Opens the
// kernel's dynamic shared memory to kSmemOptIn first, once for every
// config, so that no launch has to.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                            long long& blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = (long long)sms * per_sm;
  return cudaSuccess;
}

template <int F>
cudaError_t resident_fwd_bwd(int which, int max_words, long long& blocks) {
  if (which == 0)
    return resident_blocks(hashgrid_fwd_kernel<F>, kFwdThreads,
                           fwd_smem(F, max_words), blocks);
  return resident_blocks(hashgrid_bwd_kernel<F>, kBwdThreads,
                         bwd_smem(F, max_words), blocks);
}

// blocks per part along x, from the host: 0 only for n = 0, and at most
// max_points points a block where max_points > 0.
bool valid_blocks(long long n, long long blocks, int max_points) {
  if (blocks < 0 || blocks > (1ll << 30) || (blocks == 0) != (n == 0))
    return false;
  return max_points <= 0 || blocks == 0 ||
         (n + blocks - 1) / blocks <= max_points;
}

template <int F>
cudaError_t launch_fwd(const float* x, const float* table, float* out,
                       long long n, int L, int T, const Levels& lv,
                       const Parts& parts, int n_parts, int max_words,
                       long long bx, cudaStream_t stream) {
  auto kernel = hashgrid_fwd_kernel<F>;
  const size_t smem = fwd_smem(F, max_words);
  if (bx > 0) {
    const long long chunk = (n + bx - 1) / bx;
    kernel<<<dim3((unsigned)bx, (unsigned)n_parts), kFwdThreads, smem,
             stream>>>(x, table, out, n, L, T, lv, parts, chunk);
  }
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_bwd(const float* x, const float* g, float* partial,
                       long long n, int L, int T, const Levels& lv,
                       const Parts& parts, int n_parts, int max_words,
                       long long bx, cudaStream_t stream) {
  auto kernel = hashgrid_bwd_kernel<F>;
  const size_t smem = bwd_smem(F, max_words);
  if (bx > 0) {
    const long long chunk = (n + bx - 1) / bx;
    kernel<<<dim3((unsigned)bx, (unsigned)n_parts), kBwdThreads, smem,
             stream>>>(x, g, partial, n, L, T, lv, parts, chunk,
                       max_words * F);
  }
  return cudaGetLastError();
}

cudaError_t launch_reduce(const float* partial, float* dtable, int L, int T,
                          int F, const Parts& parts, int n_parts,
                          long long blocks, int stride, cudaStream_t s) {
  const long long total = (long long)L * T * F;
  const long long grid = std::min((total + 255) / 256, 65535ll);
  hashgrid_bwd_reduce_kernel<<<(unsigned)grid, 256, 0, s>>>(
      partial, dtable, L, T, F, parts, n_parts, (int)blocks, stride);
  return cudaGetLastError();
}

template <int F, int Mode>
cudaError_t launch_split_part(const float* x, const float* g,
                              const float* gmax_in, float* gmax_out,
                              uint32_t* idx_sums,
                              unsigned long long* v_sums, float* partial,
                              long long n, int L, int T, const Levels& lv,
                              const Parts& parts, int n_parts, int max_words,
                              long long bx, cudaStream_t s) {
  auto kernel = hashgrid_bwd_split_kernel<F, Mode>;
  size_t smem = 0;
  if (Mode == kSplitGmax) smem = kMaxLevels * sizeof(int);
  if (Mode == kSplitAccum) {
    smem = bwd_smem(F, max_words);
    static bool opened = false;   // once per instance, before any capture
    if (!opened) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
      if (err != cudaSuccess) return err;
      opened = true;
    }
  }
  if (bx > 0) {
    const long long chunk = (n + bx - 1) / bx;
    kernel<<<dim3((unsigned)bx, (unsigned)n_parts), kBwdThreads, smem, s>>>(
        x, g, gmax_in, gmax_out, idx_sums, v_sums, partial, n, L, T, lv,
        parts, chunk, max_words * F);
  }
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_split(int mode, const float* x, const float* g,
                         float* dtable, float* partial, const float* gmax_in,
                         float* gmax_out, uint32_t* idx_sums,
                         unsigned long long* v_sums, long long n, int L,
                         int T, const Levels& lv, const Parts& parts,
                         int n_parts, int max_words, long long bx,
                         cudaStream_t s) {
  switch (mode) {
    case kSplitFull: {
      const cudaError_t err = launch_bwd<F>(x, g, partial, n, L, T, lv, parts,
                                            n_parts, max_words, bx, s);
      if (err != cudaSuccess) return err;
      return launch_reduce(partial, dtable, L, T, F, parts, n_parts, bx,
                           max_words * F, s);
    }
    case kSplitGmax: return launch_split_part<F, kSplitGmax>(x, g, gmax_in, gmax_out, idx_sums, v_sums, partial, n, L, T, lv, parts, n_parts, max_words, bx, s);
    case kSplitAddr: return launch_split_part<F, kSplitAddr>(x, g, gmax_in, gmax_out, idx_sums, v_sums, partial, n, L, T, lv, parts, n_parts, max_words, bx, s);
    case kSplitAccum: return launch_split_part<F, kSplitAccum>(x, g, gmax_in, gmax_out, idx_sums, v_sums, partial, n, L, T, lv, parts, n_parts, max_words, bx, s);
    case kSplitReduce:
      return launch_reduce(partial, dtable, L, T, F, parts, n_parts, bx,
                           max_words * F, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The blocks of #1 (which = 0) or #2 (which = 1) that the current card
// holds at once for parts of at most max_words (level, slot) pairs, into
// *blocks; opens the kernel's shared memory. Call it on each card before
// the kernel's first launch there (kernels/hashgrid.py asks once per
// kernel, config and card).
int hashgrid_resident_blocks(int which, int F, int max_words,
                             long long* blocks) {
  if (which < 0 || which > 1 || max_words < 1)
    return (int)cudaErrorInvalidValue;
  switch (F) {
    case 1: return (int)resident_fwd_bwd<1>(which, max_words, *blocks);
    case 2: return (int)resident_fwd_bwd<2>(which, max_words, *blocks);
    case 4: return (int)resident_fwd_bwd<4>(which, max_words, *blocks);
    case 8: return (int)resident_fwd_bwd<8>(which, max_words, *blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel #1. x (n, 3) f32 in [0, 1]; table (L, T, F) f32; out (n, L*F)
// f32. The parts (n_parts entries of l0, nl, j0, nj) are whole levels
// (j0 = 0, nj = T) that cover every level once; `blocks` per part.
int hashgrid_fwd(const float* x, const float* table, float* out, long long n,
                 int L, int T, int F, const int* res, const int* dense,
                 int n_parts, const int* l0, const int* nl, const int* j0,
                 const int* nj, long long blocks, void* stream) {
  Parts parts;
  int max_words = 0;
  cudaError_t err = make_parts(L, T, n_parts, l0, nl, j0, nj, parts,
                               max_words);
  if (err != cudaSuccess) return (int)err;
  for (int k = 0; k < n_parts; ++k)
    if (j0[k] != 0 || nj[k] != T) return (int)cudaErrorInvalidValue;
  if (!valid_blocks(n, blocks, 0)) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, res, dense);
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return (int)launch_fwd<1>(x, table, out, n, L, T, lv, parts, n_parts, max_words, blocks, s);
    case 2: return (int)launch_fwd<2>(x, table, out, n, L, T, lv, parts, n_parts, max_words, blocks, s);
    case 4: return (int)launch_fwd<4>(x, table, out, n, L, T, lv, parts, n_parts, max_words, blocks, s);
    case 8: return (int)launch_fwd<8>(x, table, out, n, L, T, lv, parts, n_parts, max_words, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The level-per-block forward (hashgrid_fwd_level_kernel), for timing
// beside #1: the arguments of the first hashgrid_fwd.
int hashgrid_fwd_level(const float* x, const float* table, float* out,
                       long long n, int L, int T, int F, const int* res,
                       const int* dense, void* stream) {
  if (L > kMaxLevels) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, res, dense);
  const int ppb = kThreads * kFwdPointsPerThread;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return (int)launch(hashgrid_fwd_level_kernel<1>, ppb, x, table, out, n, L, T, F, lv, s);
    case 2: return (int)launch(hashgrid_fwd_level_kernel<2>, ppb, x, table, out, n, L, T, F, lv, s);
    case 4: return (int)launch(hashgrid_fwd_level_kernel<4>, ppb, x, table, out, n, L, T, F, lv, s);
    case 8: return (int)launch(hashgrid_fwd_level_kernel<8>, ppb, x, table, out, n, L, T, F, lv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel #2. x (n, 3); g (n, L*F) upstream gradient; dtable (L, T, F),
// written whole; partial scratch of n_parts * blocks * max(nl * nj) * F
// floats, `blocks` per part, none with over kBwdMaxPoints points. The
// parts cover every (level, slot) once.
int hashgrid_bwd(const float* x, const float* g, float* dtable,
                 float* partial, long long n, int L, int T, int F,
                 const int* res, const int* dense, int n_parts,
                 const int* l0, const int* nl, const int* j0, const int* nj,
                 long long blocks, void* stream) {
  Parts parts;
  int max_words = 0;
  cudaError_t err = make_parts(L, T, n_parts, l0, nl, j0, nj, parts,
                               max_words);
  if (err != cudaSuccess) return (int)err;
  if (!valid_blocks(n, blocks, kBwdMaxPoints))
    return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, res, dense);
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: err = launch_bwd<1>(x, g, partial, n, L, T, lv, parts, n_parts, max_words, blocks, s); break;
    case 2: err = launch_bwd<2>(x, g, partial, n, L, T, lv, parts, n_parts, max_words, blocks, s); break;
    case 4: err = launch_bwd<4>(x, g, partial, n, L, T, lv, parts, n_parts, max_words, blocks, s); break;
    case 8: err = launch_bwd<8>(x, g, partial, n, L, T, lv, parts, n_parts, max_words, blocks, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(partial, dtable, L, T, F, parts, n_parts, blocks,
                            max_words * F, s);
}

// Kernel #11. The first hashgrid_bwd's arguments (x, g, dtable, n, L, T, F,
// res, dense, stream) plus one output per mode's shape, the mode (0
// full, 1 global, 2 addr, 3 accum) and points_per_block (a positive
// multiple of 256). dtable (L, T, F) f32, zero-filled by the caller, for
// full, global and accum; sums (L, 1 + F) 32-bit words, zero-filled, for
// addr. The other output may be null.
int hashgrid_bwd_variant(const float* x, const float* g, float* dtable,
                         unsigned int* sums, long long n, int L, int T, int F,
                         const int* res, const int* dense, int mode,
                         int points_per_block, void* stream) {
  if (L > kMaxLevels || points_per_block <= 0 ||
      points_per_block % kThreads != 0)
    return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, res, dense);
  const int ppb = points_per_block;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return (int)launch_variant_mode<1>(mode, x, g, dtable, sums, n, L, T, lv, ppb, s);
    case 2: return (int)launch_variant_mode<2>(mode, x, g, dtable, sums, n, L, T, lv, ppb, s);
    case 4: return (int)launch_variant_mode<4>(mode, x, g, dtable, sums, n, L, T, lv, ppb, s);
    case 8: return (int)launch_variant_mode<8>(mode, x, g, dtable, sums, n, L, T, lv, ppb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Today's #2 split into its parts (see hashgrid_bwd_split_kernel): mode 0
// full, 1 gmax, 2 addr, 3 accum, 4 reduce, on #2's parts and `blocks` a
// part (none with over kBwdMaxPoints points). Each mode reads and writes
// only its own operands, the others may be null: full x, g -> partial
// scratch, dtable; gmax g -> gmax_out (blocks, L) f32, written at every
// level; addr x, g, gmax_in (blocks, L) -> idx_sums (blocks, L) uint32 and
// v_sums (blocks, L) int64, zero-filled by the caller; accum -> partial
// (n_parts, blocks, max(nl * nj) * F) f32 slices, written whole; reduce
// partial -> dtable (L, T, F).
int hashgrid_bwd_split(const float* x, const float* g, float* dtable,
                       float* partial, const float* gmax_in, float* gmax_out,
                       unsigned int* idx_sums, unsigned long long* v_sums,
                       long long n, int L, int T, int F, const int* res,
                       const int* dense, int n_parts, const int* l0,
                       const int* nl, const int* j0, const int* nj,
                       long long blocks, int mode, void* stream) {
  Parts parts;
  int max_words = 0;
  cudaError_t err = make_parts(L, T, n_parts, l0, nl, j0, nj, parts,
                               max_words);
  if (err != cudaSuccess) return (int)err;
  if (!valid_blocks(n, blocks, kBwdMaxPoints) || mode < kSplitFull ||
      mode > kSplitReduce)
    return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, res, dense);
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return (int)launch_split<1>(mode, x, g, dtable, partial, gmax_in, gmax_out, idx_sums, v_sums, n, L, T, lv, parts, n_parts, max_words, blocks, s);
    case 2: return (int)launch_split<2>(mode, x, g, dtable, partial, gmax_in, gmax_out, idx_sums, v_sums, n, L, T, lv, parts, n_parts, max_words, blocks, s);
    case 4: return (int)launch_split<4>(mode, x, g, dtable, partial, gmax_in, gmax_out, idx_sums, v_sums, n, L, T, lv, parts, n_parts, max_words, blocks, s);
    case 8: return (int)launch_split<8>(mode, x, g, dtable, partial, gmax_in, gmax_out, idx_sums, v_sums, n, L, T, lv, parts, n_parts, max_words, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
