// Multiresolution hash-grid encode, forward and table gradient, for Hopper.
//
// Replaces the Pallas TPU kernels of tpunerf/kernels/hashgrid.py:
//   forward  _kernel_packed / _kernel, launched by _hash_encode_pallas;
//   backward _bwd_kernel, launched by _hash_bwd_pallas (custom VJP _bwd);
//   the backward's cost-split experiment, the kernel of _make_kernel
//   launched by hash_bwd_variant in scripts/exp_hash_bwd.py (see
//   hashgrid_bwd_variant_kernel below).
//
// What bounds it on this card: at the default config (L=12, T=2^11, F=2)
// and N = 262,144 points per step, the forward reads x (3 MB) and writes
// (N, 24) f32 (25 MB): ~28 MB, ~8.5 us at 3.35 TB/s. The backward reads x
// and g (~28 MB) and writes the 192 KiB table gradient. Both are bounded by
// bytes; the 8 corner gathers per (point, level) are the latency risk.
//
// Design:
// * one thread per (point, level); blockIdx.y is the level, so a block
//   stages that level's T*F f32 slice (16 KiB) in shared memory once and
//   every gather is a shared-memory load. Each block walks several point
//   chunks so the staging cost is amortised;
// * the hash is computed in uint32, as in the reference; the table stays
//   f32 (the TPU kernel's bf16 pair packing and 128-lane window sweep are
//   TPU devices, not semantics);
// * backward: every level is hashed at the default config, so ~1000
//   updates hit each of the 2048 slots per level per step. Global atomics
//   alone would serialise on those slots, so each block accumulates into a
//   shared-memory copy of the level's gradient with atomicAdd and then
//   flushes it with one global atomicAdd per non-zero slot.
//
// Every launch is on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int kFwdPointsPerThread = 8;
constexpr int kBwdPointsPerThread = 32;
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;

struct Levels {
  int res[kMaxLevels];
  int dense[kMaxLevels];
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

template <int F>
__global__ void __launch_bounds__(kThreads)
hashgrid_fwd_kernel(const float* __restrict__ x,
                    const float* __restrict__ table, float* __restrict__ out,
                    long long n, int L, int T, Levels lv) {
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

template <int F>
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ dtable, long long n, int L, int T,
                    Levels lv) {
  extern __shared__ float s_acc[];
  const int level = blockIdx.y;
  for (int i = threadIdx.x; i < T * F; i += kThreads) s_acc[i] = 0.0f;
  __syncthreads();

  const int res = lv.res[level];
  const bool dense = lv.dense[level] != 0;
  const float resf = (float)res;
  const uint32_t mask = (uint32_t)(T - 1);
  const long long base = (long long)blockIdx.x * kThreads * kBwdPointsPerThread;
  for (int k = 0; k < kBwdPointsPerThread; ++k) {
    const long long p = base + (long long)k * kThreads + threadIdx.x;
    if (p >= n) break;
    const Cell cell = make_cell(x, p, resf, res);
    float gf[F];
    const float* gp = g + p * (long long)(L * F) + level * F;
#pragma unroll
    for (int f = 0; f < F; ++f) gf[f] = gp[f];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int idx;
      float w;
      corner(cell, c, res, dense, mask, idx, w);
#pragma unroll
      for (int f = 0; f < F; ++f) atomicAdd(&s_acc[idx * F + f], w * gf[f]);
    }
  }
  __syncthreads();
  float* dt = dtable + (size_t)level * T * F;
  for (int i = threadIdx.x; i < T * F; i += kThreads) {
    const float v = s_acc[i];
    if (v != 0.0f) atomicAdd(&dt[i], v);
  }
}

// The table gradient's cost split. The Pallas experiment times the TPU
// kernel's one-hot building (VPU) and its contraction (MXU) apart; here
// the backward's two parts are
//   the address part: load x and g, floor and clamp, hash, the 8 weights;
//   the accumulation part: shared-memory atomicAdds, then the flush of one
//   global atomicAdd per non-zero slot.
// Modes (one thread per (point, level), a level per blockIdx.y, as in
// hashgrid_bwd_kernel, with points_per_block a multiple of kThreads):
//   kFull   hashgrid_bwd_kernel's design; at 8192 points per block it
//           computes what hashgrid_bwd computes;
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

}  // namespace

extern "C" {

// x (n, 3) f32 in [0, 1]; table (L, T, F) f32; out (n, L*F) f32.
int hashgrid_fwd(const float* x, const float* table, float* out, long long n,
                 int L, int T, int F, const int* res, const int* dense,
                 void* stream) {
  if (L > kMaxLevels) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, res, dense);
  const int ppb = kThreads * kFwdPointsPerThread;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return (int)launch(hashgrid_fwd_kernel<1>, ppb, x, table, out, n, L, T, F, lv, s);
    case 2: return (int)launch(hashgrid_fwd_kernel<2>, ppb, x, table, out, n, L, T, F, lv, s);
    case 4: return (int)launch(hashgrid_fwd_kernel<4>, ppb, x, table, out, n, L, T, F, lv, s);
    case 8: return (int)launch(hashgrid_fwd_kernel<8>, ppb, x, table, out, n, L, T, F, lv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x (n, 3); g (n, L*F) upstream gradient; dtable (L, T, F) zero-filled by
// the caller, accumulated into.
int hashgrid_bwd(const float* x, const float* g, float* dtable, long long n,
                 int L, int T, int F, const int* res, const int* dense,
                 void* stream) {
  if (L > kMaxLevels) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, res, dense);
  const int ppb = kThreads * kBwdPointsPerThread;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return (int)launch(hashgrid_bwd_kernel<1>, ppb, x, g, dtable, n, L, T, F, lv, s);
    case 2: return (int)launch(hashgrid_bwd_kernel<2>, ppb, x, g, dtable, n, L, T, F, lv, s);
    case 4: return (int)launch(hashgrid_bwd_kernel<4>, ppb, x, g, dtable, n, L, T, F, lv, s);
    case 8: return (int)launch(hashgrid_bwd_kernel<8>, ppb, x, g, dtable, n, L, T, F, lv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// hashgrid_bwd's arguments plus one output per mode's shape, the mode (0
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

}  // extern "C"
