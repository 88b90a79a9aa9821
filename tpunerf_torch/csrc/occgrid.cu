// Bit-packed occupancy-grid lookup for Hopper.
//
// Replaces the Pallas TPU kernel tpunerf/kernels/occgrid.py:_kernel,
// launched by occupancy_lookup_packed from fields/occupancy.py:occupied.
//
// What bounds it on this card: bytes. Per step the ray marcher tests
// B*P*S = 524,288 samples: 6.3 MB of xyz read, 0.5 MB of flags written,
// and the 256 KiB bitfield (G=128), which stays in L2. ~7 MB, ~2 us at
// 3.35 TB/s.
//
// Design (`occgrid_lookup`):
// * Four samples a thread. Their 48 bytes of xyz arrive as three 16-byte
//   loads and their four flags leave as one 32-bit store. Threads sweep the
//   groups of four in a grid-stride loop over a grid of at most the blocks
//   the SMs hold at once (one partial wave where the work is smaller). A
//   ragged tail of n % 4 samples goes to the grid's first threads, one
//   sample each. Where xyz does not start on 16 bytes (a view with an
//   offset) every sample takes that one-sample path (`vec` = 0, the
//   wrapper's choice).
// * The cell index is that of the reference fields/occupancy.py:lookup,
//   u = (x/bound + 1)/2, truncate u*G, clamp, spelled with round-to-nearest
//   intrinsics so that no FMA contraction moves a sample across a cell wall
//   (this file must not be built with --use_fast_math). Where bound is a
//   power of two whose reciprocal is a float (the default 1.0), both
//   quotients become products, x*(1/bound) and (.)*0.5: each is the
//   correctly rounded value of the same real number as the quotient, so the
//   two agree bit for bit on every input, and the products skip the
//   quotient's multi-instruction sequence. Other bounds keep the quotients
//   (`kPow2`, a template flag: one semantics).
// * The words are read through the read-only path.
// Bits are packed z-minor (bit i of word w is cell w*32+i, the order of
// tpunerf/kernels/occgrid.py:pack_bits); the TPU kernel's 16^3-cube order
// and sparse window sweep are TPU devices and are not carried over. Note
// that the TPU kernel computes (x+bound)*scale instead; the plain reference
// is the target here.
//
// The first design, one thread a sample with six quotients, is kept as
// `occgrid_lookup_scalar`, only to be timed beside this one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kPow2>
__device__ __forceinline__ int cell(float x, float bound, float inv, int G) {
  const float q = kPow2 ? __fmul_rn(x, inv) : __fdiv_rn(x, bound);
  const float u = kPow2 ? __fmul_rn(__fadd_rn(q, 1.0f), 0.5f)
                        : __fdiv_rn(__fadd_rn(q, 1.0f), 2.0f);
  const int i = (int)__fmul_rn(u, (float)G);  // truncates toward zero
  return i < 0 ? 0 : (i > G - 1 ? G - 1 : i);
}

template <bool kPow2>
__device__ __forceinline__ uint32_t sample(const uint32_t* __restrict__ words,
                                           float x, float y, float z, int G,
                                           float bound, float inv) {
  const long long flat =
      ((long long)cell<kPow2>(x, bound, inv, G) * G +
       cell<kPow2>(y, bound, inv, G)) * G + cell<kPow2>(z, bound, inv, G);
  return (__ldg(&words[flat >> 5]) >> (uint32_t)(flat & 31)) & 1u;
}

template <bool kPow2>
__global__ void __launch_bounds__(kThreads)
occgrid_lookup_kernel(const float* __restrict__ x,
                      const uint32_t* __restrict__ words,
                      uint8_t* __restrict__ out, long long n, int G,
                      float bound, float inv, int vec) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long first = 0;  // the first sample of the one-sample loop
  if (vec) {
    const long long groups = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    uint32_t* out4 = reinterpret_cast<uint32_t*>(out);
    for (long long q = t; q < groups; q += stride) {
      // a: x0 y0 z0 x1 | b: y1 z1 x2 y2 | c: z2 x3 y3 z3
      const float4 a = __ldg(x4 + 3 * q);
      const float4 b = __ldg(x4 + 3 * q + 1);
      const float4 c = __ldg(x4 + 3 * q + 2);
      out4[q] = sample<kPow2>(words, a.x, a.y, a.z, G, bound, inv) |
                sample<kPow2>(words, a.w, b.x, b.y, G, bound, inv) << 8 |
                sample<kPow2>(words, b.z, b.w, c.x, G, bound, inv) << 16 |
                sample<kPow2>(words, c.y, c.z, c.w, G, bound, inv) << 24;
    }
    first = groups << 2;
  }
  for (long long p = first + t; p < n; p += stride) {
    out[p] = (uint8_t)sample<kPow2>(words, x[3 * p], x[3 * p + 1],
                                    x[3 * p + 2], G, bound, inv);
  }
}

// ---- the first design, timed only ----------------------------------------

__device__ __forceinline__ int cell_index(float x, float bound, int G) {
  const float u = __fdiv_rn(__fadd_rn(__fdiv_rn(x, bound), 1.0f), 2.0f);
  int i = (int)__fmul_rn(u, (float)G);  // truncates toward zero
  return i < 0 ? 0 : (i > G - 1 ? G - 1 : i);
}

__global__ void __launch_bounds__(kThreads)
occgrid_lookup_scalar_kernel(const float* __restrict__ x,
                             const uint32_t* __restrict__ words,
                             uint8_t* __restrict__ out, long long n, int G,
                             float bound) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int ix = cell_index(x[p * 3 + 0], bound, G);
  const int iy = cell_index(x[p * 3 + 1], bound, G);
  const int iz = cell_index(x[p * 3 + 2], bound, G);
  const long long flat = ((long long)ix * G + iy) * G + iz;
  const uint32_t word = __ldg(&words[flat >> 5]);
  out[p] = (uint8_t)((word >> (uint32_t)(flat & 31)) & 1u);
}

// The blocks of `kernel` that all SMs hold at once, asked once per kernel.
long long resident_blocks(const void* kernel, int* cached) {
  if (*cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess ||
        sms * per_sm == 0) {
      return 0;
    }
    *cached = sms * per_sm;
  }
  return *cached;
}

}  // namespace

extern "C" {

// x (n, 3) f32 world coordinates, 16-byte aligned where vec != 0; words
// (G^3/32,) packed z-minor bits; out (n,) uint8 in {0, 1}, 4-byte aligned.
// pow2 != 0 only where bound is a power of two whose reciprocal is a float.
int occgrid_lookup(const float* x, const uint32_t* words, uint8_t* out,
                   long long n, int G, float bound, int vec, int pow2,
                   void* stream) {
  static int cached[2] = {0, 0};
  if (n <= 0) return (int)cudaGetLastError();
  const void* kernel = pow2 ? (const void*)occgrid_lookup_kernel<true>
                            : (const void*)occgrid_lookup_kernel<false>;
  const long long resident = resident_blocks(kernel, &cached[pow2 ? 1 : 0]);
  if (resident == 0) return (int)cudaErrorInvalidValue;
  const long long work = vec ? ((n >> 2) > 0 ? (n >> 2) : 1) : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  const float inv = 1.0f / bound;
  if (pow2) {
    occgrid_lookup_kernel<true><<<(unsigned)blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(x, words, out, n, G,
                                                          bound, inv, vec);
  } else {
    occgrid_lookup_kernel<false><<<(unsigned)blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(x, words, out, n,
                                                           G, bound, inv, vec);
  }
  return (int)cudaGetLastError();
}

// The first design, with the same contract (any alignment, no pow2).
int occgrid_lookup_scalar(const float* x, const uint32_t* words, uint8_t* out,
                          long long n, int G, float bound, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0) {
    occgrid_lookup_scalar_kernel<<<(unsigned)blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(x, words, out, n, G,
                                                           bound);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
