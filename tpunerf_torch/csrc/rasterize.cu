// Visible-face selection of the hard rasterizer, dense and band-binned, for
// Hopper.
//
// Replaces the Pallas TPU kernel tpunerf/kernels/rasterize.py:_sel_kernel,
// launched by _select_faces_pallas (every face against every pixel) and by
// _select_binned_pallas (each 1024-pixel band against its own K-slot bin of
// faces).
//
// What it computes: per pixel, the face with the highest interpolated z
// among the faces whose three sign-normalised edge functions are >= 0
// (edges inclusive); the lowest face id wins an exact z tie; -1 marks
// background. A face is a row of 12 affine coefficients
// [e0x e0y e0c  e1x e1y e1c  e2x e2y e2c  zx zy zc] made by
// kernels/rasterize.py:_face_rows; invalid and degenerate faces come with
// e0 = (0, 0, -1) and can never win.
//
// What bounds it on this card: operations. A face-pixel pair costs four
// affine evaluations, three compares and a select, about 25 f32 operations
// and no memory traffic beyond the staged row: dense at F = 3968, P = 4096
// is 0.4 GFLOP against 0.2 MB moved; binned at 5 x 256 bands x 1024 px x
// K = 256 is 8.4 GFLOP against ~10 MB. Both sit on the CUDA cores' f32 rate.
//
// Design: a thread owns a pixel and keeps (best z, best id) in registers.
// Rows go through shared memory in tiles and are read as broadcasts, three
// 16-byte loads per face. A thread sweeps its rows in ascending face id with
// a strict `>`, which is the lowest-id tie rule.
// * Dense: the training render has only 4096 pixels, too few threads to fill
//   132 SMs, so a block takes 64 pixels x 4 slices of the face list; slice s
//   sweeps the s-th quarter of the faces and the four partial results merge
//   in ascending slice order with the same strict `>`, so lower ids still
//   win ties.
// * Binned: a block owns one (batch, band), gathers the band's K rows through
//   its id list into shared memory once, and each of its 1024 threads sweeps
//   them; the result is the winning slot, which the caller maps back to a
//   face id.
// Exactness: each affine form is a*px + b*py + c evaluated as
// (a*px + b*py) + c with round-to-nearest intrinsics, the order of the plain
// version, so that no FMA contraction moves a pixel that lies exactly on an
// edge (shared edges of a mesh are also exact z ties). This file must not be
// built with --use_fast_math.
//
// Every launch is on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRow = 12;        // floats per face row
constexpr int kPix = 64;        // dense: pixels per block
constexpr int kSlices = 4;      // dense: face-list slices per block
constexpr int kTile = 64;       // dense: rows staged per slice per round
constexpr int kBand = 1024;     // binned: pixels per band = threads per block

__device__ __forceinline__ float affine(float a, float b, float c, float px,
                                        float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// Sweep n staged rows (ids id0, id0+1, ...) against one pixel.
__device__ __forceinline__ void sweep(const float4* __restrict__ rows, int n,
                                      int id0, float px, float py, float& bz,
                                      int& bi) {
#pragma unroll 4
  for (int f = 0; f < n; ++f) {
    const float4 a = rows[3 * f + 0];  // e0x e0y e0c e1x
    const float4 b = rows[3 * f + 1];  // e1y e1c e2x e2y
    const float4 c = rows[3 * f + 2];  // e2c zx  zy  zc
    const float w0 = affine(a.x, a.y, a.z, px, py);
    const float w1 = affine(a.w, b.x, b.y, px, py);
    const float w2 = affine(b.z, b.w, c.x, px, py);
    const float z = affine(c.y, c.z, c.w, px, py);
    // a NaN fails every compare: such a face neither hits nor wins
    if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f && z > bz) {
      bz = z;
      bi = id0 + f;
    }
  }
}

__global__ void __launch_bounds__(kPix * kSlices)
select_dense_kernel(const float* __restrict__ rows,  // (B, F, 12)
                    const float* __restrict__ pix,   // (P, 2)
                    int* __restrict__ out,           // (B, P)
                    int F, int P) {
  __shared__ float4 tile[kSlices][kTile * 3];
  __shared__ float merge_z[kSlices][kPix];
  __shared__ int merge_i[kSlices][kPix];

  const int lane = threadIdx.x;   // pixel within the block
  const int slice = threadIdx.y;  // warps share a slice: row reads broadcast
  const int b = blockIdx.y;
  const int p = blockIdx.x * kPix + lane;
  const bool live = p < P;
  const float px = live ? pix[2 * p + 0] : 2.0f;
  const float py = live ? pix[2 * p + 1] : 2.0f;

  const int per_slice = (F + kSlices - 1) / kSlices;
  const int lo = slice * per_slice;
  const int hi = min(F, lo + per_slice);
  const float4* src =
      reinterpret_cast<const float4*>(rows + (size_t)b * F * kRow);

  float bz = -INFINITY;
  int bi = -1;
  for (int base = 0; base < per_slice; base += kTile) {
    const int first = lo + base;
    const int n = max(0, min(kTile, hi - first));
    __syncthreads();  // the previous round's reads are done
    for (int i = lane; i < n * 3; i += kPix) {
      tile[slice][i] = src[(size_t)first * 3 + i];
    }
    __syncthreads();
    sweep(tile[slice], n, first, px, py, bz, bi);
  }

  merge_z[slice][lane] = bz;
  merge_i[slice][lane] = bi;
  __syncthreads();
  if (slice == 0 && live) {
    // ascending slices hold ascending ids: strict > keeps the lowest id
    for (int s = 1; s < kSlices; ++s) {
      const float z = merge_z[s][lane];
      if (z > bz) {
        bz = z;
        bi = merge_i[s][lane];
      }
    }
    out[(size_t)b * P + p] = bi;
  }
}

__global__ void __launch_bounds__(kBand)
select_binned_kernel(const float* __restrict__ rows,  // (B, Fr, 12)
                     const int* __restrict__ ids,     // (B, nb, K)
                     const float* __restrict__ pix,   // (P, 2)
                     int* __restrict__ out,           // (B, nb, 1024) slots
                     int Fr, int nb, int K, int P) {
  extern __shared__ float4 bin[];  // K rows x 3 float4
  const int band = blockIdx.x;
  const int b = blockIdx.y;
  const int* band_ids = ids + ((size_t)b * nb + band) * K;
  const float4* src =
      reinterpret_cast<const float4*>(rows + (size_t)b * Fr * kRow);
  for (int i = threadIdx.x; i < K * 3; i += kBand) {
    const int k = i / 3;
    bin[i] = src[(size_t)band_ids[k] * 3 + (i - 3 * k)];
  }
  __syncthreads();

  const int p = band * kBand + threadIdx.x;
  // pixels past the image sit outside NDC and hit nothing
  const float px = p < P ? pix[2 * p + 0] : 2.0f;
  const float py = p < P ? pix[2 * p + 1] : 2.0f;
  float bz = -INFINITY;
  int bi = -1;
  sweep(bin, K, 0, px, py, bz, bi);
  out[((size_t)b * nb + band) * kBand + threadIdx.x] = bi;
}

}  // namespace

extern "C" {

// rows (B, F, 12) f32 face rows; pix (P, 2) f32 NDC pixel centres;
// out (B, P) int32 winning face id or -1.
int select_faces_dense(const float* rows, const float* pix, int* out, int B,
                       int F, int P, void* stream) {
  if (B > 0 && P > 0) {
    const dim3 grid((unsigned)((P + kPix - 1) / kPix), (unsigned)B);
    const dim3 block(kPix, kSlices);
    select_dense_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(rows, pix,
                                                                  out, F, P);
  }
  return (int)cudaGetLastError();
}

// rows (B, Fr, 12) f32 face rows (the last one the never-wins filler);
// ids (B, nb, K) int32 row index per bin slot; pix (P, 2) f32;
// out (B, nb, 1024) int32 winning slot or -1.
int select_faces_binned(const float* rows, const int* ids, const float* pix,
                        int* out, int B, int Fr, int nb, int K, int P,
                        void* stream) {
  const size_t smem = (size_t)K * kRow * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        select_binned_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0 && nb > 0) {
    const dim3 grid((unsigned)nb, (unsigned)B);
    select_binned_kernel<<<grid, kBand, smem, (cudaStream_t)stream>>>(
        rows, ids, pix, out, Fr, nb, K, P);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
