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

// ===========================================================================
// DIB-R soft silhouette, forward and backward, dense and band-binned.
//
// Replaces the Pallas TPU kernels of tpunerf/kernels/rasterize.py:
//   soft_fwd_dense   <- _soft_fwd_dense_batched  (_soft_fwd_kernel)
//   soft_fwd_binned  <- _soft_fwd_binned          (_soft_fwd_kernel)
//   soft_bwd_dense   <- _soft_bwd_dense_batched  (_soft_bwd_kernel,
//                                                  _soft_grad_rows)
//   soft_bwd_binned  <- _soft_bwd_binned          (_soft_bwd_binned_kernel)
//
// What they compute: forward, per pixel, prod = PROD_f (1 - p_f) with p_f = 1
// where the face's three sign-normalised edge forms are >= 0 and
// exp(-d2/sigma) elsewhere, d2 the least squared distance to the face's three
// edges; the mask is 1 - prod. A face is a row of 16 floats made by
// kernels/rasterize.py:_soft_rows: 9 edge coefficients, v0 v1 v2 xy, valid.
// Backward, per face, the closed-form gradient of L to the six vertex
// coordinates summed over pixels: dL/dp = g*prod / max(1-p, 1e-12), outside
// dL/dd2 = -p/sigma * dL/dp given whole to the first minimal edge a->b with
// dd2/da = -2(1-s) r and dd2/db = -2 s r (s the clamped foot parameter, r the
// residual); inside pixels and rows with valid = 0 give 0.
//
// What bounds them on this card: operations. A (face, pixel) pair costs three
// affine forms, three point-segment distances, a quotient and an expf, about
// 80 f32 operations forward and about 110 backward, against 64 bytes a face
// and 8 to 16 bytes a pixel: dense at F = 3968, P = 4096 is 1.3 GFLOP for
// 0.3 MB; binned at 5 views x 256 bands of 1024 pixels is about 80 operations
// for each filled bin slot and pixel. All on the CUDA cores' f32 rate.
//
// Design.
// * A row is staged into shared memory once per block with the three
//   1/max(|edge|^2, 1e-10) appended (they depend on the face alone), and read
//   from there as broadcasts.
// * Forward, dense: a thread owns a pixel. 4096 pixels are too few threads for
//   132 SMs, so a block is 32 pixels x 8 slices of the face list (one warp a
//   slice) and the eight partial products are multiplied in slice order: the
//   order of the product differs from a single sweep's, by rounding only.
// * Forward, binned: a block owns one (view, band) of 1024 pixels and gathers
//   the band's rows through its id list in tiles of 128 slots; the (B, nb, K,
//   16) table is never materialised. Bins hold their faces first and fillers
//   after them, so the sweep ends at the first filler.
// * Backward: a block owns 8 faces (dense) or 8 slots of one band (binned);
//   its 256 threads stride the pixels with 48 sums in registers, then reduce
//   by warp shuffles and through shared memory in a fixed order. No atomics:
//   the result is deterministic. Pixels with g*prod == 0 (all of the
//   silhouette's interior, where prod is exactly 0) are skipped, which also
//   keeps 0/0 out. The binned kernel writes one row per (band, slot); the
//   caller sums them to faces by id.
// * Backward divides forward's prod by 1 - p, so both must get the same bits
//   for p: the arithmetic up to expf is spelled with round-to-nearest
//   intrinsics in one device function, which leaves the compiler no choice of
//   contraction in either kernel. It is also the plain version's order of
//   operations. This file must not be built with --use_fast_math.
// ===========================================================================

namespace {

constexpr int kSRow = 16;     // floats per soft row
constexpr int kSQuads = 5;    // float4 per staged row: 16 + 3 inverses + pad
constexpr int kSPix = 32;     // dense forward: pixels per block, one warp
constexpr int kSSlices = 8;   // dense forward: slices of the face list
constexpr int kBTile = 128;   // binned forward: slots staged per round
constexpr int kGFaces = 8;    // backward: faces (slots) per block
constexpr int kGThreads = 256;

__device__ __forceinline__ float inv_len2(float ax, float ay, float bx,
                                          float by) {
  const float wx = __fsub_rn(bx, ax), wy = __fsub_rn(by, ay);
  return __fdiv_rn(
      1.0f, fmaxf(__fadd_rn(__fmul_rn(wx, wx), __fmul_rn(wy, wy)), 1e-10f));
}

// One 16-float row -> 5 float4 in shared memory.
// q0: e0x e0y e0c e1x | q1: e1y e1c e2x e2y | q2: e2c v0x v0y v1x |
// q3: v1y v2x v2y valid | q4: inv(v0v1) inv(v1v2) inv(v2v0) 0
__device__ __forceinline__ void stage_row(const float* __restrict__ src,
                                          float4* __restrict__ dst) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  const float4 c = s4[2], d = s4[3];
  dst[0] = s4[0];
  dst[1] = s4[1];
  dst[2] = c;
  dst[3] = d;
  dst[4] = make_float4(inv_len2(c.y, c.z, c.w, d.x),
                       inv_len2(c.w, d.x, d.y, d.z),
                       inv_len2(d.y, d.z, c.y, c.z), 0.0f);
}

__device__ __forceinline__ void stage_zero(float4* __restrict__ dst) {
  for (int i = 0; i < kSQuads; ++i) dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

struct Seg {
  float d, s, rx, ry;
};

__device__ __forceinline__ Seg seg_d2(float px, float py, float ax, float ay,
                                      float bx, float by, float inv) {
  const float wx = __fsub_rn(bx, ax), wy = __fsub_rn(by, ay);
  const float ux = __fsub_rn(px, ax), uy = __fsub_rn(py, ay);
  const float dot = __fadd_rn(__fmul_rn(ux, wx), __fmul_rn(uy, wy));
  Seg r;
  r.s = fminf(fmaxf(__fmul_rn(dot, inv), 0.0f), 1.0f);
  r.rx = __fsub_rn(ux, __fmul_rn(r.s, wx));
  r.ry = __fsub_rn(uy, __fmul_rn(r.s, wy));
  r.d = __fadd_rn(__fmul_rn(r.rx, r.rx), __fmul_rn(r.ry, r.ry));
  return r;
}

// The coverage probability of one staged face at one pixel (valid applied),
// with what the backward needs besides.
__device__ __forceinline__ float face_prob(const float4* __restrict__ r,
                                           float px, float py, float sigma,
                                           bool& inside, float& d, Seg* seg) {
  const float4 q0 = r[0], q1 = r[1], q2 = r[2], q3 = r[3], q4 = r[4];
  const float w0 = affine(q0.x, q0.y, q0.z, px, py);
  const float w1 = affine(q0.w, q1.x, q1.y, px, py);
  const float w2 = affine(q1.z, q1.w, q2.x, px, py);
  inside = w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f;
  seg[0] = seg_d2(px, py, q2.y, q2.z, q2.w, q3.x, q4.x);  // v0 -> v1
  seg[1] = seg_d2(px, py, q2.w, q3.x, q3.y, q3.z, q4.y);  // v1 -> v2
  seg[2] = seg_d2(px, py, q3.y, q3.z, q2.y, q2.z, q4.z);  // v2 -> v0
  d = fminf(seg[0].d, fminf(seg[1].d, seg[2].d));
  const float p = inside ? 1.0f : expf(__fdiv_rn(-d, sigma));
  return __fmul_rn(p, q3.w);
}

__device__ __forceinline__ float sweep_soft(const float4* __restrict__ rows,
                                            int n, float px, float py,
                                            float sigma, float prod) {
  for (int f = 0; f < n; ++f) {
    bool inside;
    float d;
    Seg seg[3];
    const float p = face_prob(rows + f * kSQuads, px, py, sigma, inside, d,
                              seg);
    prod = __fmul_rn(prod, __fsub_rn(1.0f, p));
  }
  return prod;
}

__global__ void __launch_bounds__(kSPix * kSSlices)
soft_fwd_dense_kernel(const float* __restrict__ rows,  // (B, F, 16)
                      const float* __restrict__ pix,   // (P, 2)
                      float* __restrict__ out,         // (B, P) prod
                      int F, int P, float sigma) {
  __shared__ float4 tile[kSSlices][kSPix * kSQuads];
  __shared__ float part[kSSlices][kSPix];

  const int lane = threadIdx.x;   // pixel within the block
  const int slice = threadIdx.y;  // one warp per slice
  const int b = blockIdx.y;
  const int p = blockIdx.x * kSPix + lane;
  const bool live = p < P;
  // pixels past the image sit far outside NDC: expf underflows to 0
  const float px = live ? pix[2 * p + 0] : 5.0f;
  const float py = live ? pix[2 * p + 1] : 5.0f;

  const int per_slice = (F + kSSlices - 1) / kSSlices;
  const int lo = slice * per_slice;
  const int hi = min(F, lo + per_slice);
  const float* src = rows + (size_t)b * F * kSRow;

  float prod = 1.0f;
  for (int base = 0; base < per_slice; base += kSPix) {
    const int first = lo + base;
    const int n = max(0, min(kSPix, hi - first));
    __syncthreads();  // the previous round's reads are done
    if (lane < n) {
      stage_row(src + (size_t)(first + lane) * kSRow,
                &tile[slice][lane * kSQuads]);
    }
    __syncthreads();
    prod = sweep_soft(tile[slice], n, px, py, sigma, prod);
  }

  part[slice][lane] = prod;
  __syncthreads();
  if (slice == 0 && live) {
    for (int s = 1; s < kSSlices; ++s) prod = __fmul_rn(prod, part[s][lane]);
    out[(size_t)b * P + p] = prod;
  }
}

__global__ void __launch_bounds__(kBand)
soft_fwd_binned_kernel(const float* __restrict__ rows,  // (B, Fr, 16)
                       const int* __restrict__ ids,     // (B, nb, K)
                       const float* __restrict__ pix,   // (P, 2)
                       float* __restrict__ out,         // (B, nb, 1024) prod
                       int Fr, int nb, int K, int P, float sigma) {
  __shared__ float4 tile[kBTile * kSQuads];
  const int tid = threadIdx.x;
  const int band = blockIdx.x;
  const int b = blockIdx.y;
  const int* band_ids = ids + ((size_t)b * nb + band) * K;
  const float* src = rows + (size_t)b * Fr * kSRow;

  const int p = band * kBand + tid;
  const float px = p < P ? pix[2 * p + 0] : 5.0f;
  const float py = p < P ? pix[2 * p + 1] : 5.0f;

  float prod = 1.0f;
  for (int k0 = 0; k0 < K; k0 += kBTile) {
    __syncthreads();  // the previous round's reads are done
    int real = 0;
    if (tid < kBTile && k0 + tid < K) {
      const int id = band_ids[k0 + tid];
      real = id >= 0 && id < Fr - 1;  // the last row is the filler
      if (real) stage_row(src + (size_t)id * kSRow, &tile[tid * kSQuads]);
    }
    // faces come first in a bin, fillers after them: the first n slots
    const int n = __syncthreads_count(real);
    prod = sweep_soft(tile, n, px, py, sigma, prod);
    if (n < kBTile) break;  // uniform over the block
  }
  out[((size_t)b * nb + band) * kBand + tid] = prod;
}

// Add one pixel's share of one staged face's vertex gradient to acc[6].
// gp = g * prod at the pixel, not 0.
__device__ __forceinline__ void grad_face(const float4* __restrict__ r,
                                          float px, float py, float sigma,
                                          float gp, float* acc) {
  bool inside;
  float d;
  Seg seg[3];
  const float p = face_prob(r, px, py, sigma, inside, d, seg);
  if (inside) return;
  const float dLdp = __fdiv_rn(gp, fmaxf(__fsub_rn(1.0f, p), 1e-12f));
  const float dLdd =
      __fmul_rn(__fmul_rn(dLdp, __fdiv_rn(-p, sigma)), r[3].w);
  if (dLdd == 0.0f) return;  // every share would be a zero
  // the whole gradient goes to the first minimal edge k: vertices k, k+1
  const int k = seg[0].d == d ? 0 : (seg[1].d == d ? 1 : (seg[2].d == d ? 2
                                                                       : -1));
  if (k < 0) return;  // a NaN distance equals nothing
  const Seg m = k == 0 ? seg[0] : (k == 1 ? seg[1] : seg[2]);
  const float ca = __fmul_rn(-2.0f, __fsub_rn(1.0f, m.s));
  const float cb = __fmul_rn(-2.0f, m.s);
  const float ax = __fmul_rn(dLdd, __fmul_rn(ca, m.rx));
  const float ay = __fmul_rn(dLdd, __fmul_rn(ca, m.ry));
  const float bx = __fmul_rn(dLdd, __fmul_rn(cb, m.rx));
  const float by = __fmul_rn(dLdd, __fmul_rn(cb, m.ry));
  // k = 0: a = v0, b = v1; k = 1: a = v1, b = v2; k = 2: a = v2, b = v0
  if (k == 0) {
    acc[0] += ax; acc[1] += ay; acc[2] += bx; acc[3] += by;
  } else if (k == 1) {
    acc[2] += ax; acc[3] += ay; acc[4] += bx; acc[5] += by;
  } else {
    acc[4] += ax; acc[5] += ay; acc[0] += bx; acc[1] += by;
  }
}

// Sum acc[kGFaces][6] over the block's threads in a fixed order; threads
// 0 .. 6*nf-1 return their face-major value, the others 0.
__device__ __forceinline__ float block_sum_rows(float (*acc)[6], int nf) {
  __shared__ float red[kGThreads / 32][kGFaces * 6];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int f = 0; f < kGFaces; ++f) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float v = acc[f][c];
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0) red[warp][f * 6 + c] = v;
    }
  }
  __syncthreads();
  float sum = 0.0f;
  if (tid < nf * 6) {
    for (int w = 0; w < kGThreads / 32; ++w) sum += red[w][tid];
  }
  return sum;
}

__global__ void __launch_bounds__(kGThreads)
soft_bwd_dense_kernel(const float* __restrict__ rows,  // (B, F, 16)
                      const float* __restrict__ pix,   // (P, 2)
                      const float* __restrict__ g,     // (B, P) dL/dmask
                      const float* __restrict__ prod,  // (B, P) forward's
                      float* __restrict__ out,         // (B, F, 6)
                      int F, int P, float sigma) {
  __shared__ float4 face[kGFaces * kSQuads];
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kGFaces;
  const int b = blockIdx.y;
  const int nf = min(kGFaces, F - f0);
  if (tid < kGFaces) {
    if (tid < nf) {
      stage_row(rows + ((size_t)b * F + f0 + tid) * kSRow,
                &face[tid * kSQuads]);
    } else {
      stage_zero(&face[tid * kSQuads]);  // valid = 0: no gradient
    }
  }
  __syncthreads();

  float acc[kGFaces][6];
#pragma unroll
  for (int f = 0; f < kGFaces; ++f) {
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[f][c] = 0.0f;
  }
  const float* gb = g + (size_t)b * P;
  const float* pb = prod + (size_t)b * P;
  for (int p = tid; p < P; p += kGThreads) {
    const float gp = __fmul_rn(gb[p], pb[p]);
    if (gp == 0.0f) continue;  // covered pixels (prod = 0) and g = 0
    const float px = pix[2 * p + 0], py = pix[2 * p + 1];
#pragma unroll
    for (int f = 0; f < kGFaces; ++f) {
      grad_face(&face[f * kSQuads], px, py, sigma, gp, acc[f]);
    }
  }
  const float sum = block_sum_rows(acc, nf);
  if (tid < nf * 6) out[((size_t)b * F + f0) * 6 + tid] = sum;
}

__global__ void __launch_bounds__(kGThreads)
soft_bwd_binned_kernel(const float* __restrict__ rows,  // (B, Fr, 16)
                       const int* __restrict__ ids,     // (B, nb, K)
                       const float* __restrict__ pix,   // (P, 2)
                       const float* __restrict__ g,     // (B, nb, 1024)
                       const float* __restrict__ prod,  // (B, nb, 1024)
                       float* __restrict__ out,         // (B, nb, K, 6)
                       int Fr, int nb, int K, int P, float sigma) {
  __shared__ float4 face[kGFaces * kSQuads];
  __shared__ int any_real;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kGFaces;
  const int band = blockIdx.y;
  const int b = blockIdx.z;
  const int nf = min(kGFaces, K - k0);
  const size_t bin = (size_t)b * nb + band;
  if (tid == 0) any_real = 0;
  __syncthreads();
  if (tid < kGFaces) {
    const int id = tid < nf ? ids[bin * K + k0 + tid] : -1;
    if (id >= 0 && id < Fr - 1) {
      stage_row(rows + ((size_t)b * Fr + id) * kSRow, &face[tid * kSQuads]);
      any_real = 1;
    } else {
      stage_zero(&face[tid * kSQuads]);  // filler: valid = 0
    }
  }
  __syncthreads();
  float* dst = out + (bin * K + k0) * 6;
  if (!any_real) {  // a group of fillers: zeros, uniform over the block
    if (tid < nf * 6) dst[tid] = 0.0f;
    return;
  }

  float acc[kGFaces][6];
#pragma unroll
  for (int f = 0; f < kGFaces; ++f) {
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[f][c] = 0.0f;
  }
  const float* gb = g + bin * kBand;
  const float* pb = prod + bin * kBand;
  for (int i = tid; i < kBand; i += kGThreads) {
    const int p = band * kBand + i;
    if (p >= P) break;
    const float gp = __fmul_rn(gb[i], pb[i]);
    if (gp == 0.0f) continue;
    const float px = pix[2 * p + 0], py = pix[2 * p + 1];
#pragma unroll
    for (int f = 0; f < kGFaces; ++f) {
      grad_face(&face[f * kSQuads], px, py, sigma, gp, acc[f]);
    }
  }
  const float sum = block_sum_rows(acc, nf);
  if (tid < nf * 6) dst[tid] = sum;
}

}  // namespace

extern "C" {

// rows (B, F, 16) f32 soft rows; pix (P, 2) f32; out (B, P) f32 prod.
int soft_fwd_dense(const float* rows, const float* pix, float* out, int B,
                   int F, int P, float sigma, void* stream) {
  if (B > 0 && P > 0) {
    const dim3 grid((unsigned)((P + kSPix - 1) / kSPix), (unsigned)B);
    const dim3 block(kSPix, kSSlices);
    soft_fwd_dense_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        rows, pix, out, F, P, sigma);
  }
  return (int)cudaGetLastError();
}

// rows (B, Fr, 16) with the filler row last; ids (B, nb, K) int32, faces
// first, then the filler id Fr-1; out (B, nb, 1024) f32 prod.
int soft_fwd_binned(const float* rows, const int* ids, const float* pix,
                    float* out, int B, int Fr, int nb, int K, int P,
                    float sigma, void* stream) {
  if (B > 0 && nb > 0) {
    const dim3 grid((unsigned)nb, (unsigned)B);
    soft_fwd_binned_kernel<<<grid, kBand, 0, (cudaStream_t)stream>>>(
        rows, ids, pix, out, Fr, nb, K, P, sigma);
  }
  return (int)cudaGetLastError();
}

// g, prod (B, P) f32; out (B, F, 6) f32 vertex gradients.
int soft_bwd_dense(const float* rows, const float* pix, const float* g,
                   const float* prod, float* out, int B, int F, int P,
                   float sigma, void* stream) {
  if (B > 0 && F > 0) {
    const dim3 grid((unsigned)((F + kGFaces - 1) / kGFaces), (unsigned)B);
    soft_bwd_dense_kernel<<<grid, kGThreads, 0, (cudaStream_t)stream>>>(
        rows, pix, g, prod, out, F, P, sigma);
  }
  return (int)cudaGetLastError();
}

// g, prod (B, nb, 1024) f32; out (B, nb, K, 6) f32 rows per (band, slot).
int soft_bwd_binned(const float* rows, const int* ids, const float* pix,
                    const float* g, const float* prod, float* out, int B,
                    int Fr, int nb, int K, int P, float sigma, void* stream) {
  if (B > 0 && nb > 0 && K > 0) {
    if (nb > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((K + kGFaces - 1) / kGFaces), (unsigned)nb,
                    (unsigned)B);
    soft_bwd_binned_kernel<<<grid, kGThreads, 0, (cudaStream_t)stream>>>(
        rows, ids, pix, g, prod, out, Fr, nb, K, P, sigma);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
