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
// e0 = (0, 0, -1) and can never win. The result is the largest (z, -id) in
// lexicographic order over the hits whose z is neither NaN nor -inf: a
// sweep in ascending id with a strict `>` gives it, and so does any split
// of the pairs whose partial results are merged by that same order.
//
// What bounds it on this card: operations, about 25 f32 operations a
// face-pixel pair (four affine forms, three compares, a select), and only
// the pairs whose pixel lies inside the face need them. A face covers a
// pixel or two at 64^2 and a few dozen at 512^2, so the live pairs are
// well under 1 % of all pairs.
//
// Design: a warp owns a tile of 32 pixels (8 x 4 of the image dense, 16 x 2
// of a 512-wide band binned, where the width allows, else 32 in a row) and
// evaluates only the faces that survive an exact edge test against the
// tile's box of pixels, with no margin:
// * The cull. A (tile, face) pair is skipped when one of the face's three
//   edge forms (a, b, c) is < 0 at the box's worst corner,
//   x = (a >= 0 ? xmax : xmin), y = (b >= 0 ? ymax : ymin), evaluated by
//   `affine`, the order of the sweep. Correctly rounded multiply and add are
//   monotone in each argument, so fl(fl(fl(a*px) + fl(b*py)) + c) at any
//   pixel of the box is at most its value at that corner, or NaN; either
//   way that pixel fails the edge and the pair cannot hit. Where the corner
//   gives NaN (inf * 0, inf + -inf, a NaN coefficient) the compare is false
//   and the pair is kept; a corner value of -0.0 equals 0 and is kept; a
//   tile with a NaN pixel gets the whole plane as its box, where every
//   corner is +inf or NaN, and skips nothing. The filler row (0, 0, -1) is
//   -1 at every finite corner: skipped. The box covers the pixels the
//   sweep evaluates: the live ones dense, all 32 binned (the band's padded
//   pixels at (2, 2) included, so that its padded slots equal the sweep's
//   too). A box that holds more pixels (a block's tiles, below) skips fewer
//   pairs and is exact for the same reason. So a skipped pair is never a
//   hit and the culled result equals the all-pairs sweep's bit for bit, on
//   every input.
// * Binned (`select_faces_binned`): a block owns one (batch, band) and
//   gathers the band's K rows through its id list into shared memory by
//   16-byte cp.async (12 KB at K = 256). A slot that holds the last row's
//   id (the filler, which pads every bin's tail) reads one shared copy of
//   that row: copying it once per slot sent most of the card's copies to
//   the same 48 bytes of L2, 9/10 of the kernel's time on an H100. After
//   that one barrier each of the block's 32 warps tests 32 slots at a time
//   against its tile (`__ballot_sync`) and sweeps the surviving slots in
//   slot order with a strict `>`. The result is the winning slot, which
//   the caller maps back to a face id.
// * Dense (`select_faces_dense`), two modes:
//   - few tiles (<= 4 a SM: 64^2), a tile a block
//     (`select_dense_tile_kernel`): warp w of 16 tests the groups of 32
//     faces w, w + 16, ... (a face a lane, read from L2 by `__ldg`, the
//     next group's loads in flight), stages its survivors in id order into
//     its own list and sweeps them with a strict `>`; the 16 partial
//     results merge by (z, -id). One barrier.
//   - many tiles (512^2), NT tiles a block of 16 warps
//     (`select_dense_kernel`), faces in chunks of 1024: each warp tests its
//     2 x 32 rows against the box of all NT tiles, the survivors are
//     compacted across the warps in id order into one list in shared
//     memory, and the G = 16 / NT warps of each tile test the list against
//     their tile, split its survivors by rank (survivor r to warp r mod G)
//     and sweep them in ascending id; the G partial results merge by
//     (z, -id). Three barriers a chunk.
// Exactness: each affine form is a*px + b*py + c evaluated as
// (a*px + b*py) + c with round-to-nearest intrinsics, the order of the plain
// version, so that no FMA contraction moves a pixel that lies exactly on an
// edge (shared edges of a mesh are also exact z ties). This file must not be
// built with --use_fast_math.
//
// The all-pairs designs are kept, only to be timed beside these:
// `select_faces_dense_sweep` (a block of 64 pixels x 4 slices of the face
// list, every pair evaluated, the slices merged in order) and
// `select_faces_binned_sweep` (1024 threads, each sweeping all K slots).
//
// Every launch is on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>

#include "mbarrier.cuh"

namespace {

constexpr int kRow = 12;        // floats per face row
constexpr int kPix = 64;        // dense sweep: pixels per block
constexpr int kSlices = 4;      // dense sweep: face-list slices per block
constexpr int kTile = 64;       // dense sweep: rows staged per slice a round
constexpr int kBand = 1024;     // binned: pixels per band = threads per block
constexpr int kSelWarps = 16;   // dense: warps a block
constexpr int kSelRows = 2;     // dense: rows a lane tests a chunk
constexpr int kSelChunk = kSelWarps * 32 * kSelRows;  // dense: rows a chunk

__device__ __forceinline__ float affine(float a, float b, float c, float px,
                                        float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// One face row (3 float4) with id `id` against one pixel.
__device__ __forceinline__ void hit_test(const float4* __restrict__ row,
                                         int id, float px, float py,
                                         float& bz, int& bi) {
  const float4 a = row[0];  // e0x e0y e0c e1x
  const float4 b = row[1];  // e1y e1c e2x e2y
  const float4 c = row[2];  // e2c zx  zy  zc
  const float w0 = affine(a.x, a.y, a.z, px, py);
  const float w1 = affine(a.w, b.x, b.y, px, py);
  const float w2 = affine(b.z, b.w, c.x, px, py);
  const float z = affine(c.y, c.z, c.w, px, py);
  // a NaN fails every compare: such a face neither hits nor wins
  if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f && z > bz) {
    bz = z;
    bi = id;
  }
}

// Sweep n staged rows (ids id0, id0+1, ...) against one pixel.
__device__ __forceinline__ void sweep(const float4* __restrict__ rows, int n,
                                      int id0, float px, float py, float& bz,
                                      int& bi) {
#pragma unroll 4
  for (int f = 0; f < n; ++f) hit_test(rows + 3 * f, id0 + f, px, py, bz, bi);
}

// ---- warp tiles and their boxes (the selection's and the soft forwards'
// cull) -------------------------------------------------------------------

struct Box {
  float x0, x1, y0, y1;
};

__device__ __forceinline__ Box whole_plane() {
  return Box{-INFINITY, INFINITY, -INFINITY, INFINITY};
}

// The box of the warp's live pixels (empty where none is live; the whole
// plane where one is NaN). kernels/rasterize.py:_soft_tile_boxes is its
// twin.
__device__ __forceinline__ Box tile_box(float px, float py, bool live) {
  Box t{live ? px : INFINITY, live ? px : -INFINITY, live ? py : INFINITY,
        live ? py : -INFINITY};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    t.x0 = fminf(t.x0, __shfl_xor_sync(0xffffffffu, t.x0, off));
    t.x1 = fmaxf(t.x1, __shfl_xor_sync(0xffffffffu, t.x1, off));
    t.y0 = fminf(t.y0, __shfl_xor_sync(0xffffffffu, t.y0, off));
    t.y1 = fmaxf(t.y1, __shfl_xor_sync(0xffffffffu, t.y1, off));
  }
  if (__any_sync(0xffffffffu, live && !(px == px && py == py))) {
    return whole_plane();
  }
  return t;
}

// Pixel of lane `lane` of dense tile `tile`, -1 past the image: 8 x 4
// blocks of an image `width` wide where width > 0, else 32 in a row.
// kernels/rasterize.py:_soft_tile_pixels is its twin.
__device__ __forceinline__ int dense_tile_pixel(int tile, int lane, int P,
                                                int width) {
  int p;
  if (width > 0) {
    const int per_row = width / 8;
    p = ((tile / per_row) * 4 + (lane >> 3)) * width +
        (tile % per_row) * 8 + (lane & 7);
  } else {
    p = tile * 32 + lane;
  }
  return p < P ? p : -1;
}

// Index within its band of lane `lane` of band tile `t`: (32 / R) x R
// blocks of the band's R = 1024 / width rows where width > 0, else 32 in a
// row.
__device__ __forceinline__ int band_tile_pixel(int t, int lane, int width) {
  if (width > 0) {
    const int tw = 32 / (kBand / width);
    return (lane / tw) * width + t * tw + lane % tw;
  }
  return t * 32 + lane;
}

// The dense tiles of P pixels at `width` (see dense_tile_pixel).
__host__ __device__ __forceinline__ long dense_tiles(int P, int width) {
  return width > 0 ? (long)((P / width + 3) / 4) * (width / 8)
                   : (long)(P + 31) / 32;
}

// True where the edge form (a, b, c) is < 0 at the box's worst corner: then
// it is < 0 or NaN at every pixel of the box (see the header).
// kernels/rasterize.py:_sel_kept is its twin.
__device__ __forceinline__ bool edge_out(float a, float b, float c,
                                         const Box& t) {
  return affine(a, b, c, a >= 0.0f ? t.x1 : t.x0, b >= 0.0f ? t.y1 : t.y0) <
         0.0f;
}

// True where one of the row's three edges rules out every pixel of the box.
__device__ __forceinline__ bool face_out(const float4& q0, const float4& q1,
                                         float e2c, const Box& t) {
  return edge_out(q0.x, q0.y, q0.z, t) || edge_out(q0.w, q1.x, q1.y, t) ||
         edge_out(q1.z, q1.w, e2c, t);
}

// ---- the all-pairs designs, timed only ----------------------------------

__global__ void __launch_bounds__(kPix * kSlices)
select_dense_sweep_kernel(const float* __restrict__ rows,  // (B, F, 12)
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
select_binned_sweep_kernel(const float* __restrict__ rows,  // (B, Fr, 12)
                           const int* __restrict__ ids,     // (B, nb, K)
                           const float* __restrict__ pix,   // (P, 2)
                           int* __restrict__ out,           // (B, nb, 1024)
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

// ---- the culled kernels --------------------------------------------------

// Binned: a block a (batch, band), a warp a tile. Dynamic shared memory
// (binned_smem): the band's K rows, the last row of `rows` (the filler's
// id), 3 float4 each, and the K slot ids. Slots holding the last row's id
// point at its one copy: a bin's tail of filler slots would otherwise send
// every band's copies to the same 48 bytes of L2.
__host__ __device__ __forceinline__ size_t binned_smem(int K) {
  return (size_t)(K + 1) * kRow * sizeof(float) + (size_t)K * sizeof(int);
}

__global__ void __launch_bounds__(kBand)
select_binned_kernel(const float* __restrict__ rows,  // (B, Fr, 12)
                     const int* __restrict__ ids,     // (B, nb, K)
                     const float* __restrict__ pix,   // (P, 2)
                     int* __restrict__ out,           // (B, nb, 1024) slots
                     int Fr, int nb, int K, int P, int width) {
  extern __shared__ __align__(16) float4 bin[];
  float4* last_row = bin + 3 * K;
  int* sid = reinterpret_cast<int*>(last_row + 3);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int band = blockIdx.x;
  const int b = blockIdx.y;
  const int* band_ids = ids + ((size_t)b * nb + band) * K;
  const float* src = rows + (size_t)b * Fr * kRow;
  const int last = Fr - 1;
  for (int i = tid; i < K * 3; i += kBand) {
    const int k = i / 3, q = i - 3 * k;
    const int id = band_ids[k];
    if (q == 0) sid[k] = id;
    if (id != last) {
      tpn::cp_async16(tpn::smem_addr(bin + i),
                      src + (size_t)id * kRow + q * 4);
    }
  }
  if (tid < 3 && last >= 0) {
    tpn::cp_async16(tpn::smem_addr(last_row + tid),
                    src + (size_t)last * kRow + tid * 4);
  }
  tpn::cp_async_commit();

  // while the rows land: the lane's pixel and the tile's box, padded
  // pixels at (2, 2) included
  const int local = band_tile_pixel(warp, lane, width);
  const int p = band * kBand + local;
  const float px = p < P ? pix[2 * p + 0] : 2.0f;
  const float py = p < P ? pix[2 * p + 1] : 2.0f;
  const Box tb = tile_box(px, py, true);
  tpn::cp_async_wait<0>();
  __syncthreads();  // every thread's copies and ids are visible

  float bz = -INFINITY;
  int bi = -1;
  for (int h = 0; h < K; h += 32) {
    const int k = h + lane;
    bool keep = false;
    if (k < K) {
      const float4* r = sid[k] == last ? last_row : bin + 3 * k;
      keep = !face_out(r[0], r[1], r[2].x, tb);
    }
    // the survivors in slot order: ascending ids, strict >
    for (unsigned m = __ballot_sync(0xffffffffu, keep); m; m &= m - 1u) {
      const int s = h + __ffs(m) - 1;
      hit_test(sid[s] == last ? last_row : bin + 3 * s, s, px, py, bz, bi);
    }
  }
  out[((size_t)b * nb + band) * kBand + local] = bi;
}

// Dense where the image has few tiles (64^2: 128), a tile a block: warp w
// tests the groups of 32 faces g = w, w + 16, ... against the tile (each
// lane a face, read from L2 with the next group's loads in flight), stages
// the survivors, in id order, into its own 32-row list and sweeps them with
// a strict `>`; the 16 partial results merge by (z, -id).
constexpr int kSelTileWarps = 16;

__global__ void __launch_bounds__(kSelTileWarps * 32)
select_dense_tile_kernel(const float* __restrict__ rows,  // (B, F, 12)
                         const float* __restrict__ pix,   // (P, 2)
                         int* __restrict__ out,           // (B, P)
                         int F, int P, int width) {
  __shared__ float4 list[kSelTileWarps][32 * 3];
  __shared__ float part_z[kSelTileWarps][32];
  __shared__ int part_i[kSelTileWarps][32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int p = dense_tile_pixel(blockIdx.x, lane, P, width);
  const bool live = p >= 0;
  const float px = live ? pix[2 * p + 0] : 2.0f;
  const float py = live ? pix[2 * p + 1] : 2.0f;
  const Box tb = tile_box(px, py, live);
  const float4* src =
      reinterpret_cast<const float4*>(rows + (size_t)b * F * kRow);
  float4* mine = list[warp];

  float4 nxt[3];
  auto load = [&](int g) {
    const int f = g * 32 + lane;
    if (f < F) {
#pragma unroll
      for (int q = 0; q < 3; ++q) nxt[q] = __ldg(src + (size_t)f * 3 + q);
    }
  };
  const int ngroups = (F + 31) / 32;
  if (warp < ngroups) load(warp);
  float bz = -INFINITY;
  int bi = -1;
  for (int g = warp; g < ngroups; g += kSelTileWarps) {
    const float4 c0 = nxt[0], c1 = nxt[1], c2 = nxt[2];
    if (g + kSelTileWarps < ngroups) load(g + kSelTileWarps);
    const int f = g * 32 + lane;
    const bool keep = f < F && !face_out(c0, c1, c2.x, tb);
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int k = __popc(m & ((1u << lane) - 1u));
      mine[3 * k + 0] = c0;
      mine[3 * k + 1] = c1;
      mine[3 * k + 2] = c2;
    }
    __syncwarp();
    for (unsigned r = m, k = 0; r; r &= r - 1u, ++k) {
      hit_test(mine + 3 * k, g * 32 + __ffs(r) - 1, px, py, bz, bi);
    }
    __syncwarp();  // the sweep is done before the next survivors land
  }

  part_z[warp][lane] = bz;
  part_i[warp][lane] = bi;
  __syncthreads();
  if (warp == 0 && live) {
    for (int w = 1; w < kSelTileWarps; ++w) {
      const float z = part_z[w][lane];
      const int i = part_i[w][lane];
      if (z > bz || (z == bz && i < bi)) {
        bz = z;
        bi = i;
      }
    }
    out[(size_t)b * P + p] = bi;
  }
}

// Dense where the image has many tiles (512^2), NT tiles a block of
// kSelWarps warps (NT divides kSelWarps; G = kSelWarps / NT warps a tile).
// Per chunk of kSelChunk faces: each warp tests its 2 x 32 rows against the
// box of all NT tiles; the survivors are compacted across the warps, in id
// order, into one list; then the warps of each tile test the list against
// their tile and split its survivors by rank, each sweeping its share in
// ascending id; the G partial results merge by (z, -id). Dynamic shared
// memory (kSelSmem): the list's rows and ids, the tile boxes, the partial
// results, the warps' counts.
constexpr size_t kSelSmem = (size_t)kSelChunk * 3 * 16 + (size_t)kSelChunk * 4 +
                            (size_t)kSelWarps * 16 +
                            (size_t)kSelWarps * 32 * 8 + (size_t)kSelWarps * 4;

__global__ void __launch_bounds__(kSelWarps * 32)
select_dense_kernel(const float* __restrict__ rows,  // (B, F, 12)
                    const float* __restrict__ pix,   // (P, 2)
                    int* __restrict__ out,           // (B, P)
                    int F, int P, int width, int NT, int ntiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  float4* list = reinterpret_cast<float4*>(smem);       // kSelChunk rows
  int* list_id = reinterpret_cast<int*>(list + kSelChunk * 3);
  float4* boxes = reinterpret_cast<float4*>(list_id + kSelChunk);
  float* part_z = reinterpret_cast<float*>(boxes + kSelWarps);
  int* part_i = reinterpret_cast<int*>(part_z + kSelWarps * 32);
  int* cnt = part_i + kSelWarps * 32;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = kSelWarps / NT;  // warps a tile
  const int t = warp % NT, g = warp / NT;
  const int b = blockIdx.y;
  const int tile = blockIdx.x * NT + t;
  const int p = tile < ntiles ? dense_tile_pixel(tile, lane, P, width) : -1;
  const bool live = p >= 0;
  const float px = live ? pix[2 * p + 0] : 2.0f;
  const float py = live ? pix[2 * p + 1] : 2.0f;
  const Box tb = tile_box(px, py, live);
  if (g == 0 && lane == 0) boxes[t] = make_float4(tb.x0, tb.x1, tb.y0, tb.y1);

  const float4* src =
      reinterpret_cast<const float4*>(rows + (size_t)b * F * kRow);
  const int nchunks = (F + kSelChunk - 1) / kSelChunk;
  // the lane's rows of chunk j: faces j*kSelChunk + warp*64 + r*32 + lane
  float4 cur[kSelRows][3];
  auto load = [&](int j) {
#pragma unroll
    for (int r = 0; r < kSelRows; ++r) {
      const int f = j * kSelChunk + (warp * kSelRows + r) * 32 + lane;
      if (f < F) {
#pragma unroll
        for (int q = 0; q < 3; ++q) cur[r][q] = __ldg(src + (size_t)f * 3 + q);
      }
    }
  };
  if (nchunks > 0) load(0);
  __syncthreads();  // the tile boxes
  Box rb{INFINITY, -INFINITY, INFINITY, -INFINITY};  // the block's box
  for (int s = 0; s < NT; ++s) {
    const float4 q = boxes[s];
    rb.x0 = fminf(rb.x0, q.x);
    rb.x1 = fmaxf(rb.x1, q.y);
    rb.y0 = fminf(rb.y0, q.z);
    rb.y1 = fmaxf(rb.y1, q.w);
  }

  float bz = -INFINITY;
  int bi = -1;
  int rank = 0;  // survivors of the tile so far
  for (int j = 0; j < nchunks; ++j) {
    // 1. the warp's rows against the block's box
    unsigned m[kSelRows];
    int n = 0;
#pragma unroll
    for (int r = 0; r < kSelRows; ++r) {
      const int f = j * kSelChunk + (warp * kSelRows + r) * 32 + lane;
      m[r] = __ballot_sync(0xffffffffu, f < F && !face_out(cur[r][0],
                                                           cur[r][1],
                                                           cur[r][2].x, rb));
      n += __popc(m[r]);
    }
    if (lane == 0) cnt[warp] = n;
    __syncthreads();  // the counts
    // 2. the survivors into the block's list, in id order
    int base = 0, total = 0;
    for (int w = 0; w < kSelWarps; ++w) {
      const int c = cnt[w];
      base += w < warp ? c : 0;
      total += c;
    }
#pragma unroll
    for (int r = 0; r < kSelRows; ++r) {
      if ((m[r] >> lane) & 1u) {
        const int k = base + __popc(m[r] & ((1u << lane) - 1u));
        list[3 * k + 0] = cur[r][0];
        list[3 * k + 1] = cur[r][1];
        list[3 * k + 2] = cur[r][2];
        list_id[k] = j * kSelChunk + (warp * kSelRows + r) * 32 + lane;
      }
      base += __popc(m[r]);
    }
    __syncthreads();  // the list is complete
    if (j + 1 < nchunks) load(j + 1);  // in flight while the list is swept
    // 3. the list against the tile; survivor r of the tile to warp r mod G
    // of its group, each sweeping ascending ids
    for (int s = 0; s < total; s += 32) {
      const int k = s + lane;
      const bool keep =
          k < total && !face_out(list[3 * k], list[3 * k + 1],
                                 list[3 * k + 2].x, tb);
      for (unsigned mm = __ballot_sync(0xffffffffu, keep); mm;
           mm &= mm - 1u, ++rank) {
        if ((rank & (G - 1)) == g) {
          const int e = s + __ffs(mm) - 1;
          hit_test(list + 3 * e, list_id[e], px, py, bz, bi);
        }
      }
    }
    __syncthreads();  // the list is free for the next chunk
  }

  // the tile's G partial results, merged by (z, -id)
  part_z[warp * 32 + lane] = bz;
  part_i[warp * 32 + lane] = bi;
  __syncthreads();
  if (g == 0 && live) {
    for (int h = 1; h < G; ++h) {
      const float z = part_z[(h * NT + t) * 32 + lane];
      const int i = part_i[(h * NT + t) * 32 + lane];
      if (z > bz || (z == bz && i < bi)) {
        bz = z;
        bi = i;
      }
    }
    out[(size_t)b * P + p] = bi;
  }
}

}  // namespace

extern "C" {

// Raises the dynamic shared memory `kernel` may take to `bytes`, once per
// size (`opened` keeps the largest so far).
static cudaError_t open_smem(const void* kernel, size_t bytes, int* opened) {
  if (bytes <= 48 * 1024 || (int)bytes <= *opened) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *opened = (int)bytes;
  return err;
}

static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess) {
      sms = 132;
    }
  }
  return sms;
}

// rows (B, F, 12) f32 face rows, 16-byte aligned; pix (P, 2) f32 NDC pixel
// centres; out (B, P) int32 winning face id or -1. width: the image's width
// where it is a multiple of 8 that divides P (8 x 4 tiles), else 0 (32
// pixels in a row).
int select_faces_dense(const float* rows, const float* pix, int* out, int B,
                       int F, int P, int width, void* stream) {
  static int opened = 0;
  if (B > 0 && P > 0) {
    if (B > 65535) return (int)cudaErrorInvalidValue;
    const long tiles = dense_tiles(P, width);
    const long sms = sm_count();
    if (B * tiles <= 4 * sms) {  // few tiles: a tile a block
      const dim3 grid((unsigned)tiles, (unsigned)B);
      select_dense_tile_kernel<<<grid, kSelTileWarps * 32, 0,
                                 (cudaStream_t)stream>>>(rows, pix, out, F,
                                                         P, width);
      return (int)cudaGetLastError();
    }
    // more tiles a block while the blocks still cover the SMs
    int NT = 1;
    while (2 * NT <= kSelWarps && B * ((tiles + 2 * NT - 1) / (2 * NT)) >= sms) {
      NT *= 2;
    }
    const cudaError_t err =
        open_smem((const void*)select_dense_kernel, kSelSmem, &opened);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((tiles + NT - 1) / NT), (unsigned)B);
    select_dense_kernel<<<grid, kSelWarps * 32, kSelSmem,
                          (cudaStream_t)stream>>>(rows, pix, out, F, P, width,
                                                  NT, (int)tiles);
  }
  return (int)cudaGetLastError();
}

// rows (B, Fr, 12) f32 face rows (the last one the never-wins filler),
// 16-byte aligned; ids (B, nb, K) int32 row index per bin slot; pix (P, 2)
// f32; out (B, nb, 1024) int32 winning slot or -1. width: the image's width
// where 1024 / width rows make tiles of 32 (width 32 ... 1024, dividing P),
// else 0.
int select_faces_binned(const float* rows, const int* ids, const float* pix,
                        int* out, int B, int Fr, int nb, int K, int P,
                        int width, void* stream) {
  static int opened = 0;
  const size_t smem = binned_smem(K);
  const cudaError_t err =
      open_smem((const void*)select_binned_kernel, smem, &opened);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && nb > 0) {
    if (B > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)nb, (unsigned)B);
    select_binned_kernel<<<grid, kBand, smem, (cudaStream_t)stream>>>(
        rows, ids, pix, out, Fr, nb, K, P, width);
  }
  return (int)cudaGetLastError();
}

// The all-pairs designs of the two above, with their contracts (no
// width); kept only to be timed beside them.
int select_faces_dense_sweep(const float* rows, const float* pix, int* out,
                             int B, int F, int P, void* stream) {
  if (B > 0 && P > 0) {
    const dim3 grid((unsigned)((P + kPix - 1) / kPix), (unsigned)B);
    const dim3 block(kPix, kSlices);
    select_dense_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        rows, pix, out, F, P);
  }
  return (int)cudaGetLastError();
}

int select_faces_binned_sweep(const float* rows, const int* ids,
                              const float* pix, int* out, int B, int Fr,
                              int nb, int K, int P, void* stream) {
  static int opened = 0;
  const size_t smem = (size_t)K * kRow * sizeof(float);
  const cudaError_t err =
      open_smem((const void*)select_binned_sweep_kernel, smem, &opened);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && nb > 0) {
    const dim3 grid((unsigned)nb, (unsigned)B);
    select_binned_sweep_kernel<<<grid, kBand, smem, (cudaStream_t)stream>>>(
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
//   + soft_bwd_dense_tiles, its first pass          _soft_grad_rows)
//   soft_bwd_binned  <- _soft_bwd_binned          (_soft_bwd_binned_kernel)
//   + soft_bwd_faces    and the segment_sum to faces in _soft_batched_vjp_bwd
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
// and 8 to 16 bytes a pixel. Only the pairs with 1 - p != 1.0f need that
// work: farther than m = sqrt(27.7 sigma) from a face, p < 1e-12 and its
// factor rounds to exactly 1.0f (kernels/rasterize.py:_SOFT_TAIL). At
// sigma = 1e-4 that is 1.7 pixels at 64^2 and 13.5 at 512^2, so the live
// pairs are a few per cent of all pairs. All on the CUDA cores' f32 rate.
//
// Design.
// * A row is staged into shared memory once per block with the three
//   1/max(|edge|^2, 1e-10) appended (they depend on the face alone), and read
//   from there as broadcasts.
// * Forward, the cull (both kernels). A warp owns a tile of 32 pixels: an
//   8 x 4 block of the image (dense) or a 16 x 2 block of a 512-wide band
//   (binned), where the image's width allows, else 32 pixels in a row. A
//   face's box is the min and max of its vertices widened by m; a tile's
//   box is the min and max over its live pixels. A (face, tile) pair is
//   skipped only when the tile's box lies wholly outside the face's: then
//   every pixel of the tile is farther than m from the face, and each of
//   its factors is exactly 1.0f. A face with a non-finite vertex gets the
//   whole plane as its box and is never skipped; it makes the product NaN,
//   as its NaN distances make it in the plain version (face_prob's fminf
//   would drop them; the all-pairs designs give a finite value there). A tile
//   with a NaN pixel skips nothing. The warp tests 32 staged rows at
//   a time (`__ballot_sync`), stages the hits, in face order, into its own
//   compacted list in shared memory and sweeps only those. Multiplying by
//   1.0f is exact, so for faces with finite vertices the culled sweep
//   equals the unculled one in the same order bit for bit. A sliver (sin
//   of its smallest angle under ~1e-3) is never skipped: the rounding of
//   its edge forms can call a pixel far beyond its tip inside (p = 1,
//   factor 0), there as in the plain version (`sliver`).
// * Forward, dense (`soft_fwd_dense`). The product keeps the order of the
//   all-pairs sweep: the face list cut into 8 slices, each slice's factors
//   multiplied in face order, the 8 partial products in slice order. So
//   the result equals `soft_fwd_dense_sweep`'s bit for bit (finite faces).
//   Face ids are contiguous latitude rings of the mesh, so one slice holds
//   most of a tile's hits (64^2, wide camera: 250 of 262), and a warp a
//   (tile, slice) waits on that one warp. Two modes:
//   - few tiles (<= 4 a SM: 64^2), a tile a block
//     (`soft_fwd_dense_tile_kernel`): 16 warps test a chunk of 512 rows,
//     compact the hits in face order across warps, evaluate every 16th
//     hit's factor each into shared memory, and warp 0 multiplies them in
//     the sweep's order. Rows stream by cp.async.bulk into 2 chunks on
//     mbarriers: the next chunk lands while this one is swept.
//   - many tiles (512^2), NT tiles a block (`soft_fwd_dense_kernel`), a
//     warp a tile sweeping all 8 slices in order. The block streams the
//     rows, (B, F, 16) contiguous, 64 bytes a face, in chunks of 64 by
//     cp.async.bulk into a ring of 2 on mbarriers, shared by its NT tiles.
// * Forward, binned (`soft_fwd_binned`). A block owns one (view, band) of
//   1024 pixels, 32 warps, one tile each, and gathers the band's rows
//   through its id list in rounds of 128 slots with 16-byte cp.async into
//   a double buffer: round r + 1's gather is in flight while round r is
//   swept. The (B, nb, K, 16) table is never materialised. Bins hold their
//   faces first and fillers after them, so the sweep ends at the first
//   filler. The result equals `soft_fwd_binned_sweep`'s bit for bit
//   (finite faces). (Spreading a band's (tile, slot) pairs over its warps
//   to even out the tiles' loads measured slower: the barriers cost more.)
// * The all-pairs designs, `soft_fwd_dense_sweep` (a block of 32 pixels x 8
//   slices, every pair evaluated, rows staged synchronously) and
//   `soft_fwd_binned_sweep` (1024 threads sweep every filled slot), are kept
//   only to be timed beside the new kernels; no path calls them.
// * Backward, dense (`soft_bwd_dense`, after the small first pass
//   `soft_bwd_dense_tiles`). The same warp tiles as soft_fwd_dense and the
//   binned backward's cull: a pixel is live where g*prod != 0, a tile's box
//   is the box of its live pixels, a (face, tile) pair is skipped where the
//   tile's box lies wholly outside the face's widened vertex box, and a
//   tile with no live pixel is skipped whole. The first pass, once per
//   view, lists the live tiles with their boxes in tile order, in segments
//   of 256 tiles with each segment's count and box, so that no later block
//   reads g and prod whole and a block skips the segments far from its
//   faces.
//   A block then owns 32 faces of one view, staged once with their boxes
//   and the box around all of them, and walks the live tiles in order: a
//   tile that meets the chunk's box is tested against the 32 faces by one
//   `__ballot_sync`; the kept (tile, face) pairs of up to 32 tiles are
//   listed and shared over the block's 8 warps; a warp forms a pair's 32
//   lane shares and sums them (warp_sum8); thread (face, component) adds
//   the pairs' sums of its face in tile order and writes its sum once.
//   No atomics, no second kernel: two calls give the same bits. A face
//   with a non-finite vertex gets NaN, as the plain version's NaN shares
//   make it.
// * The first dense design (`soft_bwd_dense_sweep`, kept only to be timed):
//   a block owns 8 faces; its 256 threads stride every pixel with 48 sums in
//   registers (255 registers with spills), then reduce by warp shuffles and
//   through shared memory in a fixed order. Pixels with g*prod == 0 are
//   skipped, which also keeps 0/0 out. The first binned design
//   (`soft_bwd_binned_sweep`, kept only to be timed) is the same over 8
//   slots of one band, one row per (band, slot), and its caller sums the
//   rows to faces by index_add_.
// * Backward, binned (`soft_bwd_binned`, then `soft_bwd_faces`). A pixel is
//   live where g*prod != 0; the cotangent of a silhouette loss is non-zero
//   only near the rim, and prod is exactly 0 inside it. Two blocks of 16
//   warps own one (view, band), each half its tiles of 32 pixels (as in
//   soft_fwd_binned), two blocks an SM; a tile with no live pixel skips
//   every slot, a half with none its rows. The cull is the forward's with
//   the box of the tile's live
//   pixels: a skipped pair's pixels are all farther than m from the face,
//   where p < e^-27.7 and each share is at most
//   |g*prod| * 2 e^-27.7 m / sigma (about 1e-9 |g*prod| at sigma = 1e-4):
//   the tail the bins already drop between bands. A face with a non-finite
//   vertex gets the whole plane as its box, and its sum is NaN, as in the
//   plain version. A rim tile keeps tens of faces and a far one none, so
//   the kept (tile, slot) pairs of a round are listed and shared out over
//   the block's warps. A pair's lane shares are summed over the warp, the
//   tiles' sums over each slot's tiles in tile order, the halves' rows of a
//   slot half 0 + half 1, the slots' rows over each face's bands in band
//   order by `soft_bwd_faces` (a warp a face, a lane a
//   band, from each face's slot in each band and its span of bands, which
//   the first kernel records). Every order is fixed, so two calls give the
//   same bits; the bins' filler slots take no part in any sum.
// * Backward divides forward's prod by 1 - p, so both must get the same bits
//   for p: the arithmetic up to expf is spelled with round-to-nearest
//   intrinsics in one device function, which leaves the compiler no choice of
//   contraction in either kernel. It is also the plain version's order of
//   operations. This file must not be built with --use_fast_math.
// ===========================================================================

namespace {

constexpr int kSRow = 16;     // floats per soft row
constexpr float kSliver = 9.765625e-4f;  // 2^-10: face_box's sliver test
constexpr int kSQuads = 5;    // float4 per staged row: 16 + 3 inverses + pad
constexpr int kSPix = 32;     // dense sweep: pixels per block, one warp
constexpr int kSSlices = 8;   // dense forward: slices of the face list
constexpr int kBTile = 128;   // binned forward: slots staged per round
constexpr int kChunk = 64;    // dense forward: rows a bulk copy
constexpr int kStages = 2;    // dense forward: chunks in flight a block
constexpr int kDWarps = 16;   // dense forward: most warps a block
constexpr int kTWarps = 16;   // dense forward, a tile a block: warps
constexpr int kTChunk = kTWarps * 32;  // ... and rows a bulk copy
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
soft_fwd_dense_sweep_kernel(const float* __restrict__ rows,  // (B, F, 16)
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
soft_fwd_binned_sweep_kernel(const float* __restrict__ rows,  // (B, Fr, 16)
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

// ---- the cull (soft_fwd_dense, soft_fwd_binned) -------------------------

__device__ __forceinline__ bool finite_vertices(
    const float* __restrict__ row) {
  const float4 c = reinterpret_cast<const float4*>(row)[2];  // e2c v0 v1x
  const float4 d = reinterpret_cast<const float4*>(row)[3];  // v1y v2 valid
  return isfinite(c.y) && isfinite(c.z) && isfinite(c.w) && isfinite(d.x) &&
         isfinite(d.y) && isfinite(d.z);
}

// A sliver: |n0 x n1| < 2^-10 max_k |n_k|^2 over the row's edge normals
// n_k (twice the area against the longest edge squared; sin of the
// smallest angle under ~1e-3), or a NaN there. Its rounded inside test can
// hold at pixels far beyond its tip, so the cull keeps it everywhere.
// Products and sums rounded one by one, as the twin rounds them; a
// degenerate row (normals 0) is no sliver: it never tests inside.
__device__ __forceinline__ bool sliver(const float* __restrict__ row) {
  const float4 a = reinterpret_cast<const float4*>(row)[0];  // e0 e1x
  const float4 b = reinterpret_cast<const float4*>(row)[1];  // e1y e1c e2xy
  const float cross = __fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, a.w));
  const float l0 = __fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y));
  const float l1 = __fadd_rn(__fmul_rn(a.w, a.w), __fmul_rn(b.x, b.x));
  const float l2 = __fadd_rn(__fmul_rn(b.z, b.z), __fmul_rn(b.w, b.w));
  return !(fabsf(cross) >= __fmul_rn(kSliver, fmaxf(fmaxf(l0, l1), l2)));
}

// The box of a raw 16-float row's three vertices, widened by m; the whole
// plane for a face with a non-finite vertex coordinate and for a sliver.
// kernels/rasterize.py:_soft_cull_boxes is its twin.
__device__ __forceinline__ Box face_box(const float* __restrict__ row,
                                        float m) {
  if (!finite_vertices(row) || sliver(row)) return whole_plane();
  const float4 c = reinterpret_cast<const float4*>(row)[2];
  const float4 d = reinterpret_cast<const float4*>(row)[3];
  Box b;
  b.x0 = __fsub_rn(fminf(fminf(c.y, c.w), d.y), m);
  b.x1 = __fadd_rn(fmaxf(fmaxf(c.y, c.w), d.y), m);
  b.y0 = __fsub_rn(fminf(fminf(c.z, d.x), d.z), m);
  b.y1 = __fadd_rn(fmaxf(fmaxf(c.z, d.x), d.z), m);
  return b;
}

// Written so that a NaN compare never skips.
__device__ __forceinline__ bool outside(const Box& f, const Box& t) {
  return t.x1 < f.x0 || t.x0 > f.x1 || t.y1 < f.y0 || t.y0 > f.y1;
}

// Multiply into `prod` the factors of raw rows [0, n) (16 floats each, in
// shared memory) at the lane's pixel, in row order, skipping the rows whose
// box the tile lies outside: 32 rows a ballot, the hits staged, compacted
// in order, into the warp's own list `hits` (32 x kSQuads float4). A face
// with a non-finite vertex makes the product NaN: its distances are NaN in
// the plain version, so its p is NaN at every pixel there, where
// face_prob's fminf would drop the NaN and give a finite p.
__device__ __forceinline__ float cull_sweep(const float* __restrict__ raw,
                                            int n, const Box& tb, float m,
                                            float4* __restrict__ hits,
                                            float px, float py, float sigma,
                                            float prod) {
  const int lane = threadIdx.x & 31;
  for (int h = 0; h < n; h += 32) {
    const int i = h + lane;
    const bool bad = i < n && !finite_vertices(raw + i * kSRow);
    const bool hit = i < n && !outside(face_box(raw + i * kSRow, m), tb);
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (hit) {
      stage_row(raw + i * kSRow,
                hits + __popc(mask & ((1u << lane) - 1u)) * kSQuads);
    }
    __syncwarp();
    prod = sweep_soft(hits, __popc(mask), px, py, sigma, prod);
    if (__any_sync(0xffffffffu, bad)) prod = __int_as_float(0x7fc00000);
    __syncwarp();  // the sweep is done before the next hits are staged
  }
  return prod;
}

// Dense forward where the image has many tiles, NT tiles a block: each
// warp sweeps all 8 slices for its tile, the block sharing each chunk of
// rows. Dynamic shared memory: kStages barriers (128 bytes reserved),
// kStages chunks of kChunk raw rows, a 32-row hit list a warp.
__global__ void __launch_bounds__(kDWarps * 32)
soft_fwd_dense_kernel(const float* __restrict__ rows,  // (B, F, 16)
                      const float* __restrict__ pix,   // (P, 2)
                      float* __restrict__ out,         // (B, P) prod
                      int F, int P, int width, float sigma, float m) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* raw = reinterpret_cast<float*>(smem + 128);
  float4* hits_all =
      reinterpret_cast<float4*>(raw + kStages * kChunk * kSRow);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NT = blockDim.x >> 5;
  const int b = blockIdx.y;
  const int p = dense_tile_pixel(blockIdx.x * NT + warp, lane, P, width);
  const bool live = p >= 0;
  // pixels past the image sit far outside NDC: expf underflows to 0
  const float px = live ? pix[2 * p + 0] : 5.0f;
  const float py = live ? pix[2 * p + 1] : 5.0f;
  const Box tb = tile_box(px, py, live);
  const float* src = rows + (size_t)b * F * kSRow;
  float4* hits = hits_all + warp * 32 * kSQuads;

  const int per_slice = (F + kSSlices - 1) / kSSlices;
  const int cps = max(1, (per_slice + kChunk - 1) / kChunk);  // chunks a slice
  const int nchunks = kSSlices * cps;
  const bool producer = threadIdx.x == 0;

  // chunk j: n rows of slice j / cps from row `first`
  auto chunk_rows = [&](int j, int& first) {
    const int lo = (j / cps) * per_slice;
    const int hi = min(F, lo + per_slice);
    first = lo + (j % cps) * kChunk;
    return max(0, min(kChunk, hi - first));
  };
  auto issue = [&](int j) {
    int first;
    const int n = chunk_rows(j, first);
    const int slot = j % kStages;
    const uint32_t bar = tpn::smem_addr(bars + slot);
    tpn::mbar_expect_tx(bar, (uint32_t)n * kSRow * 4);
    if (n > 0) {
      tpn::bulk_g2s(tpn::smem_addr(raw + slot * kChunk * kSRow),
                    src + (size_t)first * kSRow, (uint32_t)n * kSRow * 4,
                    bar);
    }
  };

  if (producer) {
    for (int st = 0; st < kStages; ++st) {
      tpn::mbar_init(tpn::smem_addr(bars + st), 1);
    }
  }
  __syncthreads();
  if (producer) {
    for (int j = 0; j < min(kStages, nchunks); ++j) issue(j);
  }

  // the all-pairs sweep's order: each slice from 1.0f, the slices in order
  float total = 1.0f, prod = 1.0f;
  for (int j = 0; j < nchunks; ++j) {
    int first;
    const int n = chunk_rows(j, first);
    const int slot = j % kStages;
    tpn::mbar_wait(tpn::smem_addr(bars + slot), (uint32_t)(j / kStages) & 1u);
    prod = cull_sweep(raw + slot * kChunk * kSRow, n, tb, m, hits, px, py,
                      sigma, prod);
    if ((j + 1) % cps == 0) {  // the end of a slice
      total = __fmul_rn(total, prod);
      prod = 1.0f;
    }
    __syncthreads();  // the block is done with the slot
    if (producer && j + kStages < nchunks) {
      tpn::fence_proxy_async_smem();
      issue(j + kStages);
    }
  }
  if (live) out[(size_t)b * P + p] = total;
}

// Dense forward where the image has few tiles (64^2: 128), one tile a
// block: the 16 warps test 32 rows each of a chunk of 512, the hits are
// compacted in face order across the warps, every warp stages and
// evaluates every 16th hit's factor 1 - p into shared memory, and warp 0
// multiplies the factors in face order into the 8 slices' partial
// products and those in slice order: the all-pairs sweep's arithmetic, bit for
// bit, with the hits of a tile spread evenly over its 16 warps. Dynamic
// shared memory: 2 barriers (128 bytes reserved), 2 chunks of raw rows,
// the staged hits, their factors, their rows and the warps' hit counts.
constexpr size_t kTileSmem =
    128 + 2 * (size_t)kTChunk * kSRow * 4 + (size_t)kTChunk * kSQuads * 16 +
    (size_t)kTChunk * 32 * 4 + (size_t)kTChunk * 4 + 2 * kTWarps * 4;

__global__ void __launch_bounds__(kTWarps * 32)
soft_fwd_dense_tile_kernel(const float* __restrict__ rows,  // (B, F, 16)
                           const float* __restrict__ pix,   // (P, 2)
                           float* __restrict__ out,         // (B, P) prod
                           int F, int P, int width, float sigma, float m) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* raw = reinterpret_cast<float*>(smem + 128);
  float4* conv = reinterpret_cast<float4*>(raw + 2 * kTChunk * kSRow);
  float* fac = reinterpret_cast<float*>(conv + kTChunk * kSQuads);
  int* hit_row = reinterpret_cast<int*>(fac + kTChunk * 32);
  int* cnt = hit_row + kTChunk;   // hits of each warp
  int* bad_w = cnt + kTWarps;     // non-finite faces of each warp

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int p = dense_tile_pixel(blockIdx.x, lane, P, width);
  const bool live = p >= 0;
  const float px = live ? pix[2 * p + 0] : 5.0f;
  const float py = live ? pix[2 * p + 1] : 5.0f;
  const Box tb = tile_box(px, py, live);
  const float* src = rows + (size_t)b * F * kSRow;
  const int per_slice = (F + kSSlices - 1) / kSSlices;
  const int nchunks = (F + kTChunk - 1) / kTChunk;
  const bool producer = threadIdx.x == 0;

  auto issue = [&](int j) {
    const int n = min(kTChunk, F - j * kTChunk);
    const uint32_t bar = tpn::smem_addr(bars + (j & 1));
    tpn::mbar_expect_tx(bar, (uint32_t)n * kSRow * 4);
    tpn::bulk_g2s(tpn::smem_addr(raw + (j & 1) * kTChunk * kSRow),
                  src + (size_t)j * kTChunk * kSRow, (uint32_t)n * kSRow * 4,
                  bar);
  };
  if (producer) {
    tpn::mbar_init(tpn::smem_addr(bars + 0), 1);
    tpn::mbar_init(tpn::smem_addr(bars + 1), 1);
  }
  __syncthreads();
  if (producer) {
    for (int j = 0; j < min(2, nchunks); ++j) issue(j);
  }

  float total = 1.0f, part = 1.0f;  // warp 0: finished slices, this slice
  int slice = 0;
  bool nan = false;
  for (int j = 0; j < nchunks; ++j) {
    const int first = j * kTChunk;
    const int n = min(kTChunk, F - first);
    const float* rc = raw + (j & 1) * kTChunk * kSRow;
    tpn::mbar_wait(tpn::smem_addr(bars + (j & 1)), (uint32_t)(j >> 1) & 1u);
    const int i = warp * 32 + lane;
    const bool bad = i < n && !finite_vertices(rc + i * kSRow);
    const bool hit = i < n && !outside(face_box(rc + i * kSRow, m), tb);
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    const unsigned bmask = __ballot_sync(0xffffffffu, bad);
    if (lane == 0) {
      cnt[warp] = __popc(mask);
      bad_w[warp] = bmask != 0u;
    }
    __syncthreads();
    int base = 0, nh = 0;
    for (int w = 0; w < kTWarps; ++w) {
      base += w < warp ? cnt[w] : 0;
      nh += cnt[w];
      nan |= bad_w[w] != 0;
    }
    if (hit) {
      const int k = base + __popc(mask & ((1u << lane) - 1u));
      hit_row[k] = first + i;
      stage_row(rc + i * kSRow, conv + k * kSQuads);
    }
    __syncthreads();  // hits staged; the raw chunk is free
    if (producer && j + 2 < nchunks) {
      tpn::fence_proxy_async_smem();
      issue(j + 2);
    }
#pragma unroll 2
    for (int k = warp; k < nh; k += kTWarps) {
      bool inside;
      float d;
      Seg seg[3];
      const float q = face_prob(conv + k * kSQuads, px, py, sigma, inside, d,
                                seg);
      fac[k * 32 + lane] = __fsub_rn(1.0f, q);
    }
    __syncthreads();
    if (warp == 0) {
      for (int k = 0; k < nh; ++k) {
        const int s = hit_row[k] / per_slice;
        if (s != slice) {  // the slices between have no hit: factors 1
          total = __fmul_rn(total, part);
          part = 1.0f;
          slice = s;
        }
        part = __fmul_rn(part, fac[k * 32 + lane]);
      }
    }
    // the next chunk's first barrier orders this read before its writes
  }
  if (warp == 0 && live) {
    out[(size_t)b * P + p] =
        nan ? __int_as_float(0x7fc00000) : __fmul_rn(total, part);
  }
}

constexpr size_t kBRaw = (size_t)kBTile * kSRow * sizeof(float);
constexpr size_t kBinnedSmem =
    2 * kBRaw + (size_t)(kBand / 32) * 32 * kSQuads * sizeof(float4);

// Round r of a band's bin into buffer r & 1 of `raw` (two rounds of kBTile
// raw rows), thread t of the first kBTile * 4 copying quarter t % 4 of slot
// t / 4 by 16-byte cp.async; returns the round's real slots (faces, not
// fillers: the last of the Fr rows). Its barrier also orders round r - 2's
// reads of that buffer before the copy.
__device__ __forceinline__ int gather_round(const int* __restrict__ band_ids,
                                            const float* __restrict__ src,
                                            float* raw, int r, int K,
                                            int Fr) {
  const int tid = threadIdx.x;
  const int k = r * kBTile + (tid >> 2);
  int id = -1;
  if (tid < kBTile * 4 && k < K) id = band_ids[k];
  const bool real = id >= 0 && id < Fr - 1;
  const int n = __syncthreads_count(real && (tid & 3) == 0);
  if (real) {
    tpn::cp_async16(tpn::smem_addr(raw + ((r & 1) * kBTile + (tid >> 2)) *
                                             kSRow + (tid & 3) * 4),
                    src + (size_t)id * kSRow + (tid & 3) * 4);
  }
  tpn::cp_async_commit();
  return n;
}

// Binned forward. Dynamic shared memory: two rounds of kBTile raw rows, a
// 32-row hit list a warp.
__global__ void __launch_bounds__(kBand, 1)
soft_fwd_binned_kernel(const float* __restrict__ rows,  // (B, Fr, 16)
                       const int* __restrict__ ids,     // (B, nb, K)
                       const float* __restrict__ pix,   // (P, 2)
                       float* __restrict__ out,         // (B, nb, 1024) prod
                       int Fr, int nb, int K, int P, int width, float sigma,
                       float m) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float4* hits = reinterpret_cast<float4*>(smem + 2 * kBRaw) +
                 warp * 32 * kSQuads;
  const int band = blockIdx.x;
  const int b = blockIdx.y;
  const int* band_ids = ids + ((size_t)b * nb + band) * K;
  const float* src = rows + (size_t)b * Fr * kSRow;

  const int local = band_tile_pixel(warp, lane, width);
  const int p = band * kBand + local;
  const bool live = p < P;
  const float px = live ? pix[2 * p + 0] : 5.0f;
  const float py = live ? pix[2 * p + 1] : 5.0f;
  const Box tb = tile_box(px, py, live);

  auto gather = [&](int r) {
    return gather_round(band_ids, src, raw, r, K, Fr);
  };

  float prod = 1.0f;
  int n_next = gather(0);
  for (int r = 0;; ++r) {
    // faces come first in a bin, fillers after them: the first n slots
    const int n = n_next;
    const bool more = n == kBTile && (r + 1) * kBTile < K;  // uniform
    if (more) {
      n_next = gather(r + 1);
      tpn::cp_async_wait<1>();
    } else {
      tpn::cp_async_wait<0>();
    }
    __syncthreads();  // round r's rows, copied by every thread, are visible
    prod = cull_sweep(raw + (r & 1) * kBTile * kSRow, n, tb, m, hits, px, py,
                      sigma, prod);
    if (!more) break;
  }
  out[((size_t)b * nb + band) * kBand + local] = prod;
}

// Add one pixel's share of one staged face's vertex gradient to acc[6];
// false where the share is all zero and nothing was added. gp = g * prod at
// the pixel, not 0.
__device__ __forceinline__ bool grad_face(const float4* __restrict__ r,
                                          float px, float py, float sigma,
                                          float gp, float* acc) {
  bool inside;
  float d;
  Seg seg[3];
  const float p = face_prob(r, px, py, sigma, inside, d, seg);
  if (inside) return false;
  const float dLdp = __fdiv_rn(gp, fmaxf(__fsub_rn(1.0f, p), 1e-12f));
  const float dLdd =
      __fmul_rn(__fmul_rn(dLdp, __fdiv_rn(-p, sigma)), r[3].w);
  if (dLdd == 0.0f) return false;  // every share would be a zero
  // the whole gradient goes to the first minimal edge k: vertices k, k+1
  const int k = seg[0].d == d ? 0 : (seg[1].d == d ? 1 : (seg[2].d == d ? 2
                                                                       : -1));
  if (k < 0) return false;  // a NaN distance equals nothing
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
  return true;
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
soft_bwd_dense_sweep_kernel(const float* __restrict__ rows,  // (B, F, 16)
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
soft_bwd_binned_sweep_kernel(const float* __restrict__ rows,  // (B, Fr, 16)
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

// ---- the binned backward, culled (soft_bwd_binned, soft_bwd_faces) -------

constexpr int kRHalves = 2;            // binned backward: blocks a band
constexpr int kRWarps = kBand / 32 / kRHalves;  // ... tiles (warps) a block
constexpr int kRQuads = kSQuads + 1;   // ... a staged row and its cull box
constexpr int kRGroups = kBTile / 32;  // ... ballots of 32 slots a round
constexpr int kRPairs = kRWarps * kBTile;  // ... (tile, slot) pairs a round
constexpr int kSumWarps = 8;           // face sum: faces (warps) a block
constexpr size_t kBwdSmem =
    2 * kBRaw                                        // raw rows, 2 rounds
    + (size_t)kBTile * kRQuads * sizeof(float4)      // staged rows, boxes
    + (size_t)kRPairs * 6 * sizeof(float)            // the pairs' sums
    + (size_t)kRWarps * 32 * sizeof(float4)          // the tiles' pixels
    + (size_t)kRPairs * sizeof(unsigned short)       // the kept pairs
    + (size_t)kRPairs / 32 * sizeof(unsigned)        // their ballots
    + (size_t)kBTile * sizeof(unsigned)              // each slot's tiles
    + 4 * sizeof(int);                               // the ballots' counts

// Sum v[0..7] over the warp in a fixed butterfly that halves the values a
// lane keeps at each of the first three steps (9 shuffles where a plain
// tree over 6 values takes 30): lane 4q ends with component q in v[0].
__device__ __forceinline__ void warp_sum8(float (&v)[8], int lane) {
#pragma unroll
  for (int half = 4, off = 16; half >= 1; half >>= 1, off >>= 1) {
    const bool hi = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = hi ? v[i] : v[i + half];
      const float keep = hi ? v[i + half] : v[i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, off));
    }
  }
  v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], 2));
  v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], 1));
}

// Binned backward: two blocks a (view, band), each of 16 warps owning half
// the band's 32 tiles of 32 pixels (band_tile_pixel, as soft_fwd_binned),
// so that two blocks share an SM and one's gather, barriers and sums hide
// behind the other's work. A pixel is live where g*prod != 0. First every
// slot that holds a face puts the band into its face's span (first, last:
// integer min and max, the same in any order) and its slot into
// slot_of[face][band] (the two halves split the slots); a half with no
// live pixel stops there. Rows are gathered through the id list in rounds of kBTile slots by
// 16-byte cp.async into a double buffer, staged once a round with their
// cull boxes, and the sweep stops at the first filler. A round:
// * warp t tests the round's slots, 32 a ballot, against the box of tile
//   t's live pixels (the forward's rule); a tile with no live pixel keeps
//   none;
// * the kept (tile, slot) pairs are listed, tile-major, and shared out over
//   all 16 warps (pair i to warp i mod 16): a rim tile keeps tens of faces,
//   a far one none, so one warp a tile would leave most of the SM waiting;
// * a warp forms the 32 lanes' shares of a pair from the tile's pixels in
//   shared memory and sums them over the warp (warp_sum8); a pair whose
//   shares are all zero is left out, the others mark their tile in the
//   slot's mask;
// * each filled slot's six sums over its marked tiles, in tile order, go
//   to the half's row in `slot_rows`.
// Dynamic shared memory: kBwdSmem.
__global__ void __launch_bounds__(kRWarps * 32, 2)
soft_bwd_binned_kernel(const float* __restrict__ rows,  // (B, Fr, 16)
                       const int* __restrict__ ids,     // (B, nb, K)
                       const float* __restrict__ pix,   // (P, 2)
                       const float* __restrict__ g,     // (B, nb, 1024)
                       const float* __restrict__ prod,  // (B, nb, 1024)
                       float* __restrict__ slot_rows,   // (B, nb, 2, K, 6)
                       int* __restrict__ slot_of,       // (B, F, nb)
                       int* __restrict__ first,         // (B, F)
                       int* __restrict__ last,          // (B, F)
                       int* __restrict__ band_live,     // (B, nb, 2)
                       int Fr, int nb, int K, int P, int width, float sigma,
                       float m) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);
  float4* conv = reinterpret_cast<float4*>(smem + 2 * kBRaw);
  float* part = reinterpret_cast<float*>(conv + kBTile * kRQuads);
  float4* tpix = reinterpret_cast<float4*>(part + kRPairs * 6);
  unsigned short* list =
      reinterpret_cast<unsigned short*>(tpix + kRWarps * 32);
  unsigned* kept = reinterpret_cast<unsigned*>(list + kRPairs);
  unsigned* tiles_of = kept + kRPairs / 32;
  int* counts = reinterpret_cast<int*>(tiles_of + kBTile);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int band = blockIdx.x / kRHalves, half = blockIdx.x % kRHalves;
  const int b = blockIdx.y, F = Fr - 1;
  const size_t bin = (size_t)b * nb + band;
  const int* band_ids = ids + bin * K;
  const float* src = rows + (size_t)b * Fr * kSRow;

  const int local = band_tile_pixel(half * kRWarps + warp, lane, width);
  const int p = band * kBand + local;
  const bool in = p < P;
  const float gp =
      in ? __fmul_rn(g[bin * kBand + local], prod[bin * kBand + local])
         : 0.0f;
  const bool live = gp != 0.0f;  // a NaN is live
  const float px = in ? pix[2 * p + 0] : 5.0f;
  const float py = in ? pix[2 * p + 1] : 5.0f;
  const bool half_live = __syncthreads_or(live) != 0;
  float* out_rows = slot_rows + (bin * kRHalves + half) * K * 6;

  auto gather = [&](int r) {
    return gather_round(band_ids, src, raw, r, K, Fr);
  };

  // round 0's rows are in flight while the spans are recorded
  int n_next = half_live ? gather(0) : 0;
  for (int k = half * kRWarps * 32 + tid; k < K; k += kBand) {
    const int id = band_ids[k];
    if (id >= 0 && id < F) {
      const size_t face = (size_t)b * F + id;
      atomicMin(first + face, band);
      atomicMax(last + face, band);
      slot_of[face * nb + band] = k;
    }
  }
  if (tid == 0) band_live[bin * kRHalves + half] = half_live;
  if (!half_live) return;  // every share is zero
  const Box tb = tile_box(px, py, live);
  const bool tile_live = __any_sync(0xffffffffu, live);
  tpix[tid] = make_float4(px, py, gp, 0.0f);
  for (int r = 0;; ++r) {
    // faces come first in a bin, fillers after them: a round that is not
    // full is the last (uniform over the block)
    const int n = n_next;
    const bool more = n == kBTile && (r + 1) * kBTile < K;
    if (more) {
      n_next = gather(r + 1);
      tpn::cp_async_wait<1>();
    } else {
      tpn::cp_async_wait<0>();
    }
    __syncthreads();  // round r's rows are visible; round r - 1 is summed
    const float* rr = raw + (r & 1) * kBTile * kSRow;
    if (tid < n) {
      stage_row(rr + tid * kSRow, conv + tid * kRQuads);
      const Box fb = face_box(rr + tid * kSRow, m);
      conv[tid * kRQuads + kSQuads] = make_float4(fb.x0, fb.x1, fb.y0, fb.y1);
    }
    if (tid < kBTile) tiles_of[tid] = 0u;
    __syncthreads();  // the staged rows and boxes are visible
    // the cull: warp = tile, ballots tile-major
#pragma unroll
    for (int q = 0; q < kRGroups; ++q) {
      bool hit = false;
      if (tile_live && q * 32 + lane < n) {
        const float4 c = conv[(q * 32 + lane) * kRQuads + kSQuads];
        hit = !outside(Box{c.x, c.y, c.z, c.w}, tb);
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) kept[warp * kRGroups + q] = mask;
    }
    __syncthreads();  // the ballots are visible
    // the kept pairs' list: a scan of the ballots' counts by the first warps
    int cnt = 0, incl = 0;
    if (warp < kRPairs / 32 / 32) {
      cnt = __popc(kept[tid]);
      incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) counts[warp] = incl;
    }
    __syncthreads();  // the counts are visible
    int total = 0, base = incl - cnt;
#pragma unroll
    for (int w = 0; w < kRPairs / 32 / 32; ++w) {
      total += counts[w];
      base += w < warp ? counts[w] : 0;
    }
    if (tid < kRPairs / 32) {
      const unsigned short head =
          (unsigned short)((tid / kRGroups) << 7 | (tid % kRGroups) * 32);
      for (unsigned bits = kept[tid]; bits; bits &= bits - 1u) {
        list[base++] = (unsigned short)(head + __ffs(bits) - 1);
      }
    }
    __syncthreads();  // the list is visible
    for (int i = warp; i < total; i += kRWarps) {
      const int t = list[i] >> 7, slot = list[i] & 127;
      const float4 q = tpix[t * 32 + lane];
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const bool added = q.z != 0.0f && grad_face(conv + slot * kRQuads, q.x,
                                                  q.y, sigma, q.z, v);
      if (__any_sync(0xffffffffu, added)) {
        warp_sum8(v, lane);
        if ((lane & 3) == 0 && lane < 24) {
          part[(t * kBTile + slot) * 6 + (lane >> 2)] = v[0];
        }
        if (lane == 0) atomicOr(tiles_of + slot, 1u << t);
      }
    }
    __syncthreads();  // the pairs' sums and the slots' tiles are visible
    for (int i = tid; i < 6 * n; i += kRWarps * 32) {
      const int slot = i / 6, c = i - 6 * slot;
      float sum = 0.0f;
      for (unsigned bits = tiles_of[slot]; bits; bits &= bits - 1u) {
        const int t = __ffs(bits) - 1;  // in tile order
        sum = __fadd_rn(sum, part[(t * kBTile + slot) * 6 + c]);
      }
      out_rows[(size_t)r * kBTile * 6 + i] = sum;
    }
    if (!more) break;
  }
}

// Face sum: a warp a face, its lanes a band each of its span. A lane reads
// the face's slot in its band from slot_of (checked against ids: only a
// band that holds the face wrote it) and that slot's row of each half with
// a live pixel, half 0 + half 1 (a half with none holds nothing). The
// bands' rows, staged in shared memory, are added in band order from 0 by
// lanes 0 .. 5, a component each. A face with a
// non-finite vertex that some band holds gets NaN, as the plain sums give
// it (their 0 * NaN shares at every pixel of its bands).
__global__ void __launch_bounds__(kSumWarps * 32)
soft_bwd_faces_kernel(const float* __restrict__ rows,       // (B, Fr, 16)
                      const int* __restrict__ ids,          // (B, nb, K)
                      const float* __restrict__ slot_rows,  // (B, nb, 2, K, 6)
                      const int* __restrict__ slot_of,      // (B, F, nb)
                      const int* __restrict__ first,        // (B, F)
                      const int* __restrict__ last,         // (B, F)
                      const int* __restrict__ band_live,    // (B, nb, 2)
                      float* __restrict__ out,              // (B, F, 6)
                      int B, int Fr, int nb, int K) {
  __shared__ float vals[kSumWarps][32][6];
  const int F = Fr - 1;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long wf = (long long)blockIdx.x * kSumWarps + w;
  if (wf >= (long long)B * F) return;  // uniform over the warp
  const int b = (int)(wf / F), f = (int)(wf - (long long)b * F);
  const int j0 = first[wf], j1 = last[wf];  // j0 > j1: in no band
  float s = 0.0f;
  for (int j = j0; j <= j1; j += 32) {
    const int jl = j + lane;
    bool has = false;
    const size_t bin = (size_t)b * nb + jl;
    const bool live0 = jl <= j1 && band_live[bin * 2] != 0;
    const bool live1 = jl <= j1 && band_live[bin * 2 + 1] != 0;
    if (live0 || live1) {
      const int k = slot_of[(size_t)wf * nb + jl];
      if (k >= 0 && k < K) {
        has = __ldg(ids + bin * K + k) == f;
        if (has) {
          const float2* h0 = reinterpret_cast<const float2*>(
              slot_rows + ((bin * 2) * K + k) * 6);
          const float2* h1 = h0 + (size_t)K * 3;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float2 a = live0 ? h0[i] : make_float2(0.f, 0.f);
            const float2 c = live1 ? h1[i] : make_float2(0.f, 0.f);
            vals[w][lane][2 * i] = __fadd_rn(a.x, c.x);
            vals[w][lane][2 * i + 1] = __fadd_rn(a.y, c.y);
          }
        }
      }
    }
    const unsigned todo = __ballot_sync(0xffffffffu, has);
    __syncwarp();
    if (lane < 6) {
      for (unsigned bits = todo; bits; bits &= bits - 1u) {
        s = __fadd_rn(s, vals[w][__ffs(bits) - 1][lane]);
      }
    }
    __syncwarp();
  }
  if (j0 <= j1 && !finite_vertices(rows + ((size_t)b * Fr + f) * kSRow)) {
    s = __int_as_float(0x7fc00000);
  }
  if (lane < 6) out[wf * 6 + lane] = s;
}

// ---- the dense backward, culled (soft_bwd_dense_tiles, soft_bwd_dense) ---

constexpr int kLTiles = 256;           // dense backward: tiles a segment
constexpr int kLWarps = 32;            // ... first pass: warps a block
constexpr int kQFaces = 8;             // ... faces a block
constexpr int kQWarps = 8;             // ... warps a block
constexpr int kQThreads = kQWarps * 32;
constexpr int kQBatch = 32;            // ... kept tiles a batch
static_assert(kQThreads == kLTiles, "a thread a live tile of a segment");
static_assert(kQBatch <= 32, "a lane of warp 0 a tile of a batch");
static_assert(kQFaces <= 32 && 6 * kQFaces <= kQThreads,
              "a ballot's faces, a thread a face's component");

// First pass of the dense backward: block (s, b) takes the tiles
// [s * kLTiles, (s + 1) * kLTiles) of view b, a warp a tile at a time, and
// lists the tiles with a live pixel (g*prod != 0; dense_tile_pixel's
// tiles) in tile order in segment s: their ids in `live`, the boxes of
// their live pixels in `live_boxes`, their number in counts[b][s] and the
// box around them all in seg_boxes[b][s].
__global__ void __launch_bounds__(kLWarps * 32, 1)
soft_bwd_dense_tiles_kernel(const float* __restrict__ pix,   // (P, 2)
                            const float* __restrict__ g,     // (B, P)
                            const float* __restrict__ prod,  // (B, P)
                            int* __restrict__ live,          // (B, S, 256)
                            float4* __restrict__ live_boxes,  // (B, S, 256)
                            int* __restrict__ counts,        // (B, S)
                            float4* __restrict__ seg_boxes,  // (B, S)
                            int P, int width, int T) {
  __shared__ float4 box[kLTiles];
  __shared__ int wcount[kLTiles / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x, b = blockIdx.y, S = gridDim.x;
  const float* gb = g + (size_t)b * P;
  const float* pb = prod + (size_t)b * P;
  for (int k = warp; k < kLTiles; k += kLWarps) {
    const int t = s * kLTiles + k;
    Box tb{INFINITY, -INFINITY, INFINITY, -INFINITY};
    bool tile_live = false;
    if (t < T) {  // uniform over the warp
      const int p = dense_tile_pixel(t, lane, P, width);
      const bool in = p >= 0;
      const float gp = in ? __fmul_rn(gb[p], pb[p]) : 0.0f;
      const bool lv = gp != 0.0f;  // a NaN is live
      const float px = in ? pix[2 * p + 0] : 5.0f;
      const float py = in ? pix[2 * p + 1] : 5.0f;
      tb = tile_box(px, py, lv);
      tile_live = __any_sync(0xffffffffu, lv);
    }
    // a dead tile: the empty box and no entry (NaN marks "dead")
    if (lane == 0) {
      box[k] = tile_live ? make_float4(tb.x0, tb.x1, tb.y0, tb.y1)
                         : make_float4(NAN, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k >= kLTiles) return;  // whole warps
  const float4 q = box[k];
  const bool on = !isnan(q.x);  // a live tile's box is never NaN at x0
  const unsigned mask = __ballot_sync(0xffffffffu, on);
  if (lane == 0) wcount[warp] = __popc(mask);
  if (warp == 0) {  // the box around the segment's live tiles
    Box u{INFINITY, -INFINITY, INFINITY, -INFINITY};
    for (int i = lane; i < kLTiles; i += 32) {
      const float4 c = box[i];
      if (!isnan(c.x)) {
        u = Box{fminf(u.x0, c.x), fmaxf(u.x1, c.y), fminf(u.y0, c.z),
                fmaxf(u.y1, c.w)};
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      u.x0 = fminf(u.x0, __shfl_xor_sync(0xffffffffu, u.x0, off));
      u.x1 = fmaxf(u.x1, __shfl_xor_sync(0xffffffffu, u.x1, off));
      u.y0 = fminf(u.y0, __shfl_xor_sync(0xffffffffu, u.y0, off));
      u.y1 = fmaxf(u.y1, __shfl_xor_sync(0xffffffffu, u.y1, off));
    }
    if (lane == 0) {
      seg_boxes[(size_t)b * S + s] = make_float4(u.x0, u.x1, u.y0, u.y1);
    }
  }
  // the first kLTiles threads only: the others have returned
  asm volatile("bar.sync 1, %0;" ::"n"(kLTiles));
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kLTiles / 32; ++w) {
    base += w < warp ? wcount[w] : 0;
    total += wcount[w];
  }
  const size_t seg = (size_t)b * S + s;
  if (on) {
    const size_t pos =
        seg * kLTiles + base + __popc(mask & ((1u << lane) - 1u));
    live[pos] = s * kLTiles + k;
    live_boxes[pos] = q;
  }
  if (k == 0) counts[seg] = total;
}

// Dense backward: block (c, b) owns faces [32c, 32c + 32) of view b. Warp
// 0 stages their rows with their cull boxes (face_box) and the box around
// them all. Each segment of the live list whose box meets the chunk's box
// is a round: thread i takes live tile i, which is kept for the chunk
// where its box meets the chunk's box;
// for each such tile its warp tests the 32 faces by one ballot. The tiles
// with a kept face are compacted in tile order and taken in batches of up
// to kQBatch: warp 0 lists the batch's kept (tile, face) pairs, every warp
// stages the pixels (x, y, g*prod) of some of its tiles, the pairs are
// shared over the warps (a warp a pair, its lanes the tile's pixels,
// warp_sum8), and thread 6f + c adds component c of face f's pairs in tile
// order. Static shared memory: under 48 KB, four blocks an SM.
__global__ void __launch_bounds__(kQThreads)
soft_bwd_dense_kernel(const float* __restrict__ rows,        // (B, F, 16)
                      const float* __restrict__ pix,         // (P, 2)
                      const float* __restrict__ g,           // (B, P)
                      const float* __restrict__ prod,        // (B, P)
                      const int* __restrict__ live,          // (B, S, 256)
                      const float4* __restrict__ live_boxes,  // (B, S, 256)
                      const int* __restrict__ counts,        // (B, S)
                      const float4* __restrict__ seg_boxes,  // (B, S)
                      float* __restrict__ out,               // (B, F, 6)
                      int F, int P, int width, int S, float sigma, float m) {
  __shared__ float4 conv[kQFaces * kRQuads];   // staged rows, boxes
  __shared__ float4 tpix[kQBatch * 32];        // a batch's pixels
  __shared__ float part[kQBatch * kQFaces * 6];  // its pairs' sums
  __shared__ int kt[kQThreads];                // a round's kept tiles
  __shared__ unsigned km[kQThreads];           // ... and their faces
  __shared__ unsigned short plist[kQBatch * kQFaces];  // a batch's pairs
  __shared__ int pbase[kQBatch];               // ... each tile's first
  __shared__ int wcnt[kQWarps];
  __shared__ int npairs;
  __shared__ float4 chunk_box;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int f0 = blockIdx.x * kQFaces, b = blockIdx.y;
  const int nf = min(kQFaces, F - f0);
  const float* src = rows + ((size_t)b * F + f0) * kSRow;
  const float* gb = g + (size_t)b * P;
  const float* pb = prod + (size_t)b * P;

  if (warp == 0) {
    Box fb{INFINITY, -INFINITY, INFINITY, -INFINITY};  // no face: empty
    if (lane < nf) {
      stage_row(src + lane * kSRow, conv + lane * kRQuads);
      fb = face_box(src + lane * kSRow, m);
    } else if (lane < kQFaces) {
      stage_zero(conv + lane * kRQuads);
    }
    if (lane < kQFaces) {
      conv[lane * kRQuads + kSQuads] =
          make_float4(fb.x0, fb.x1, fb.y0, fb.y1);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      fb.x0 = fminf(fb.x0, __shfl_xor_sync(0xffffffffu, fb.x0, off));
      fb.x1 = fmaxf(fb.x1, __shfl_xor_sync(0xffffffffu, fb.x1, off));
      fb.y0 = fminf(fb.y0, __shfl_xor_sync(0xffffffffu, fb.y0, off));
      fb.y1 = fmaxf(fb.y1, __shfl_xor_sync(0xffffffffu, fb.y1, off));
    }
    if (lane == 0) chunk_box = make_float4(fb.x0, fb.x1, fb.y0, fb.y1);
  }
  __syncthreads();
  const float4 cq = chunk_box;
  const Box cb{cq.x, cq.y, cq.z, cq.w};
  const float4 fq = conv[min(lane, kQFaces - 1) * kRQuads + kSQuads];
  const Box my_face{fq.x, fq.y, fq.z, fq.w};  // lane's face, for the ballots

  float acc = 0.0f;  // thread 6f + c: component c of face f
  for (int s = 0; s < S; ++s) {
    const size_t seg = (size_t)b * S + s;
    const int n = counts[seg];  // uniform over the block
    const float4 sq = seg_boxes[seg];
    if (n == 0 || outside(cb, Box{sq.x, sq.y, sq.z, sq.w})) continue;
    int t = -1;
    Box tb{INFINITY, -INFINITY, INFINITY, -INFINITY};
    bool hit = false;
    if (tid < n) {
      t = live[seg * kLTiles + tid];
      const float4 q = live_boxes[seg * kLTiles + tid];
      tb = Box{q.x, q.y, q.z, q.w};
      hit = !outside(cb, tb);
    }
    unsigned mask = 0u;
    for (unsigned hits = __ballot_sync(0xffffffffu, hit); hits;
         hits &= hits - 1u) {
      const int k = __ffs(hits) - 1;
      const Box kb{__shfl_sync(0xffffffffu, tb.x0, k),
                   __shfl_sync(0xffffffffu, tb.x1, k),
                   __shfl_sync(0xffffffffu, tb.y0, k),
                   __shfl_sync(0xffffffffu, tb.y1, k)};
      const unsigned faces =
          __ballot_sync(0xffffffffu, lane < nf && !outside(my_face, kb));
      if (lane == k) mask = faces;
    }
    // the tiles with a kept face, compacted in tile order
    const unsigned keep = __ballot_sync(0xffffffffu, mask != 0u);
    if (lane == 0) wcnt[warp] = __popc(keep);
    __syncthreads();  // the counts are visible; the last round is done
    int base = 0, nk = 0;
#pragma unroll
    for (int w = 0; w < kQWarps; ++w) {
      base += w < warp ? wcnt[w] : 0;
      nk += wcnt[w];
    }
    if (mask != 0u) {
      const int pos = base + __popc(keep & ((1u << lane) - 1u));
      kt[pos] = t;
      km[pos] = mask;
    }
    __syncthreads();  // the round's kept tiles are visible
    for (int c0 = 0; c0 < nk; c0 += kQBatch) {
      const int nc = min(kQBatch, nk - c0);
      if (warp == 0) {  // the batch's pairs, tile-major
        const unsigned mm = lane < nc ? km[c0 + lane] : 0u;
        const int cnt = __popc(mm);
        int incl = cnt;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += y;
        }
        int i = incl - cnt;
        if (lane < kQBatch) pbase[lane] = i;
        if (lane == 31) npairs = incl;
        for (unsigned bits = mm; bits; bits &= bits - 1u) {
          plist[i++] = (unsigned short)(lane << 5 | (__ffs(bits) - 1));
        }
      }
      for (int j = warp; j < nc; j += kQWarps) {
        const int p = dense_tile_pixel(kt[c0 + j], lane, P, width);
        float4 q = make_float4(5.0f, 5.0f, 0.0f, 0.0f);
        if (p >= 0) {
          q = make_float4(pix[2 * p + 0], pix[2 * p + 1],
                          __fmul_rn(gb[p], pb[p]), 0.0f);
        }
        tpix[j * 32 + lane] = q;
      }
      __syncthreads();  // the pairs and the pixels are visible
      const int np = npairs;
      for (int i = warp; i < np; i += kQWarps) {
        const int j = plist[i] >> 5, f = plist[i] & 31;
        const float4 q = tpix[j * 32 + lane];
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const bool added = q.z != 0.0f && grad_face(conv + f * kRQuads, q.x,
                                                    q.y, sigma, q.z, v);
        if (__any_sync(0xffffffffu, added)) {
          warp_sum8(v, lane);
          if ((lane & 3) == 0 && lane < 24) part[i * 6 + (lane >> 2)] = v[0];
        } else if (lane < 6) {
          part[i * 6 + lane] = 0.0f;
        }
      }
      __syncthreads();  // the pairs' sums are visible
      if (tid < 6 * kQFaces) {
        const int f = tid / 6, c = tid - 6 * f;
        const unsigned below = (1u << f) - 1u;
        for (int j = 0; j < nc; ++j) {  // in tile order
          const unsigned mm = km[c0 + j];
          if ((mm >> f) & 1u) {
            acc = __fadd_rn(acc,
                            part[(pbase[j] + __popc(mm & below)) * 6 + c]);
          }
        }
      }
      __syncthreads();  // the batch's buffers are free
    }
  }
  if (tid < 6 * nf) {
    const bool bad = P > 0 && !finite_vertices(src + (tid / 6) * kSRow);
    out[((size_t)b * F + f0) * 6 + tid] =
        bad ? __int_as_float(0x7fc00000) : acc;
  }
}

}  // namespace

extern "C" {

// rows (B, F, 16) f32 soft rows, 16-byte aligned; pix (P, 2) f32; out (B, P)
// f32 prod. width: the image's width where it is a multiple of 8 that
// divides P (8 x 4 tiles), else 0 (32 pixels in a row). margin: the cull's
// sqrt(27.7 sigma).
int soft_fwd_dense(const float* rows, const float* pix, float* out, int B,
                   int F, int P, int width, float sigma, float margin,
                   void* stream) {
  static int opened = 0;
  if (B > 0 && P > 0) {
    if (B > 65535) return (int)cudaErrorInvalidValue;
    const long tiles = dense_tiles(P, width);
    const long sms = sm_count();
    if (B * tiles <= 4 * sms) {  // few tiles: a tile a block
      static int opened_tile = 0;
      const cudaError_t err = open_smem(
          (const void*)soft_fwd_dense_tile_kernel, kTileSmem, &opened_tile);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid((unsigned)tiles, (unsigned)B);
      soft_fwd_dense_tile_kernel<<<grid, kTWarps * 32, kTileSmem,
                                   (cudaStream_t)stream>>>(
          rows, pix, out, F, P, width, sigma, margin);
      return (int)cudaGetLastError();
    }
    // more tiles a block while the blocks still cover the SMs
    int NT = 1;
    while (2 * NT <= kDWarps && B * ((tiles + 2 * NT - 1) / (2 * NT)) >= sms) {
      NT *= 2;
    }
    const size_t smem = 128 + (size_t)kStages * kChunk * kSRow * 4 +
                        (size_t)NT * 32 * kSQuads * 16;
    const cudaError_t err =
        open_smem((const void*)soft_fwd_dense_kernel, smem, &opened);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((tiles + NT - 1) / NT), (unsigned)B);
    soft_fwd_dense_kernel<<<grid, NT * 32, smem, (cudaStream_t)stream>>>(
        rows, pix, out, F, P, width, sigma, margin);
  }
  return (int)cudaGetLastError();
}

// rows (B, Fr, 16) with the filler row last, 16-byte aligned; ids (B, nb, K)
// int32, faces first, then the filler id Fr-1; out (B, nb, 1024) f32 prod.
// width: the image's width where 1024 / width rows make tiles of 32 (width
// 32 ... 1024, dividing P), else 0.
int soft_fwd_binned(const float* rows, const int* ids, const float* pix,
                    float* out, int B, int Fr, int nb, int K, int P,
                    int width, float sigma, float margin, void* stream) {
  static int opened = 0;
  if (B > 0 && nb > 0) {
    if (B > 65535) return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        open_smem((const void*)soft_fwd_binned_kernel, kBinnedSmem, &opened);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)nb, (unsigned)B);
    soft_fwd_binned_kernel<<<grid, kBand, kBinnedSmem,
                             (cudaStream_t)stream>>>(
        rows, ids, pix, out, Fr, nb, K, P, width, sigma, margin);
  }
  return (int)cudaGetLastError();
}

// The all-pairs designs of the two above, with their contracts (no width, no
// margin); kept only to be timed beside them.
int soft_fwd_dense_sweep(const float* rows, const float* pix, float* out,
                         int B, int F, int P, float sigma, void* stream) {
  if (B > 0 && P > 0) {
    const dim3 grid((unsigned)((P + kSPix - 1) / kSPix), (unsigned)B);
    const dim3 block(kSPix, kSSlices);
    soft_fwd_dense_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        rows, pix, out, F, P, sigma);
  }
  return (int)cudaGetLastError();
}

int soft_fwd_binned_sweep(const float* rows, const int* ids, const float* pix,
                          float* out, int B, int Fr, int nb, int K, int P,
                          float sigma, void* stream) {
  if (B > 0 && nb > 0) {
    const dim3 grid((unsigned)nb, (unsigned)B);
    soft_fwd_binned_sweep_kernel<<<grid, kBand, 0, (cudaStream_t)stream>>>(
        rows, ids, pix, out, Fr, nb, K, P, sigma);
  }
  return (int)cudaGetLastError();
}

// Kernel #9. rows (B, F, 16) f32, 16-byte aligned; pix (P, 2); g, prod
// (B, P) f32; out (B, F, 6) f32 vertex gradients. width: the image's width
// where it is a multiple of 8 that divides P (8 x 4 tiles), else 0 (32
// pixels in a row); margin the cull's sqrt(27.7 sigma). scratch: at least
// soft_bwd_dense_scratch(B, P, width) 32-bit words, 16-byte aligned (the
// live list with its tiles' boxes, each segment's count and box).
long long soft_bwd_dense_scratch(int B, int P, int width) {
  const long long T = dense_tiles(P, width);
  const long long S = (T + kLTiles - 1) / kLTiles;
  return (long long)B * S * (5 * kLTiles + 5);
}

int soft_bwd_dense(const float* rows, const float* pix, const float* g,
                   const float* prod, float* out, int* scratch,
                   long long scratch_words, int B, int F, int P, int width,
                   float sigma, float margin, void* stream) {
  if (B <= 0 || F <= 0) return (int)cudaGetLastError();
  if (B > 65535 || P < 0 ||
      scratch_words < soft_bwd_dense_scratch(B, P, width)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long T = dense_tiles(P, width);
  const int S = (int)((T + kLTiles - 1) / kLTiles);
  const size_t segs = (size_t)B * S;
  float4* live_boxes = reinterpret_cast<float4*>(scratch);
  float4* seg_boxes = live_boxes + segs * kLTiles;
  int* live = reinterpret_cast<int*>(seg_boxes + segs);
  int* counts = live + segs * kLTiles;
  cudaStream_t st = (cudaStream_t)stream;
  if (S > 0) {
    soft_bwd_dense_tiles_kernel<<<dim3((unsigned)S, (unsigned)B),
                                  kLWarps * 32, 0, st>>>(
        pix, g, prod, live, live_boxes, counts, seg_boxes, P, width, (int)T);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((F + kQFaces - 1) / kQFaces), (unsigned)B);
  soft_bwd_dense_kernel<<<grid, kQThreads, 0, st>>>(
      rows, pix, g, prod, live, live_boxes, counts, seg_boxes, out, F, P,
      width, S, sigma, margin);
  return (int)cudaGetLastError();
}

// The first dense backward design (every face of a block at every live
// pixel), with #9's contract but no width and no margin; kept only to be
// timed beside #9. g, prod (B, P) f32; out (B, F, 6) f32 vertex gradients.
int soft_bwd_dense_sweep(const float* rows, const float* pix, const float* g,
                         const float* prod, float* out, int B, int F, int P,
                         float sigma, void* stream) {
  if (B > 0 && F > 0) {
    if (B > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((F + kGFaces - 1) / kGFaces), (unsigned)B);
    soft_bwd_dense_sweep_kernel<<<grid, kGThreads, 0,
                                  (cudaStream_t)stream>>>(
        rows, pix, g, prod, out, F, P, sigma);
  }
  return (int)cudaGetLastError();
}

// The first binned design: g, prod (B, nb, 1024) f32; out (B, nb, K, 6) f32
// rows per (band, slot), fillers' rows 0; kept only to be timed.
int soft_bwd_binned_sweep(const float* rows, const int* ids, const float* pix,
                          const float* g, const float* prod, float* out,
                          int B, int Fr, int nb, int K, int P, float sigma,
                          void* stream) {
  if (B > 0 && nb > 0 && K > 0) {
    if (nb > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((K + kGFaces - 1) / kGFaces), (unsigned)nb,
                    (unsigned)B);
    soft_bwd_binned_sweep_kernel<<<grid, kGThreads, 0,
                                   (cudaStream_t)stream>>>(
        rows, ids, pix, g, prod, out, Fr, nb, K, P, sigma);
  }
  return (int)cudaGetLastError();
}

// rows (B, Fr, 16) with the filler row last, 16-byte aligned; ids (B, nb, K)
// int32, each band's face ids ascending, then the filler id Fr-1; g, prod
// (B, nb, 1024) f32; width as soft_fwd_binned's; margin the cull's
// sqrt(27.7 sigma). Writes slot_rows (B, nb, 2, K, 6) f32, each half
// band's rows, at the filled slots of the halves with a live pixel
// (nothing else); slot_of (B, Fr-1, nb) int32 at each face's bands; span
// (2, B, Fr-1) int32: each face's first and last band (first > last: in no
// band); band_live (B, nb, 2) int32, each half's.
int soft_bwd_binned(const float* rows, const int* ids, const float* pix,
                    const float* g, const float* prod, float* slot_rows,
                    int* slot_of, int* span, int* band_live, int B, int Fr,
                    int nb, int K, int P, int width, float sigma,
                    float margin, void* stream) {
  static int opened = 0;
  if (B <= 0 || nb <= 0) return (int)cudaGetLastError();
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const size_t faces = (size_t)B * (Fr - 1);
  cudaError_t err = cudaMemsetAsync(span, 0x7f, faces * sizeof(int),
                                    (cudaStream_t)stream);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(span + faces, 0xff, faces * sizeof(int),
                          (cudaStream_t)stream);
  }
  if (err == cudaSuccess) {
    err = open_smem((const void*)soft_bwd_binned_kernel, kBwdSmem, &opened);
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(nb * kRHalves), (unsigned)B);
  soft_bwd_binned_kernel<<<grid, kRWarps * 32, kBwdSmem,
                           (cudaStream_t)stream>>>(
      rows, ids, pix, g, prod, slot_rows, slot_of, span, span + faces,
      band_live, Fr, nb, K, P, width, sigma, margin);
  return (int)cudaGetLastError();
}

// The vertex gradient out (B, Fr-1, 6) f32 of each face: the slot rows,
// slot_of, span and band_live of soft_bwd_binned (same rows and ids) summed
// band by band in band order.
int soft_bwd_faces(const float* rows, const int* ids, const float* slot_rows,
                   const int* slot_of, const int* span, const int* band_live,
                   float* out, int B, int Fr, int nb, int K, void* stream) {
  const long long faces = (long long)B * (Fr - 1);
  if (faces > 0) {
    const long long blocks = (faces + kSumWarps - 1) / kSumWarps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    soft_bwd_faces_kernel<<<(unsigned)blocks, kSumWarps * 32, 0,
                            (cudaStream_t)stream>>>(
        rows, ids, slot_rows, slot_of, span, span + faces, band_live, out, B,
        Fr, nb, K);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
