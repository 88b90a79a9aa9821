// Iso-surface extraction (marching tetrahedra) on the host: the NeRF->mesh
// bridge's extractor (tpunerf_torch/fields/marching.py).
//
// The JAX package's tpunerf/native/marching.cpp, copied with the same tables,
// orientation, interpolation and exact edge-identity welding, and with one
// change that no caller sees in the surface it gets: the triangles come out
// in cell order. The JAX copy fills one triangle buffer per OpenMP thread
// under a dynamic schedule and joins the buffers by thread id, so its vertex
// and face order changes from run to run (and with it the UV atlas built on
// that order). Here each x slab of cells fills its own buffer and the buffers
// are joined in x order: the mesh is the same bit for bit over calls and
// thread counts, and equal to the JAX copy's up to a permutation of vertices
// and faces.
//
// C API (ctypes, tpunerf_torch/native/__init__.py):
//   tpunerf_marching_tets(values, G, iso, bound, &verts, &n_verts,
//                         &faces, &n_faces) -> 0 on success
//   (threads: OpenMP's, e.g. OMP_NUM_THREADS; the output does not depend
//   on them)
//   tpunerf_free(ptr)
//
// Triangles are oriented toward lower values (outward for density > iso
// inside), as fields/marching.py orients them.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

// Six tetrahedra per cube (indices into the 8 cube corners) and corner
// offsets: the tables of fields/marching.py.
constexpr int kCubeTets[6][4] = {{0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
                                 {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6}};
constexpr int kCorners[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                                {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};

// For each of the 16 sign cases: up to 2 triangles, each as 3 edges (pairs
// of tet-vertex ids). Mirrors _TET_TRIS in marching.py.
struct TetCase {
  int n_tris;
  int edges[2][3][2];
};

const TetCase kTetCases[16] = {
    /*0x0*/ {0, {}},
    /*0x1*/ {1, {{{0, 1}, {0, 2}, {0, 3}}}},
    /*0x2*/ {1, {{{1, 0}, {1, 3}, {1, 2}}}},
    /*0x3*/ {2, {{{0, 2}, {1, 3}, {1, 2}}, {{0, 2}, {0, 3}, {1, 3}}}},
    /*0x4*/ {1, {{{2, 0}, {2, 1}, {2, 3}}}},
    /*0x5*/ {2, {{{0, 1}, {2, 1}, {2, 3}}, {{0, 1}, {2, 3}, {0, 3}}}},
    /*0x6*/ {2, {{{1, 0}, {2, 3}, {2, 0}}, {{1, 0}, {1, 3}, {2, 3}}}},
    /*0x7*/ {1, {{{3, 0}, {3, 1}, {3, 2}}}},
    /*0x8*/ {1, {{{3, 0}, {3, 2}, {3, 1}}}},
    /*0x9*/ {2, {{{1, 0}, {2, 0}, {2, 3}}, {{1, 0}, {2, 3}, {1, 3}}}},
    /*0xA*/ {2, {{{0, 1}, {2, 3}, {2, 1}}, {{0, 1}, {0, 3}, {2, 3}}}},
    /*0xB*/ {1, {{{2, 0}, {2, 3}, {2, 1}}}},
    /*0xC*/ {2, {{{0, 2}, {1, 2}, {1, 3}}, {{0, 2}, {1, 3}, {0, 3}}}},
    /*0xD*/ {1, {{{1, 0}, {1, 2}, {1, 3}}}},
    /*0xE*/ {1, {{{0, 1}, {0, 3}, {0, 2}}}},
    /*0xF*/ {0, {}},
};

// A surface vertex lies on the grid edge between two global corner ids; the
// (lo, hi) id pair is its exact identity, so welding is a hash on that pair.
inline uint64_t EdgeKey(uint64_t a, uint64_t b) {
  if (a > b) std::swap(a, b);
  return (a << 32) | b;  // gids < 2^32 (G <= 1625)
}

}  // namespace

extern "C" {

void tpunerf_free(void* p) { std::free(p); }

int tpunerf_marching_tets(const float* values, int32_t G, float iso,
                          float bound, float** out_verts, int64_t* n_verts,
                          int32_t** out_faces, int64_t* n_faces) {
  if (G < 2 || values == nullptr) return 1;
  const int64_t g = G - 1;
  const float spacing = 2.0f * bound / (float)(G - 1);
  const float origin = -bound;
  const auto gid = [G](int64_t x, int64_t y, int64_t z) -> uint64_t {
    return (uint64_t)((x * G + y) * G + z);
  };
  const auto val = [&](uint64_t id) { return values[id]; };

  // One triangle buffer per x slab (three edge keys per triangle), joined
  // in x order below: the output does not depend on the schedule.
  std::vector<std::vector<uint64_t>> tri_keys((size_t)g);

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 4)
#endif
  for (int64_t x = 0; x < g; ++x) {
    auto& out = tri_keys[(size_t)x];
    for (int64_t y = 0; y < g; ++y) {
      for (int64_t z = 0; z < g; ++z) {
        uint64_t cid[8];
        float cval[8];
        float vmin = std::numeric_limits<float>::max(), vmax = -vmin;
        for (int c = 0; c < 8; ++c) {
          cid[c] = gid(x + kCorners[c][0], y + kCorners[c][1],
                       z + kCorners[c][2]);
          cval[c] = val(cid[c]);
          vmin = std::min(vmin, cval[c]);
          vmax = std::max(vmax, cval[c]);
        }
        if (vmin > iso || vmax < iso) continue;
        for (const auto& tet : kCubeTets) {
          int code = 0;
          for (int k = 0; k < 4; ++k)
            code |= (cval[tet[k]] > iso) ? (1 << k) : 0;
          const TetCase& tc = kTetCases[code];
          for (int t = 0; t < tc.n_tris; ++t)
            for (int e = 0; e < 3; ++e)
              out.push_back(EdgeKey(cid[tet[tc.edges[t][e][0]]],
                                    cid[tet[tc.edges[t][e][1]]]));
        }
      }
    }
  }

  int64_t total_tris = 0;
  for (const auto& v : tri_keys) total_tris += (int64_t)(v.size() / 3);

  // Weld: edge key -> vertex index; each vertex position computed once, in
  // the order of first use.
  std::unordered_map<uint64_t, int32_t> vert_of;
  vert_of.reserve((size_t)total_tris * 2);
  std::vector<float> verts;
  verts.reserve((size_t)total_tris * 3);
  int32_t* faces = (int32_t*)std::malloc(
      sizeof(int32_t) * (size_t)std::max<int64_t>(total_tris * 3, 1));
  if (faces == nullptr) return 2;
  int64_t nf = 0;

  const auto corner_pos = [&](uint64_t id, float* p) {
    int64_t z = (int64_t)(id % (uint64_t)G);
    int64_t y = (int64_t)((id / (uint64_t)G) % (uint64_t)G);
    int64_t x = (int64_t)(id / ((uint64_t)G * G));
    p[0] = origin + spacing * (float)x;
    p[1] = origin + spacing * (float)y;
    p[2] = origin + spacing * (float)z;
  };

  int32_t face[3];
  for (const auto& buf : tri_keys) {
    for (size_t i = 0; i < buf.size(); i += 3) {
      for (int e = 0; e < 3; ++e) {
        uint64_t key = buf[i + (size_t)e];
        auto it = vert_of.find(key);
        if (it == vert_of.end()) {
          uint64_t a = key >> 32, b = key & 0xFFFFFFFFu;
          float va = val(a), vb = val(b);
          float denom = vb - va;
          float t = std::fabs(denom) > 1e-12f ? (iso - va) / denom : 0.5f;
          t = std::min(1.0f, std::max(0.0f, t));
          float pa[3], pb[3];
          corner_pos(a, pa);
          corner_pos(b, pb);
          int32_t idx = (int32_t)(verts.size() / 3);
          for (int d = 0; d < 3; ++d)
            verts.push_back(pa[d] * (1.0f - t) + pb[d] * t);
          vert_of.emplace(key, idx);
          face[e] = idx;
        } else {
          face[e] = it->second;
        }
      }
      if (face[0] != face[1] && face[1] != face[2] && face[0] != face[2]) {
        faces[nf * 3 + 0] = face[0];
        faces[nf * 3 + 1] = face[1];
        faces[nf * 3 + 2] = face[2];
        ++nf;
      }
    }
  }

  float* vout = (float*)std::malloc(
      sizeof(float) * std::max<size_t>(verts.size(), 1));
  if (vout == nullptr) {
    std::free(faces);
    return 2;
  }
  std::copy(verts.begin(), verts.end(), vout);
  *out_verts = vout;
  *n_verts = (int64_t)(verts.size() / 3);
  *out_faces = faces;
  *n_faces = nf;
  return 0;
}

}  // extern "C"
