// Signed-distance grid of a triangle mesh, on the host: the sketch-shape
// guidance's one mesh query (tpunerf_torch/fields/sketch_shape.py).
//
// The JAX package's tpunerf/native/sdf_grid.cpp, copied with the same C API
// and the same arithmetic: unsigned point-triangle distance (Ericson) and
// the sign of the generalized winding number (van Oosterom-Strackee solid
// angles, summed in double), one grid point an OpenMP iteration. Each point
// is computed alone, so the grid does not depend on the thread count.
//
// Built at first use by tpunerf_torch/native/__init__.py
// (g++ -O3 -fPIC -fopenmp -shared -std=c++17, together with marching.cpp).

#include <cmath>
#include <cstdint>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct V3 {
  float x, y, z;
};

inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline float norm(V3 a) { return std::sqrt(dot(a, a)); }

// Ericson, "Real-Time Collision Detection": closest point on triangle.
float point_triangle_dist2(V3 p, V3 a, V3 b, V3 c) {
  V3 ab = sub(b, a), ac = sub(c, a), ap = sub(p, a);
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0.f && d2 <= 0.f) { V3 d = sub(p, a); return dot(d, d); }

  V3 bp = sub(p, b);
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0.f && d4 <= d3) { V3 d = sub(p, b); return dot(d, d); }

  float vc = d1 * d4 - d3 * d2;
  if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) {
    float v = d1 / (d1 - d3);
    V3 q = add(a, mul(ab, v));
    V3 d = sub(p, q);
    return dot(d, d);
  }

  V3 cp = sub(p, c);
  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0.f && d5 <= d6) { V3 d = sub(p, c); return dot(d, d); }

  float vb = d5 * d2 - d1 * d6;
  if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) {
    float w = d2 / (d2 - d6);
    V3 q = add(a, mul(ac, w));
    V3 d = sub(p, q);
    return dot(d, d);
  }

  float va = d3 * d6 - d5 * d4;
  if (va <= 0.f && (d4 - d3) >= 0.f && (d5 - d6) >= 0.f) {
    float w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    V3 q = add(b, mul(sub(c, b), w));
    V3 d = sub(p, q);
    return dot(d, d);
  }

  float denom = 1.f / (va + vb + vc);
  float v = vb * denom, w = vc * denom;
  V3 q = add(a, add(mul(ab, v), mul(ac, w)));
  V3 d = sub(p, q);
  return dot(d, d);
}

// van Oosterom–Strackee solid angle of triangle (a,b,c) seen from p.
double solid_angle(V3 p, V3 a, V3 b, V3 c) {
  V3 ra = sub(a, p), rb = sub(b, p), rc = sub(c, p);
  double la = norm(ra), lb = norm(rb), lc = norm(rc);
  double num = dot(ra, cross(rb, rc));
  double den = la * lb * lc + (double)dot(ra, rb) * lc +
               (double)dot(rb, rc) * la + (double)dot(rc, ra) * lb;
  return 2.0 * std::atan2(num, den);
}

}  // namespace

extern "C" {

// verts: (nv, 3) float32; faces: (nf, 3) int32; out: (res^3,) float32 with
// grid cells at centers ((i+.5)/res*2-1)*bound, x-major (i, j, k) ordering.
// Returns 0 on success.
int tpunerf_sdf_grid(const float* verts, int64_t nv, const int32_t* faces,
                     int64_t nf, int32_t res, float bound, float* out) {
  if (nv <= 0 || nf <= 0 || res <= 0) return 1;
  const int64_t n = (int64_t)res * res * res;

#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t g = 0; g < n; ++g) {
    int64_t i = g / ((int64_t)res * res);
    int64_t j = (g / res) % res;
    int64_t k = g % res;
    V3 p = {(float)(((i + 0.5) / res * 2.0 - 1.0) * bound),
            (float)(((j + 0.5) / res * 2.0 - 1.0) * bound),
            (float)(((k + 0.5) / res * 2.0 - 1.0) * bound)};

    float best = std::numeric_limits<float>::infinity();
    double wn = 0.0;
    for (int64_t f = 0; f < nf; ++f) {
      const int32_t* tri = faces + 3 * f;
      V3 a = {verts[3 * tri[0]], verts[3 * tri[0] + 1],
              verts[3 * tri[0] + 2]};
      V3 b = {verts[3 * tri[1]], verts[3 * tri[1] + 1],
              verts[3 * tri[1] + 2]};
      V3 c = {verts[3 * tri[2]], verts[3 * tri[2] + 1],
              verts[3 * tri[2] + 2]};
      float d2 = point_triangle_dist2(p, a, b, c);
      if (d2 < best) best = d2;
      wn += solid_angle(p, a, b, c);
    }
    float dist = std::sqrt(best);
    bool inside = wn / (4.0 * M_PI) > 0.5;
    out[g] = inside ? -dist : dist;
  }
  return 0;
}

}  // extern "C"
