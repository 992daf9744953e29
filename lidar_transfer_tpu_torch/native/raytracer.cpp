// Native CPU triangle raytracer: BVH + Möller–Trumbore, OpenMP over rays.
//
// This is the framework's native-code counterpart of the reference's
// C++/SSE/OpenMP ray engine (auxiliary/raytracer/RayTracer.cpp:19-124,
// BVH.cpp:19-243, Triangle.h:27-70 — see SURVEY.md §2.2 N1-N6). It is a
// fresh implementation, not a port: median-split recursive BVH build over
// centroid order (the reference used iterative midpoint splits), flat
// struct-of-arrays node layout, and plain scalar math that the compiler
// auto-vectorizes (-O3 -march=native) instead of hand-written SSE
// intrinsics (BBox.cpp:36-100, Vector3.h:11-89).
//
// Role in the TPU framework: the production synthesis path marches rays
// through the TSDF on-device (ops/raycast.py); the mesh parity path uses the
// dense JAX caster (ops/triangles.py). This native engine is the CPU oracle
// both are validated against, and a fast host-side fallback for mesh
// raycasting outside JAX.
//
// Attribute conventions match the reference renderer exactly:
//   label     = attribute of the hit triangle's vertex 0  (RayTracer.cpp:73-75)
//   remission = mean of the 3 vertex remissions           (Triangle.h:63-70)
//   range     = nearest-hit parameter t                   (RayTracer.cpp:89)
//   miss      => range 0, label 0, remission 0, endpoint (0,0,0)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr float kEps = 1e-6f;
constexpr int kLeafSize = 4;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vsub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 vcross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline float vdot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

struct Aabb {
  Vec3 lo{std::numeric_limits<float>::max(),
          std::numeric_limits<float>::max(),
          std::numeric_limits<float>::max()};
  Vec3 hi{-std::numeric_limits<float>::max(),
          -std::numeric_limits<float>::max(),
          -std::numeric_limits<float>::max()};
  void grow(Vec3 p) {
    lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y);
    lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y);
    hi.z = std::max(hi.z, p.z);
  }
  void grow(const Aabb& b) { grow(b.lo); grow(b.hi); }
};

// Slab test against a precomputed reciprocal direction. Returns entry t (or
// +inf on miss); robust to axis-parallel rays because IEEE inf arithmetic
// makes the min/max ordering come out right.
inline float aabb_hit(const Aabb& b, Vec3 o, Vec3 rinv, float t_best) {
  float tx1 = (b.lo.x - o.x) * rinv.x, tx2 = (b.hi.x - o.x) * rinv.x;
  float ty1 = (b.lo.y - o.y) * rinv.y, ty2 = (b.hi.y - o.y) * rinv.y;
  float tz1 = (b.lo.z - o.z) * rinv.z, tz2 = (b.hi.z - o.z) * rinv.z;
  float tmin = std::max(std::max(std::min(tx1, tx2), std::min(ty1, ty2)),
                        std::min(tz1, tz2));
  float tmax = std::min(std::min(std::max(tx1, tx2), std::max(ty1, ty2)),
                        std::max(tz1, tz2));
  if (tmax < std::max(tmin, 0.0f) || tmin > t_best)
    return std::numeric_limits<float>::infinity();
  return tmin;
}

struct Node {
  Aabb box;
  int32_t left = -1;   // index of left child (right = left + 1); -1 => leaf
  int32_t start = 0;   // leaf: first index into tri order
  int32_t count = 0;   // leaf: triangle count
};

struct Bvh {
  std::vector<Node> nodes;
  std::vector<int32_t> order;        // triangle permutation
  // flattened per-triangle data in BVH order for cache-friendly leaves
  std::vector<Vec3> v0, e1, e2;

  void build(const float* verts, const int32_t* faces, int n_faces);
  int32_t build_range(std::vector<int32_t>& idx, int lo, int hi,
                      const std::vector<Vec3>& centers,
                      const std::vector<Aabb>& boxes);
};

int32_t Bvh::build_range(std::vector<int32_t>& idx, int lo, int hi,
                         const std::vector<Vec3>& centers,
                         const std::vector<Aabb>& boxes) {
  const int32_t me = static_cast<int32_t>(nodes.size());
  nodes.emplace_back();
  Aabb box;
  for (int i = lo; i < hi; ++i) box.grow(boxes[idx[i]]);
  nodes[me].box = box;

  if (hi - lo <= kLeafSize) {
    nodes[me].start = lo;
    nodes[me].count = hi - lo;
    return me;
  }
  // split on the widest centroid axis at the median
  Aabb cbox;
  for (int i = lo; i < hi; ++i) cbox.grow(centers[idx[i]]);
  const float ex = cbox.hi.x - cbox.lo.x;
  const float ey = cbox.hi.y - cbox.lo.y;
  const float ez = cbox.hi.z - cbox.lo.z;
  int axis = (ex >= ey && ex >= ez) ? 0 : (ey >= ez ? 1 : 2);
  const int mid = (lo + hi) / 2;
  std::nth_element(idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
                   [&](int32_t a, int32_t b) {
                     const Vec3& ca = centers[a];
                     const Vec3& cb = centers[b];
                     return axis == 0 ? ca.x < cb.x
                          : axis == 1 ? ca.y < cb.y : ca.z < cb.z;
                   });
  const int32_t l = build_range(idx, lo, mid, centers, boxes);
  const int32_t r = build_range(idx, mid, hi, centers, boxes);
  (void)r;  // right child is always left + subtree size; store l explicitly
  nodes[me].left = l;
  nodes[me].start = r;  // reuse start as right-child index for internals
  return me;
}

void Bvh::build(const float* verts, const int32_t* faces, int n_faces) {
  std::vector<Vec3> centers(n_faces);
  std::vector<Aabb> boxes(n_faces);
  std::vector<int32_t> idx(n_faces);
  for (int f = 0; f < n_faces; ++f) {
    idx[f] = f;
    Aabb b;
    Vec3 c{0, 0, 0};
    for (int k = 0; k < 3; ++k) {
      const float* p = verts + 3 * faces[3 * f + k];
      Vec3 v{p[0], p[1], p[2]};
      b.grow(v);
      c.x += v.x / 3.0f; c.y += v.y / 3.0f; c.z += v.z / 3.0f;
    }
    boxes[f] = b;
    centers[f] = c;
  }
  nodes.reserve(2 * std::max(n_faces, 1));
  build_range(idx, 0, n_faces, centers, boxes);
  order = std::move(idx);
  v0.resize(n_faces); e1.resize(n_faces); e2.resize(n_faces);
  for (int i = 0; i < n_faces; ++i) {
    const int32_t f = order[i];
    const float* a = verts + 3 * faces[3 * f + 0];
    const float* b = verts + 3 * faces[3 * f + 1];
    const float* c = verts + 3 * faces[3 * f + 2];
    v0[i] = {a[0], a[1], a[2]};
    e1[i] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    e2[i] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
  }
}

// Möller–Trumbore; returns t or +inf.
inline float tri_hit(Vec3 o, Vec3 d, Vec3 v0, Vec3 e1, Vec3 e2) {
  const Vec3 p = vcross(d, e2);
  const float det = vdot(p, e1);
  if (std::fabs(det) <= kEps) return std::numeric_limits<float>::infinity();
  const float inv = 1.0f / det;
  const Vec3 tv = vsub(o, v0);
  const float u = vdot(tv, p) * inv;
  if (u < 0.0f || u > 1.0f) return std::numeric_limits<float>::infinity();
  const Vec3 q = vcross(tv, e1);
  const float v = vdot(q, d) * inv;
  if (v < 0.0f || u + v > 1.0f) return std::numeric_limits<float>::infinity();
  const float t = vdot(q, e2) * inv;
  return t > kEps ? t : std::numeric_limits<float>::infinity();
}

struct Hit {
  float t = std::numeric_limits<float>::infinity();
  int32_t tri = -1;  // original (unpermuted) triangle index
};

Hit trace_one(const Bvh& bvh, Vec3 o, Vec3 d) {
  Hit best;
  if (bvh.order.empty()) return best;
  const Vec3 rinv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  int32_t stack[64];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const Node& n = bvh.nodes[stack[--sp]];
    if (aabb_hit(n.box, o, rinv, best.t) ==
        std::numeric_limits<float>::infinity())
      continue;
    if (n.left < 0) {
      for (int i = n.start; i < n.start + n.count; ++i) {
        const float t = tri_hit(o, d, bvh.v0[i], bvh.e1[i], bvh.e2[i]);
        if (t < best.t) {
          best.t = t;
          best.tri = bvh.order[i];
        }
      }
    } else {
      // near child first so the far one can be culled by best.t
      const float tl = aabb_hit(bvh.nodes[n.left].box, o, rinv, best.t);
      const float tr = aabb_hit(bvh.nodes[n.start].box, o, rinv, best.t);
      int32_t first = n.left, second = n.start;
      if (tr < tl) std::swap(first, second);
      // depth guard (median split keeps depth ~log2 n, so overflow is
      // astronomically unlikely): push what fits, nearer child last so
      // it pops first; never clobber pending entries
      if (sp + 1 < 64) stack[sp++] = second;
      if (sp < 64) stack[sp++] = first;
    }
  }
  return best;
}

}  // namespace

extern "C" {

// Casts n_rays rays from a shared origin against a triangle mesh.
//   rays          (n_rays, 3) float32 unit directions
//   origin        (3,) float32
//   verts         (n_verts, 3) float32
//   faces         (n_faces, 3) int32 vertex indices
//   vert_labels   (n_verts,) int32 per-vertex semantic labels
//   vert_rems     (n_verts,) float32 per-vertex remissions
// Outputs (caller-allocated):
//   out_endpoints (n_rays, 3) f32, out_labels (n_rays,) i32,
//   out_rems (n_rays,) f32, out_range (n_rays,) f32, out_tri (n_rays,) i32
// Returns the number of rays that hit.
int lt_trace(const float* rays, int n_rays, const float* origin,
             const float* verts, int n_verts, const int32_t* faces,
             int n_faces, const int32_t* vert_labels, const float* vert_rems,
             float* out_endpoints, int32_t* out_labels, float* out_rems,
             float* out_range, int32_t* out_tri) {
  (void)n_verts;
  Bvh bvh;
  bvh.build(verts, faces, n_faces);
  const Vec3 o{origin[0], origin[1], origin[2]};
  int hits = 0;
#pragma omp parallel for schedule(dynamic, 256) reduction(+ : hits)
  for (int r = 0; r < n_rays; ++r) {
    const Vec3 d{rays[3 * r], rays[3 * r + 1], rays[3 * r + 2]};
    const Hit h = trace_one(bvh, o, d);
    if (h.tri >= 0) {
      ++hits;
      out_range[r] = h.t;
      out_endpoints[3 * r + 0] = o.x + d.x * h.t;
      out_endpoints[3 * r + 1] = o.y + d.y * h.t;
      out_endpoints[3 * r + 2] = o.z + d.z * h.t;
      const int32_t* f = faces + 3 * h.tri;
      out_labels[r] = vert_labels[f[0]];
      out_rems[r] = (vert_rems[f[0]] + vert_rems[f[1]] + vert_rems[f[2]])
                    / 3.0f;
      out_tri[r] = h.tri;
    } else {
      out_range[r] = 0.0f;
      out_endpoints[3 * r + 0] = 0.0f;
      out_endpoints[3 * r + 1] = 0.0f;
      out_endpoints[3 * r + 2] = 0.0f;
      out_labels[r] = 0;
      out_rems[r] = 0.0f;
      out_tri[r] = -1;
    }
  }
  return hits;
}

}  // extern "C"
