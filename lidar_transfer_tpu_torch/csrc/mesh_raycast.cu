// Mesh raycast kernels (row C): the nearest hit of each ray in a triangle
// soup, Möller–Trumbore, the lowest triangle index on a tie in t.
//
// Replaces: lidar_transfer_tpu/ops/triangles.py::_raycast_mesh_impl (:57,
// an XLA lax.scan over chunks of 512 triangles whose body _mt_chunk (:39)
// tests every ray against the chunk and min-reduces t; not a Pallas
// kernel). Catmesh's oracle engine casts the target's rays against its
// per-category meshes with it once a frame.
//
// What it computes, in ops/triangles.py::raycast_mesh_plain's float32
// order (-fmad=false, an IEEE reciprocal), so the plain version is its
// oracle bit for bit:
//   e1 = v1 - v0, e2 = v2 - v0; p = d x e2; det = (p0 e1_0 + p1 e1_1)
//   + p2 e1_2; inv = 1/det where |det| > 1e-6, else no hit; s = o - v0;
//   u = (s . p) inv; q = s x e1; v = (q . d) inv; t = (q . e2) inv; a hit
//   iff u >= 0, v >= 0, u + v <= 1, t > 1e-6. Each dot is (a0 b0 + a1 b1)
//   + a2 b2 and each cross product jnp.cross's.
//   Outputs: t (f32, +inf on a miss) and the triangle index (i32, -1).
// The tests are a conjunction, so a thread leaves a triangle at the first
// one that fails: the values it keeps are the ones the plain version
// keeps.
//
// Two kernels:
//
// bvh_raycast_kernel (lt_mesh_raycast, the path): one thread a ray, rays
// in the caller's order (the target image's, row-major, so a warp's rays
// are neighbouring pixels and walk the same nodes), through the BVH that
// csrc/mesh_bvh.cu builds. A node read is four aligned float4 through the
// read-only path (__ldg): both children's boxes and ids, so one read
// tests both children; the nearer child is taken and the farther pushed
// with its entry t onto a stack of kStack entries in local memory; a leaf
// is tested when its box is met. A node is skipped only when its entry t,
// scaled down by 2^-20, is strictly greater than the best t, or the ray
// misses its box, whose t_far is scaled up by 2^-20 (Ize, "Robust BVH ray
// traversal", JCGT 2013: the slab test's three roundings are under 3 eps).
// A zero direction component gives 1/d = +-inf and NaN where the origin
// lies on a box plane; each axis takes its near plane by the sign of 1/d
// and fmaxf/fminf drop the NaN, so such a plane constrains nothing. With
// the leaves' boxes padded by the margin of ops/triangles.py::
// bvh_keys_plain, every triangle the dense test accepts at t <= best t is
// tested, and the hit rule is t < best or t == best with a smaller
// triangle index: the result is the dense sweep's, ties included.
// Stack depth: the keys are unique and below 2^62, so two keys share a
// prefix of 2 to 63 bits; an internal node's children share a longer
// prefix than the node, so a root-to-leaf path holds at most 62 internal
// nodes and the stack, one entry per internal node above the current one,
// at most 61. The refit checks the tree's height and the kernel sets
// flags[0] rather than push past kStack; the wrapper raises on either.
// The tensor cores do not serve this arithmetic. What the card offers is
// its L1 and read-only cache, which hold the top of the tree that every
// warp reads first, and many warps an SM to hide the node and triangle
// gathers: 65,536 rays in blocks of 64 make 1,024 blocks, 15.5 warps an
// SM, a quarter of the 64 an SM can hold, so the gathers' latency is
// hidden only in part.
//
// mesh_raycast_dense_kernel (lt_mesh_raycast_dense, off the path: the
// parent design, kept as the full-frame oracle on the card and as the
// time the BVH replaces): one thread casts one ray against every
// triangle, 128 rays a block; the block stages the triangles through
// shared memory in tiles of kTile (v0, e1, e2 as 9 floats in structure-of-
// arrays rows, the edges formed as they are staged), and every thread
// tests the tile in index order against the broadcast rows, keeping a hit
// on strict <, so the lowest index keeps a tie. Its work is R x T tests of
// 46 float32 operations (probes/bounds.py mesh_raycast_dense).
//
// Bound on the card of the function (probes/bounds.py mesh_raycast): its
// bytes, every triangle read once (an unread triangle could be the
// nearest), the rays and origins read and t and the index written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// triangles a tile: 9 floats each in shared memory, 18 KB
constexpr int kTile = 512;
constexpr float kEps = 1e-6f;

__global__ void __launch_bounds__(kThreads)
    mesh_raycast_dense_kernel(const float* __restrict__ tris, int T,
                        const float* __restrict__ origins, int origin_stride,
                        const float* __restrict__ dirs, int R,
                        float* __restrict__ out_t, int* __restrict__ out_tri) {
  __shared__ float s[9][kTile];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int rr = r < R ? r : R - 1;
  const float* o = origins + (long long)rr * origin_stride;
  const float ox = o[0], oy = o[1], oz = o[2];
  const float dx = dirs[3LL * rr], dy = dirs[3LL * rr + 1],
              dz = dirs[3LL * rr + 2];
  float best_t = INFINITY;
  int best_i = -1;
  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    __syncthreads();  // the last tile's reads are done
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* p = tris + 9LL * (base + j);
      const float ax = p[0], ay = p[1], az = p[2];
      s[0][j] = ax;
      s[1][j] = ay;
      s[2][j] = az;
      s[3][j] = p[3] - ax;
      s[4][j] = p[4] - ay;
      s[5][j] = p[5] - az;
      s[6][j] = p[6] - ax;
      s[7][j] = p[7] - ay;
      s[8][j] = p[8] - az;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float e1x = s[3][j], e1y = s[4][j], e1z = s[5][j];
      const float e2x = s[6][j], e2y = s[7][j], e2z = s[8][j];
      // p = d x e2
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = (px * e1x + py * e1y) + pz * e1z;
      if (!(fabsf(det) > kEps)) continue;
      const float inv = __frcp_rn(det);
      const float sx = ox - s[0][j], sy = oy - s[1][j], sz = oz - s[2][j];
      const float u = ((sx * px + sy * py) + sz * pz) * inv;
      if (!(u >= 0.0f)) continue;
      // q = s x e1
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float v = ((qx * dx + qy * dy) + qz * dz) * inv;
      if (!(v >= 0.0f) || !(u + v <= 1.0f)) continue;
      const float t = ((qx * e2x + qy * e2y) + qz * e2z) * inv;
      // strict <: the lowest index keeps a tie
      if (t > kEps && t < best_t) {
        best_t = t;
        best_i = base + j;
      }
    }
  }
  if (r < R) {
    out_t[r] = best_t;
    out_tri[r] = best_i;
  }
}

// the traversal's rays a block
constexpr int kRayThreads = 64;
constexpr int kStack = 64;
// the slab test's scaling (ops/triangles.py _NEAR, _FAR)
constexpr float kNear = 1.0f - 0x1p-20f, kFar = 1.0f + 0x1p-20f;

// entry and exit t of the box [l, h] on the ray (o, 1/d), conservative
__device__ __forceinline__ void slab(float lx, float ly, float lz, float hx,
                                     float hy, float hz, const float* o,
                                     const float* inv, const bool* neg,
                                     float& tn, float& tf) {
  const float l[3] = {lx, ly, lz}, h[3] = {hx, hy, hz};
  tn = -INFINITY;
  tf = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (l[a] - o[a]) * inv[a], t1 = (h[a] - o[a]) * inv[a];
    tn = fmaxf(tn, neg[a] ? t1 : t0);  // a NaN is dropped
    tf = fminf(tf, neg[a] ? t0 : t1);
  }
  tn = fmaxf(tn * kNear, 0.0f);
  tf = tf * kFar;
}

__global__ void __launch_bounds__(kRayThreads)
    bvh_raycast_kernel(const float4* __restrict__ nodes,
                       const float4* __restrict__ tris, int T,
                       const float* __restrict__ origins, int origin_stride,
                       const float* __restrict__ dirs, int R,
                       float* __restrict__ out_t, int* __restrict__ out_tri,
                       int* __restrict__ flags) {
  const int r = blockIdx.x * kRayThreads + threadIdx.x;
  if (r >= R) return;
  const float* op = origins + (long long)r * origin_stride;
  const float o[3] = {op[0], op[1], op[2]};
  const float d[3] = {dirs[3LL * r], dirs[3LL * r + 1], dirs[3LL * r + 2]};
  float inv[3];
  bool neg[3];
  for (int a = 0; a < 3; ++a) {
    inv[a] = __frcp_rn(d[a]);
    neg[a] = (__float_as_uint(inv[a]) >> 31) != 0u;  // the sign bit
  }
  float best_t = INFINITY;
  int best_i = -1;
  // the MT test of leaf j in _mt's order; a hit on a smaller t, or on an
  // equal t with a smaller triangle index, replaces the best
  auto test = [&](int j) {
    const float4 a = __ldg(tris + 3LL * j), b = __ldg(tris + 3LL * j + 1),
                 c = __ldg(tris + 3LL * j + 2);
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = c.x;
    const float px = d[1] * e2z - d[2] * e2y;
    const float py = d[2] * e2x - d[0] * e2z;
    const float pz = d[0] * e2y - d[1] * e2x;
    const float det = (px * e1x + py * e1y) + pz * e1z;
    if (!(fabsf(det) > kEps)) return;
    const float inv_det = __frcp_rn(det);
    const float sx = o[0] - a.x, sy = o[1] - a.y, sz = o[2] - a.z;
    const float u = ((sx * px + sy * py) + sz * pz) * inv_det;
    if (!(u >= 0.0f)) return;
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = ((qx * d[0] + qy * d[1]) + qz * d[2]) * inv_det;
    if (!(v >= 0.0f) || !(u + v <= 1.0f)) return;
    const float t = ((qx * e2x + qy * e2y) + qz * e2z) * inv_det;
    const int idx = __float_as_int(c.y);
    if (t > kEps && (t < best_t || (t == best_t && idx < best_i))) {
      best_t = t;
      best_i = idx;
    }
  };
  const int m = T - 1;  // internal nodes; leaf j is node m + j
  if (m == 0) {
    test(0);
  } else {
    int stack[kStack];
    float stack_t[kStack];
    int sp = 0, node = 0;
    while (true) {
      const float4* rec = nodes + 4LL * node;
      const float4 q0 = __ldg(rec), q1 = __ldg(rec + 1), q2 = __ldg(rec + 2),
                   q3 = __ldg(rec + 3);
      const int cl = __float_as_int(q3.x), cr = __float_as_int(q3.y);
      float tnl, tfl, tnr, tfr;
      slab(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, o, inv, neg, tnl, tfl);
      slab(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, o, inv, neg, tnr, tfr);
      bool hl = tnl <= tfl && tnl <= best_t;
      bool hr = tnr <= tfr && tnr <= best_t;
      if (hl && cl >= m) {
        test(cl - m);
        hl = false;
      }
      if (hr && cr >= m) {
        if (tnr <= best_t) test(cr - m);
        hr = false;
      }
      hl = hl && tnl <= best_t;
      hr = hr && tnr <= best_t;
      if (hl && hr) {
        const bool near_l = tnl <= tnr;
        if (sp == kStack) {  // not reached: see the header
          atomicOr(flags, 1);
          break;
        }
        stack[sp] = near_l ? cr : cl;
        stack_t[sp] = near_l ? tnr : tnl;
        ++sp;
        node = near_l ? cl : cr;
        continue;
      }
      if (hl || hr) {
        node = hl ? cl : cr;
        continue;
      }
      bool found = false;
      while (sp > 0) {
        --sp;
        if (stack_t[sp] <= best_t) {
          node = stack[sp];
          found = true;
          break;
        }
      }
      if (!found) break;
    }
  }
  out_t[r] = best_t;
  out_tri[r] = best_i;
}

}  // namespace

// The dense kernel: casts R rays (dirs (R, 3); origins one row when
// origin_stride is 0, one a ray when it is 3) against the T triangles tris
// (T, 3, 3), all float32; writes out_t (R,) and out_tri (R,). Returns the
// cudaError_t.
extern "C" int lt_mesh_raycast_dense(const float* tris, int T,
                                     const float* origins, int origin_stride,
                                     const float* dirs, int R, float* out_t,
                                     int* out_tri, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  if (T < 0 || (origin_stride != 0 && origin_stride != 3))
    return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)((R + kThreads - 1) / kThreads);
  mesh_raycast_dense_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tris, T, origins, origin_stride, dirs, R, out_t, out_tri);
  return (int)cudaGetLastError();
}

// The traversal: casts R rays (origins and dirs as above) through the BVH
// of T >= 1 triangles, nodes (T - 1, 16) and leaf rows tris (T, 12)
// (csrc/mesh_bvh.cu); writes out_t (R,), out_tri (R,) and sets flags[0]
// if a stack would overflow. Returns the cudaError_t.
extern "C" int lt_mesh_raycast(const float* nodes, const float* tris, int T,
                               const float* origins, int origin_stride,
                               const float* dirs, int R, float* out_t,
                               int* out_tri, int* flags, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  if (T < 1 || (origin_stride != 0 && origin_stride != 3))
    return (int)cudaErrorInvalidValue;
  const unsigned int grid =
      (unsigned int)((R + kRayThreads - 1) / kRayThreads);
  bvh_raycast_kernel<<<grid, kRayThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), T, origins, origin_stride, dirs,
      R, out_t, out_tri, flags);
  return (int)cudaGetLastError();
}
