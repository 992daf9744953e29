// Mesh raycast kernel (row C): the nearest hit of each ray in a triangle
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
// Bound on the card: operations (probes/bounds.py mesh_raycast): R x T
// tests of 46 float32 operations each; a frame's mesh of some 10^7
// triangles against 65,536 rays is some 3e13 operations, 0.45 s at 67
// TFLOP/s, while its bytes (36 a triangle, 20 a ray) take 0.1 ms. The
// design is the simple one: one thread a ray, 128 rays a block; the block
// stages the triangles through shared memory in tiles of kTile (v0, e1,
// e2 as 9 floats in structure-of-arrays rows, the edges formed as they
// are staged), and every thread tests the tile in index order against
// the broadcast rows. Culling (a BVH, or the rays' cones against the
// tiles' bounds) is what would make it fast; the tensor cores do not
// serve this arithmetic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// triangles a tile: 9 floats each in shared memory, 18 KB
constexpr int kTile = 512;
constexpr float kEps = 1e-6f;

__global__ void __launch_bounds__(kThreads)
    mesh_raycast_kernel(const float* __restrict__ tris, int T,
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

}  // namespace

// Casts R rays (dirs (R, 3); origins one row when origin_stride is 0, one
// a ray when it is 3) against the T triangles tris (T, 3, 3), all float32;
// writes out_t (R,) and out_tri (R,). Returns the cudaError_t.
extern "C" int lt_mesh_raycast(const float* tris, int T, const float* origins,
                               int origin_stride, const float* dirs, int R,
                               float* out_t, int* out_tri, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  if (T < 0 || (origin_stride != 0 && origin_stride != 3))
    return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)((R + kThreads - 1) / kThreads);
  mesh_raycast_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tris, T, origins, origin_stride, dirs, R, out_t, out_tri);
  return (int)cudaGetLastError();
}
