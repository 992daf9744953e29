// Build kernels of the mesh raycast's BVH (row C): a linear BVH in the
// manner of Karras ("Maximizing parallelism in the construction of BVHs,
// octrees, and k-d trees", HPG 2012), built on the card every call, since
// catmesh's oracle engine casts against a new mesh every frame. The
// traversal is csrc/mesh_raycast.cu's.
//
// Replaces, with that traversal: lidar_transfer_tpu/ops/triangles.py::
// _raycast_mesh_impl (:57, an XLA lax.scan over chunks of triangles; not a
// Pallas kernel). The JAX engine casts the same function through the
// native BVH on the host whenever it builds (native/raytracer.cpp).
//
// Four kernels, one thread an item, each the plain version's rules in
// ops/triangles.py (bvh_keys_plain, bvh_hierarchy_plain, bvh_refit_plain,
// bvh_reorder_plain) with the same float32 arithmetic (-fmad=false), so
// the tree equals build_bvh_plain's bit for bit:
//   keys      a triangle: its exact box, the Morton code of the box's
//             centre (10 bits an axis over the scene's box) shifted up 32
//             bits or'd with its index (unique keys: the tree is a
//             function of the input), and its box padded by the margin
//             derived in bvh_keys_plain, which covers every point at which
//             the float32 Möller–Trumbore test accepts a hit;
//   (torch.sort of the keys between the two, glue as the JAX package's
//    host sort is)
//   hierarchy an internal node (T - 1): its range and split from __clzll
//             of neighbouring keys' XOR; its children's ids and their
//             parent; its arrival counter set to 0;
//   refit     a leaf: walks up; the first of two children to arrive at a
//             node writes its box and height into the node's record and
//             leaves, after __threadfence(), the second merges (min/max
//             are exact, so the boxes do not depend on the arrival order);
//   reorder   a leaf: its triangle copied as v0, e1 = v1 - v0, e2 = v2 - v0
//             (formed as raycast_mesh_plain forms them, so each ray and
//             triangle give the same bits as in the dense sweep) and its
//             index, three float4 rows a leaf.
// Bound on the card: bytes (probes/bounds.py bvh_*): each kernel reads its
// inputs once and writes its outputs once (keys 36 B in, 32 B out a
// triangle; the refit's records 64 B an internal node). The refit's walk
// is a chain of dependent reads through L2, a leaf's length up to the
// tree's height; the other three are streams.
//
// A node record is 16 words: the left child's box (lo xyz, hi xyz), the
// right child's, the two child ids and the two children's heights (int32
// bits). Ids below T - 1 are internal nodes, T - 1 + j is leaf j, 0 is the
// root (with T = 1 the root is leaf 0).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kCells = 1024.0f;
// the margin's factors (ops/triangles.py _C1, _C2, _C3)
constexpr float kC1 = 0.4375f, kC2 = 0x1p-22f, kC3 = 0x1p-22f;

__device__ __forceinline__ unsigned long long spread10(unsigned long long x) {
  x = (x | (x << 16)) & 0x030000FFull;
  x = (x | (x << 8)) & 0x0300F00Full;
  x = (x | (x << 4)) & 0x030C30C3ull;
  return (x | (x << 2)) & 0x09249249ull;
}

__global__ void __launch_bounds__(kThreads)
    keys_kernel(const float* __restrict__ tris, int T,
                const float* __restrict__ scene,
                const float* __restrict__ reach, long long* __restrict__ keys,
                float* __restrict__ boxes) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= T) return;
  const float* p = tris + 9LL * i;
  float lo[3], hi[3], a1[3], a2[3], S[3];
  unsigned long long q[3];
  for (int a = 0; a < 3; ++a) {
    const float v0 = p[a], v1 = p[3 + a], v2 = p[6 + a];
    lo[a] = fminf(fminf(v0, v1), v2);
    hi[a] = fmaxf(fmaxf(v0, v1), v2);
    const float c = ((lo[a] + hi[a]) * 0.5f - scene[a]) * scene[3 + a];
    q[a] = (unsigned long long)(unsigned int)fminf(fmaxf(c, 0.0f),
                                                   kCells - 1.0f);
    a1[a] = fabsf(v1 - v0);
    a2[a] = fabsf(v2 - v0);
    S[a] = fmaxf(fabsf(reach[a] - v0), fabsf(reach[3 + a] - v0));
  }
  const unsigned long long morton =
      (spread10(q[0]) << 2) | (spread10(q[1]) << 1) | spread10(q[2]);
  keys[i] = (long long)((morton << 32) | (unsigned long long)i);
  // sums over i != j, and over distinct i, j, k (bvh_keys_plain)
  const float q12 = (a1[0] * (a2[1] + a2[2]) + a1[1] * (a2[0] + a2[2])) +
                    a1[2] * (a2[0] + a2[1]);
  const float qs2 = (S[0] * (a2[1] + a2[2]) + S[1] * (a2[0] + a2[2])) +
                    S[2] * (a2[0] + a2[1]);
  const float qs1 = (S[0] * (a1[1] + a1[2]) + S[1] * (a1[0] + a1[2])) +
                    S[2] * (a1[0] + a1[1]);
  const float tt = (S[0] * (a1[1] * a2[2] + a1[2] * a2[1]) +
                    S[1] * (a1[0] * a2[2] + a1[2] * a2[0])) +
                   S[2] * (a1[0] * a2[1] + a1[1] * a2[0]);
  const float D = reach[6];
  float* b = boxes + 6LL * i;
  for (int a = 0; a < 3; ++a) {
    const float m =
        ((((q12 * S[a] + tt) + qs2 * a1[a]) + qs1 * a2[a]) * D) * kC1 +
        ((S[a] + a1[a]) + a2[a]) * kC2;
    b[a] = lo[a] - (m + fabsf(lo[a]) * kC3);
    b[3 + a] = hi[a] + (m + fabsf(hi[a]) * kC3);
  }
}

// common prefix length of sorted keys i and j; -1 outside [0, n)
__device__ __forceinline__ int delta(const long long* __restrict__ keys,
                                     long long n, long long i, long long j) {
  if (j < 0 || j >= n) return -1;
  return __clzll(keys[i] ^ keys[j]);
}

__global__ void __launch_bounds__(kThreads)
    hierarchy_kernel(const long long* __restrict__ keys, int n,
                     float* __restrict__ nodes, int* __restrict__ parents,
                     int* __restrict__ counters) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long m = n - 1;
  if (i >= m) return;
  const long long d =
      delta(keys, n, i, i + 1) - delta(keys, n, i, i - 1) >= 0 ? 1 : -1;
  const int dmin = delta(keys, n, i, i - d);
  long long lmax = 2;
  while (delta(keys, n, i, i + lmax * d) > dmin) lmax *= 2;
  long long l = 0;
  for (long long t = lmax >> 1; t >= 1; t >>= 1)
    if (delta(keys, n, i, i + (l + t) * d) > dmin) l += t;
  const long long j = i + l * d;
  const int dnode = delta(keys, n, i, j);
  long long s = 0, t = l;
  do {
    t = (t + 1) >> 1;
    if (delta(keys, n, i, i + (s + t) * d) > dnode) s += t;
  } while (t > 1);
  const long long gamma = i + s * d + (d < 0 ? -1 : 0);
  const int left = (int)(min(i, j) == gamma ? gamma + m : gamma);
  const int right = (int)(max(i, j) == gamma + 1 ? gamma + 1 + m : gamma + 1);
  int* rec = reinterpret_cast<int*>(nodes + 16 * i);
  rec[12] = left;
  rec[13] = right;
  parents[left] = (int)i;
  parents[right] = (int)i;
  counters[i] = 0;
  if (i == 0) parents[0] = -1;  // internal node 0 is no node's child
}

__global__ void __launch_bounds__(kThreads)
    refit_kernel(float* nodes, const int* __restrict__ parents, int* counters,
                 const int* __restrict__ leaf_tri,
                 const float* __restrict__ boxes, int n, int* height) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const float* b = boxes + 6LL * leaf_tri[j];
  float lo[3] = {b[0], b[1], b[2]}, hi[3] = {b[3], b[4], b[5]};
  int node = n - 1 + j, h = 0;
  while (true) {
    const int p = parents[node];
    if (p < 0) {  // the root: every node below it is merged
      *height = h;
      return;
    }
    float* rec = nodes + 16LL * p;
    int* irec = reinterpret_cast<int*>(rec);
    const int slot = irec[12] == node ? 0 : 1;
    for (int a = 0; a < 3; ++a) {
      rec[6 * slot + a] = lo[a];
      rec[6 * slot + 3 + a] = hi[a];
    }
    irec[14 + slot] = h;
    __threadfence();  // the record before the count
    if (atomicAdd(&counters[p], 1) == 0) return;  // the sibling merges
    __threadfence();
    const int o = 1 - slot;
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __ldcg(rec + 6 * o + a));
      hi[a] = fmaxf(hi[a], __ldcg(rec + 6 * o + 3 + a));
    }
    h = 1 + max(h, __ldcg(irec + 14 + o));
    node = p;
  }
}

__global__ void __launch_bounds__(kThreads)
    reorder_kernel(const float* __restrict__ tris,
                   const int* __restrict__ leaf_tri, int n,
                   float4* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int k = leaf_tri[j];
  const float* p = tris + 9LL * k;
  const float x = p[0], y = p[1], z = p[2];
  out[3LL * j] = make_float4(x, y, z, p[3] - x);
  out[3LL * j + 1] = make_float4(p[4] - y, p[5] - z, p[6] - x, p[7] - y);
  out[3LL * j + 2] = make_float4(p[8] - z, __int_as_float(k), 0.0f, 0.0f);
}

unsigned int blocks(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Keys and padded boxes of the T triangles tris (T, 3, 3): scene (6,) the
// Morton grid (lo xyz, cells a metre xyz), reach (7,) the rays' origin box
// and largest |direction component|; writes keys (T,) int64 and boxes
// (T, 6). Each entry returns the cudaError_t.
extern "C" int lt_mesh_bvh_keys(const float* tris, int T, const float* scene,
                                const float* reach, long long* keys,
                                float* boxes, void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  keys_kernel<<<blocks(T), kThreads, 0, (cudaStream_t)stream>>>(
      tris, T, scene, reach, keys, boxes);
  return (int)cudaGetLastError();
}

// The hierarchy over the n >= 2 sorted keys: writes each internal node's
// child ids (words 12, 13 of nodes (n - 1, 16)), parents (2n - 1,) and
// counters (n - 1,) = 0.
extern "C" int lt_mesh_bvh_hierarchy(const long long* keys, int n,
                                     float* nodes, int* parents,
                                     int* counters, void* stream) {
  if (n < 2) return (int)cudaErrorInvalidValue;
  hierarchy_kernel<<<blocks(n - 1), kThreads, 0, (cudaStream_t)stream>>>(
      keys, n, nodes, parents, counters);
  return (int)cudaGetLastError();
}

// The refit of the n leaves (leaf j's triangle leaf_tri[j], its box in
// boxes (T, 6)): writes the records' boxes and heights and the root's
// height to *height.
extern "C" int lt_mesh_bvh_refit(float* nodes, const int* parents,
                                 int* counters, const int* leaf_tri,
                                 const float* boxes, int n, int* height,
                                 void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  refit_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      nodes, parents, counters, leaf_tri, boxes, n, height);
  return (int)cudaGetLastError();
}

// The n triangles in leaf order as out (n, 12): v0, e1, e2, the index.
extern "C" int lt_mesh_bvh_reorder(const float* tris, const int* leaf_tri,
                                   int n, float* out, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  reorder_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      tris, leaf_tri, n, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}
