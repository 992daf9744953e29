// Kernel E: the neighbour map of a submanifold sparse convolution. For
// every occupied cell i and every offset d of a k x k x k kernel, the index
// of the occupied cell at g_i + d in the same cloud, or n where there is
// none (the row of zeros the convolution's gather appends).
//
// Replaces no Pallas kernel: the JAX package has no point model. PyTorch's
// nearest call is a sort of the cells' keys and a searchsorted of every
// query (ops/sparse_conv.neighbor_map_plain): 64-bit keys of n * k^3
// queries, each a binary search of some 20 steps through global memory.
//
// Bound on the card: one read of the cells and cloud ids (16 B a cell) and
// one write of the map (4 B an entry, n * k^3 entries).
//
// Design: two kernels on the caller's stream. The first inserts each
// cell's 64-bit key (cloud << 48 | x << 32 | y << 16 | z) into an open-
// addressing table of a power-of-two size at least twice n, by atomicCAS
// with linear probing, and writes its index beside it. The second gives
// one thread an (i, d) entry, in the map's own order, so that consecutive
// threads write consecutive entries and read the same cell; it probes the
// table until the key or an empty slot. The keys are unique (one point a
// cell), so the map does not depend on the order of insertion.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ unsigned long long mix(unsigned long long k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  return k ^ (k >> 33);
}

__device__ __forceinline__ unsigned long long pack(int c, int x, int y,
                                                   int z) {
  return ((unsigned long long)(unsigned)c << 48) |
         ((unsigned long long)(unsigned)x << 32) |
         ((unsigned long long)(unsigned)y << 16) | (unsigned long long)z;
}

__global__ void __launch_bounds__(kThreads)
    ptv3_neighbor_insert_kernel(const int* __restrict__ grid,
                                const int* __restrict__ cloud, int n,
                                unsigned long long* __restrict__ keys,
                                int* __restrict__ vals,
                                unsigned long long mask) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key =
      pack(cloud[i], grid[3 * i], grid[3 * i + 1], grid[3 * i + 2]);
  unsigned long long slot = mix(key) & mask;
  while (true) {
    const unsigned long long prev = atomicCAS(&keys[slot], kEmpty, key);
    if (prev == kEmpty || prev == key) {
      vals[slot] = i;
      return;
    }
    slot = (slot + 1) & mask;
  }
}

__global__ void __launch_bounds__(kThreads)
    ptv3_neighbor_query_kernel(const int* __restrict__ grid,
                               const int* __restrict__ cloud, int n, int k,
                               const unsigned long long* __restrict__ keys,
                               const int* __restrict__ vals,
                               unsigned long long mask, int limit,
                               int* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int k3 = k * k * k;
  if (t >= (long long)n * k3) return;
  const int i = (int)(t / k3), o = (int)(t - (long long)i * k3);
  const int r = k / 2;
  const int x = grid[3 * i] + o / (k * k) - r;
  const int y = grid[3 * i + 1] + (o / k) % k - r;
  const int z = grid[3 * i + 2] + o % k - r;
  int found = n;
  if (x >= 0 && y >= 0 && z >= 0 && x < limit && y < limit && z < limit) {
    const unsigned long long key = pack(cloud[i], x, y, z);
    unsigned long long slot = mix(key) & mask;
    while (true) {
      const unsigned long long have = keys[slot];
      if (have == key) {
        found = vals[slot];
        break;
      }
      if (have == kEmpty) break;
      slot = (slot + 1) & mask;
    }
  }
  out[t] = found;
}

}  // namespace

// The map out (n, k^3) int32 of n cells: grid (n, 3) int32 in
// [0, 2^16), cloud ids (n,) int32 in [0, 2^15), k odd; keys (capacity,)
// filled with all ones bits and vals (capacity,) are the table, capacity a
// power of two above n. Returns the cudaError_t.
extern "C" int lt_ptv3_neighbor_map(const int* grid, const int* cloud, int n,
                                    int k, long long* keys, int* vals,
                                    long long capacity, int* out,
                                    void* stream) {
  if (n <= 0 || k < 1 || k % 2 == 0 || capacity <= n ||
      (capacity & (capacity - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned long long mask = (unsigned long long)capacity - 1;
  unsigned long long* table = (unsigned long long*)keys;
  ptv3_neighbor_insert_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                s>>>(grid, cloud, n, table, vals, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n * k * k * k;
  ptv3_neighbor_query_kernel<<<(unsigned int)((total + kThreads - 1) /
                                              kThreads),
                               kThreads, 0, s>>>(grid, cloud, n, k, table,
                                                 vals, mask, 1 << 16, out);
  return (int)cudaGetLastError();
}
