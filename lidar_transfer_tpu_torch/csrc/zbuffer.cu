// Kernel A: the z-buffer (per-pixel nearest point, lowest index on ties).
//
// Replaces: lidar_transfer_tpu/ops/projection.py::_winner_sort, the stable
// (pixel, key) sort whose run starts are the winners. On the TPU that is an
// XLA sort, not a Pallas kernel; every frame runs it twice (the source
// projection and the target assemble in ops/splat.py::_target_assemble).
//
// Design: one 64-bit word per pixel holds (float bits of key << 32) | index.
// Keys are non-negative floats (depth > 0, or a squared distance >= +0), so
// their bit patterns order as the floats do, and the low word breaks exact
// ties towards the lowest point index: atomicMin on the packed word selects
// exactly the sort's run start. Invalid points carry pix == npix and are
// skipped, as the sort's overflow segment is.
//
// Bound on the card: N scattered 64-bit atomics plus one pass over the
// npix words (about 1 MB each for a 64x2048 image); both live in L2.
// The sort it replaces moves O(N log N) keys through device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void zbuffer_min_kernel(const int* __restrict__ pix,
                                   const float* __restrict__ key,
                                   long long n, long long npix,
                                   unsigned long long* __restrict__ best) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = pix[i];
  if (p < 0 || p >= npix) return;
  const unsigned long long packed =
      ((unsigned long long)__float_as_uint(key[i]) << 32) |
      (unsigned long long)(unsigned int)i;
  atomicMin(best + p, packed);
}

__global__ void zbuffer_decode_kernel(const unsigned long long* __restrict__ best,
                                      long long npix, int* __restrict__ win) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= npix) return;
  const unsigned long long b = best[i];
  win[i] = b == ~0ull ? -1 : (int)(unsigned int)(b & 0xffffffffull);
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// win[p] = index of the valid point with the smallest key in pixel p, or -1.
// scratch: npix 64-bit words. Returns the cudaError_t of the launches.
extern "C" int lt_zbuffer_winners(const int* pix, const float* key,
                                  long long n, long long npix,
                                  unsigned long long* scratch, int* win,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (npix <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaMemsetAsync(scratch, 0xff,
                                    (size_t)npix * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    zbuffer_min_kernel<<<blocks_for(n), kThreads, 0, s>>>(pix, key, n, npix,
                                                          scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  zbuffer_decode_kernel<<<blocks_for(npix), kThreads, 0, s>>>(scratch, npix,
                                                              win);
  return (int)cudaGetLastError();
}
