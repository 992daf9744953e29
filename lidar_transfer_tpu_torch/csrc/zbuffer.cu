// Kernel A: the z-buffer (per-pixel nearest point, lowest index on ties).
//
// Replaces: lidar_transfer_tpu/ops/projection.py::_winner_sort, the stable
// (pixel, key) sort whose run starts are the winners. On the TPU that is an
// XLA sort, not a Pallas kernel; every frame runs it twice (the source
// projection and the target assemble in ops/splat.py::_target_assemble).
//
// One 64-bit word per pixel holds (float bits of key << 32) | index.
// Keys are non-negative floats (depth > 0, or a squared distance >= +0), so
// their bit patterns order as the floats do, and the low word breaks exact
// ties towards the lowest point index: atomicMin on the packed word selects
// exactly the sort's run start. Invalid points carry pix == npix and are
// skipped, as the sort's overflow segment is.
//
// Bound on the card: none worth the name. N scattered 64-bit atomics and a
// pass over the npix words (about 1 MB each for a 64x2048 image) live in L2
// and take a few microseconds; what a call costs is the number of device
// operations the host must issue for it, in frames whose whole cost is the
// host issuing small operations. So the design is about operations a call:
//  - the scratch belongs to the caller's workspace
//    (ops/projection.ZBufferWorkspace), not to the call: nothing is
//    allocated or initialised per call;
//  - two kernels a call: the scratch is all-ones when a call starts (the
//    workspace fills it once, when it allocates), the minimum kernel takes
//    the atomics, and the decode kernel writes the winners and puts all-ones
//    back into every word it read, so the next call finds the scratch clean
//    whatever its npix.
// One cooperative kernel (initialise, minimum, decode, a grid-wide barrier
// between the phases) was measured against this on an H100: 6.0 us of device
// time a call against 3.1, two barriers costing more than a second launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ void take_min(const int* __restrict__ pix,
                                         const float* __restrict__ key,
                                         long long i, long long npix,
                                         unsigned long long* best) {
  const int p = pix[i];
  if (p < 0 || p >= npix) return;
  const unsigned long long packed =
      ((unsigned long long)__float_as_uint(key[i]) << 32) |
      (unsigned long long)(unsigned int)i;
  atomicMin(best + p, packed);
}

__device__ __forceinline__ int winner_of(unsigned long long b) {
  return b == kEmpty ? -1 : (int)(unsigned int)(b & 0xffffffffull);
}

__global__ void zbuffer_min_kernel(const int* __restrict__ pix,
                                   const float* __restrict__ key,
                                   long long n, long long npix,
                                   unsigned long long* __restrict__ best) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) take_min(pix, key, i, npix, best);
}

// Writes the winners and leaves the scratch all-ones.
__global__ void zbuffer_decode_clean_kernel(
    unsigned long long* __restrict__ best, long long npix,
    int* __restrict__ win) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= npix) return;
  const unsigned long long b = best[i];
  win[i] = winner_of(b);
  if (b != kEmpty) best[i] = kEmpty;
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// win[p] = index of the valid point with the smallest key in pixel p, or -1.
// scratch: at least npix 64-bit words, the first npix all-ones on entry; they
// are all-ones again when the work on the stream is done. Returns the
// cudaError_t of the launches.
extern "C" int lt_zbuffer_winners(const int* pix, const float* key,
                                  long long n, long long npix,
                                  unsigned long long* scratch, int* win,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (npix <= 0) return (int)cudaSuccess;
  if (n > 0) {
    zbuffer_min_kernel<<<blocks_for(n), kThreads, 0, s>>>(pix, key, n, npix,
                                                          scratch);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  zbuffer_decode_clean_kernel<<<blocks_for(npix), kThreads, 0, s>>>(
      scratch, npix, win);
  return (int)cudaGetLastError();
}
