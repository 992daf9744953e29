// Kernel F: the four serialization codes of Point Transformer V3 (z,
// z-trans, hilbert, hilbert-trans) of every point, in one pass.
//
// Replaces no Pallas kernel: the JAX package has no point model. PyTorch
// has no call that computes a Morton or Hilbert code; composed of its
// elementwise calls, the Hilbert code alone is some 15 operations a bit
// level over (N,) tensors (ops/serialize.encode_plain).
//
// code = cloud << 3b | enc(g), where g is the point's integer cell (x, y,
// z), b its bit depth and enc interleaves three b-bit words with x in the
// highest bit of each triple (the bit-spreading of csrc/mesh_bvh.cu's
// Morton keys, here to 21 bits). "trans" swaps x and y before encoding.
// The Hilbert code interleaves Skilling's transpose of (x, y, z): J.
// Skilling, "Programming the Hilbert curve", AIP Conf. Proc. 707, 2004.
//
// Bound on the card: one read of the cells and cloud ids (16 B a point)
// and one write of four codes (32 B a point).
//
// Design: one thread a point; the codes are written order-major, (4, N),
// so that each order's row is contiguous for the sort that follows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long spread21(unsigned long long x) {
  x &= 0x1fffffull;
  x = (x | (x << 32)) & 0x1f00000000ffffull;
  x = (x | (x << 16)) & 0x1f0000ff0000ffull;
  x = (x | (x << 8)) & 0x100f00f00f00f00full;
  x = (x | (x << 4)) & 0x10c30c30c30c30c3ull;
  return (x | (x << 2)) & 0x1249249249249249ull;
}

__device__ __forceinline__ unsigned long long interleave(unsigned a,
                                                         unsigned b,
                                                         unsigned c) {
  return (spread21(a) << 2) | (spread21(b) << 1) | spread21(c);
}

// Skilling's AxestoTranspose of (a, b, c) at `bits` bits, interleaved.
__device__ __forceinline__ unsigned long long hilbert(unsigned a, unsigned b,
                                                      unsigned c, int bits) {
  unsigned X[3] = {a, b, c};
  const unsigned M = 1u << (bits - 1);
  for (unsigned Q = M; Q > 1; Q >>= 1) {
    const unsigned P = Q - 1;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (X[i] & Q) {
        X[0] ^= P;
      } else {
        const unsigned t = (X[0] ^ X[i]) & P;
        X[0] ^= t;
        X[i] ^= t;
      }
    }
  }
  X[1] ^= X[0];
  X[2] ^= X[1];
  unsigned t = 0;
  for (unsigned Q = M; Q > 1; Q >>= 1)
    if (X[2] & Q) t ^= Q - 1;
  return interleave(X[0] ^ t, X[1] ^ t, X[2] ^ t);
}

__global__ void __launch_bounds__(kThreads)
    ptv3_serialize_kernel(const int* __restrict__ grid,
                          const int* __restrict__ cloud, long long n,
                          int bits, long long* __restrict__ codes) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned x = (unsigned)grid[3 * i], y = (unsigned)grid[3 * i + 1],
                 z = (unsigned)grid[3 * i + 2];
  const unsigned long long hi = (unsigned long long)(unsigned)cloud[i]
                                << (3 * bits);
  codes[i] = (long long)(hi | interleave(x, y, z));
  codes[n + i] = (long long)(hi | interleave(y, x, z));
  codes[2 * n + i] = (long long)(hi | hilbert(x, y, z, bits));
  codes[3 * n + i] = (long long)(hi | hilbert(y, x, z, bits));
}

}  // namespace

// The codes (4, n) of n points: cells grid (n, 3) int32 in [0, 2^bits),
// cloud ids (n,) int32, 1 <= bits <= 21. Returns the cudaError_t.
extern "C" int lt_ptv3_serialize(const int* grid, const int* cloud,
                                 long long n, int bits, long long* codes,
                                 void* stream) {
  if (n <= 0 || bits < 1 || bits > 21) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  ptv3_serialize_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      grid, cloud, n, bits, codes);
  return (int)cudaGetLastError();
}
