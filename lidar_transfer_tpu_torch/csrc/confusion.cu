// Kernel B: the confusion histogram (rows = pred, cols = target).
//
// Replaces: lidar_transfer_tpu/metrics/confusion.py::confusion_pallas
// (body _confusion_kernel), which builds bf16 one-hot tiles in VMEM and
// multiplies them on the MXU with f32 accumulation.
//
// Design: one thread per sample, an exact int32 atomicAdd into the (C, C)
// matrix in device memory. C = 260 raw SemanticKITTI ids gives a 270 KB
// matrix, over the 227 KB of shared memory a block may use, so there is no
// per-block private copy. Labels are heavily skewed (background dominates),
// so lanes of a warp that hit the same cell are merged first
// (__match_any_sync) and one lane adds their count. Ids outside [0, C),
// negatives included, are dropped.
//
// Bound on the card: 8 B read per sample plus the atomics; the matrix stays
// in L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void confusion_kernel(const int* __restrict__ pred,
                                 const int* __restrict__ tgt, long long n,
                                 int n_classes, int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop bound is uniform across a warp, so every lane reaches the
  // __match_any_sync below
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    int cell = -1;
    if (i < n) {
      const int p = pred[i];
      const int t = tgt[i];
      if ((unsigned)p < (unsigned)n_classes &&
          (unsigned)t < (unsigned)n_classes)
        cell = p * n_classes + t;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, cell);
    const int leader = __ffs(peers) - 1;
    if (cell >= 0 && (int)(threadIdx.x & 31) == leader)
      atomicAdd(out + cell, __popc(peers));
  }
}

}  // namespace

// out: (n_classes, n_classes) int32, zeroed here on the stream.
extern "C" int lt_confusion(const int* pred, const int* tgt, long long n,
                            int n_classes, int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t bytes = (size_t)n_classes * n_classes * sizeof(int);
  cudaError_t err = cudaMemsetAsync(out, 0, bytes, s);
  if (err != cudaSuccess || n <= 0) return (int)err;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  confusion_kernel<<<(unsigned int)blocks, kThreads, 0, s>>>(pred, tgt, n,
                                                             n_classes, out);
  return (int)cudaGetLastError();
}
