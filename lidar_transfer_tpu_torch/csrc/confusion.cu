// Kernel B: the confusion histogram (rows = pred, cols = target).
//
// Replaces: lidar_transfer_tpu/metrics/confusion.py::confusion_pallas
// (body _confusion_kernel), which builds bf16 one-hot tiles in VMEM and
// multiplies them on the MXU with f32 accumulation into a VMEM block.
//
// Exact int32 counts; ids outside [0, C), negatives included, are dropped.
//
// Design: a memset of the (C, C) matrix, then one thread a sample, an exact
// atomicAdd into the matrix in device memory, which stays in L2 (C = 260
// raw SemanticKITTI ids gives a 270 KB matrix, over the 227 KB of shared
// memory a block may use, so a block keeps no private copy of it).
//  - Labels are heavily skewed (a few ids hold most points), so lanes of a
//    warp that hit the same cell are merged first (__match_any_sync) and
//    one lane adds their count.
//  - Most samples lie on the diagonal, in a handful of cells, and the adds
//    of every warp to one such cell queue up in L2: with labels of 7 ids,
//    80 % of them on the diagonal, that queue was the call's time, 7.3 us
//    at N = 131,072 against 4.2 with uniform labels (memset included). A
//    block therefore counts the diagonal in its own shared memory (C ints,
//    C <= 4096) and adds each class it met once to the matrix when it is
//    done: 4.9 us on the skewed labels, 4.3 on uniform ones (the zeroing
//    and the flush cost them 0.1).
//  - A matrix of at most 4096 cells (C <= 64, the class counts of
//    metrics/ioueval.py) is all hot: at C = 20 the 400 cells took 25 us
//    with uniform labels. A block counts the whole of such a matrix in its
//    shared memory and adds each cell it met once.
//
// Measured and not kept: the matrix in the shared memory of one thread block
// cluster (8 or 16 blocks, each owning a band of rows, counted into through
// distributed shared memory, written out after a cluster barrier; no memset,
// one device operation). On an H100 at N = 131,072, C = 260 it took 13.6 to
// 26.5 us against the path's 4.3 to 4.9: 8 or 16 SMs match and count what
// the path spreads over 132, remote shared-memory adds land at about one per
// 2.5 clocks and SM, and the launch, two barriers and write-out alone took
// 3.3 us at N = 0. No N or C was found where it won. One operation over all
// 132 SMs would need a grid barrier, which costs more than a second launch
// (zbuffer.cu).
//
// Bound on the card: 8 B read a sample and 4 B written a cell, under half a
// microsecond at the compare path's size: less than an empty kernel launch
// (0.9 us), which is the floor of any kernel. PERF.md has the measurements.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
constexpr int kLocal = 4096;     // counts a block keeps in shared memory

__global__ void confusion_kernel(const int* __restrict__ pred,
                                 const int* __restrict__ tgt, long long n,
                                 int n_classes, int* __restrict__ out) {
  // a block's own counts: the whole matrix if it has at most kLocal cells,
  // else its diagonal if that has
  __shared__ int local[kLocal];
  const bool own_all = n_classes * n_classes <= kLocal;
  const bool own_diag = !own_all && n_classes <= kLocal;
  const int n_local = own_all ? n_classes * n_classes
                              : own_diag ? n_classes : 0;
  for (int k = threadIdx.x; k < n_local; k += blockDim.x) local[k] = 0;
  if (n_local) __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop bound is uniform across a warp, so every lane reaches the
  // __match_any_sync below
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    int p = -1, cell = -1;
    if (i < n) {
      p = pred[i];
      const int t = tgt[i];
      if ((unsigned)p < (unsigned)n_classes &&
          (unsigned)t < (unsigned)n_classes)
        cell = p * n_classes + t;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, cell);
    const int leader = __ffs(peers) - 1;
    if (cell >= 0 && (int)(threadIdx.x & 31) == leader) {
      if (own_all)
        atomicAdd(local + cell, __popc(peers));
      else if (own_diag && cell == p * n_classes + p)
        atomicAdd(local + p, __popc(peers));
      else
        atomicAdd(out + cell, __popc(peers));
    }
  }
  if (n_local) __syncthreads();
  const int pitch = own_all ? 1 : n_classes + 1;   // of a local count in out
  for (int k = threadIdx.x; k < n_local; k += blockDim.x)
    if (local[k]) atomicAdd(out + (long long)k * pitch, local[k]);
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
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  confusion_kernel<<<(unsigned int)blocks, kThreads, 0, s>>>(pred, tgt, n,
                                                             n_classes, out);
  return (int)cudaGetLastError();
}
