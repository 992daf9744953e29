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
// Measured and not kept as the path: the matrix in the shared memory of one
// thread block cluster (8 or 16 blocks, each owning a band of rows, zeroed
// in place, counted into through distributed shared memory, written out
// after a cluster barrier; no memset, no atomic in device memory, one
// device operation). Its kernel stays below as a variant that is compiled
// only with -DLT_CONFUSION_CLUSTER=8 or =16 (LT_NVCC_EXTRA of _build.py;
// the entry then takes it for every C whose band fits a block), so that
// the measurement can be made again:
//     LT_NVCC_EXTRA=-DLT_CONFUSION_CLUSTER=16 \
//         python -m lidar_transfer_tpu_torch.probes.cases small
// Device time of a call on an H100, N = 131,072, C = 260: 13.6 us (16
// blocks) to 14.2 (8) on the skewed labels and 18.0 to 26.5 on uniform
// ones, against 4.9 and 4.3 for the two operations of the path above (7.3
// and 4.2 before the block's own counts). An add into another block's
// shared memory arrives at about one per 2.5 clocks and SM; with every add
// made local (wrong counts, for the timing only) 16 SMs still took 7.7 us,
// because 8 or 16 SMs match and count the samples that the path above
// spreads over 132; and the cluster's launch, two barriers and write-out
// alone took 3.3 us at N = 0, where the memset takes 1.1. No N or C was
// found where it won. One device operation over all 132 SMs would need a
// barrier across the grid between the zeroing and the counting, which the
// z-buffer measured at more than a second launch costs (zbuffer.cu).
//
// Bound on the card: 8 B read a sample and 4 B written a cell, under half a
// microsecond at the compare path's size: less than an empty kernel launch
// (0.9 us), which is the floor of any kernel. PERF.md has the measurements.

#ifdef LT_CONFUSION_CLUSTER
#include <cooperative_groups.h>
#include <stdint.h>
#endif
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


#ifdef LT_CONFUSION_CLUSTER
// ---- the cluster variant (measured and not kept, see the header) ----
namespace cg = cooperative_groups;

constexpr int kCluster = LT_CONFUSION_CLUSTER;   // 8 is portable, 16 not
constexpr int kClusterThreads = 1024;
constexpr size_t kMaxShared = 232448;   // 227 KB a block
constexpr int kDiagCopies = 8;          // copies of the diagonal a block
constexpr int kBatch = 4;               // steps whose loads are issued first

// The length of the run of equal cells this lane heads, 0 inside a run.
__device__ __forceinline__ int run_length(int cell, int lane) {
  const int prev = __shfl_up_sync(0xffffffffu, cell, 1);
  const bool head = lane == 0 || cell != prev;
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  const unsigned above = lane == 31 ? 0u : heads & ~((2u << lane) - 1u);
  return head ? (above ? __ffs(above) - 1 : 32) - lane : 0;
}

// rows: the rows of the matrix a block owns; vec: pred and tgt are 16-byte
// aligned. Shared memory: the block's band (rows x n_classes), then
// kDiagCopies copies of the diagonal (n_classes each).
__global__ void __launch_bounds__(kClusterThreads)
confusion_cluster_kernel(const int* __restrict__ pred,
                         const int* __restrict__ tgt, long long n,
                         int n_classes, int rows, int vec,
                         int* __restrict__ out) {
  extern __shared__ int counts[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int band = rows * n_classes;
  int* diag = counts + band;
  for (int k = threadIdx.x; k < band + kDiagCopies * n_classes;
       k += blockDim.x)
    counts[k] = 0;
  cluster.sync();

  int* my_diag = diag + (threadIdx.x >> 5) % kDiagCopies * n_classes;
  const long long groups = (n + 3) / 4;            // four samples a thread
  const long long stride = (long long)kCluster * blockDim.x;
  // the bound is uniform across the block: every lane reaches the shuffles
  for (long long base = (long long)rank * blockDim.x; base < groups;
       base += kBatch * stride) {
    int p[kBatch][4], t[kBatch][4];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {             // every load first
      const long long g = base + b * stride + threadIdx.x;
      if (vec && 4 * g + 3 < n) {
        const int4 pa = __ldg(reinterpret_cast<const int4*>(pred) + g);
        const int4 ta = __ldg(reinterpret_cast<const int4*>(tgt) + g);
        p[b][0] = pa.x; p[b][1] = pa.y; p[b][2] = pa.z; p[b][3] = pa.w;
        t[b][0] = ta.x; t[b][1] = ta.y; t[b][2] = ta.z; t[b][3] = ta.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool in = 4 * g + k < n;
          p[b][k] = in ? pred[4 * g + k] : -1;
          t[b][k] = in ? tgt[4 * g + k] : -1;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int pk = p[b][k], tk = t[b][k];
        const int cell = ((unsigned)pk < (unsigned)n_classes &&
                          (unsigned)tk < (unsigned)n_classes)
                             ? pk * n_classes + tk : -1;
        const int len = run_length(cell, lane);
        if (cell >= 0 && len > 0) {
          if (pk == tk) {
            atomicAdd(my_diag + pk, len);
          } else {
            const int owner = pk / rows;
            atomicAdd(cluster.map_shared_rank(counts, owner) +
                          (cell - owner * band), len);
          }
        }
      }
    }
  }
  __syncthreads();
  // the diagonal's copies, summed, go to the owners of their rows
  for (int c = threadIdx.x; c < n_classes; c += blockDim.x) {
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kDiagCopies; ++k) sum += diag[k * n_classes + c];
    if (sum) {
      const int owner = c / rows;
      atomicAdd(cluster.map_shared_rank(counts, owner) +
                    ((c - owner * rows) * n_classes + c), sum);
    }
  }
  cluster.sync();   // no block leaves before its peers' adds have landed

  // a band past the matrix's last row (C < the cluster's size) is empty
  const int mine = max(0, min(rows, n_classes - rank * rows)) * n_classes;
  int* dst = out + (long long)rank * band;
  for (int k = threadIdx.x; k < mine; k += blockDim.x) dst[k] = counts[k];
}

// Launches the cluster variant; *taken = 0 and nothing launched where a
// block's band does not fit its shared memory.
cudaError_t launch_cluster(const int* pred, const int* tgt, long long n,
                           int n_classes, int* out, cudaStream_t s,
                           int* taken) {
  const int rows = (n_classes + kCluster - 1) / kCluster;
  const size_t bytes = (size_t)(rows + kDiagCopies) * n_classes * sizeof(int);
  *taken = bytes <= kMaxShared;
  if (!*taken) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      confusion_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxShared);
  if (err == cudaSuccess && kCluster > 8)
    err = cudaFuncSetAttribute(confusion_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int vec = (((uintptr_t)pred | (uintptr_t)tgt) & 15) == 0 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, confusion_cluster_kernel, pred, tgt, n,
                           n_classes, rows, vec, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}
#endif  // LT_CONFUSION_CLUSTER

}  // namespace

// out: (n_classes, n_classes) int32, zeroed here on the stream.
extern "C" int lt_confusion(const int* pred, const int* tgt, long long n,
                            int n_classes, int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#ifdef LT_CONFUSION_CLUSTER
  int taken = 0;
  const cudaError_t cerr = launch_cluster(pred, tgt, n, n_classes, out, s,
                                          &taken);
  if (taken || cerr != cudaSuccess) return (int)cerr;
#endif
  const size_t bytes = (size_t)n_classes * n_classes * sizeof(int);
  cudaError_t err = cudaMemsetAsync(out, 0, bytes, s);
  if (err != cudaSuccess || n <= 0) return (int)err;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  confusion_kernel<<<(unsigned int)blocks, kThreads, 0, s>>>(pred, tgt, n,
                                                             n_classes, out);
  return (int)cudaGetLastError();
}
