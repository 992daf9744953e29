// Kernel D: GroupNorm's forward with its affine and leaky ReLU (0.1), fused,
// for NCHW-contiguous input in bf16 or float32, the output in its type.
//
// Replaces no Pallas kernel: flax's GroupNorm in the JAX model
// (lidar_transfer_tpu/models/rangenet.py) was XLA's fusion on the TPU. It
// was added because PyTorch's NCHW GroupNorm gives each (sample, group)
// pair one block for its statistics (RowwiseMomentsCUDAKernel): at batch 1
// RangeNet's layers have 2 to 64 groups against the card's 132 SMs, and
// those statistics took 9.1 of the 15.1 ms of device time of a darknet53
// forward at 1x64x2048. The chain it stands for is the forward of
// models/rangenet.ConvNorm under bf16 autocast: the cast of the bf16
// convolution output to float32, the statistics, the normalisation, the
// leaky ReLU and the cast back; gradient paths keep ATen's.
//
// Bound on the card: one read of the input and one write of the output,
// 4 B an element in bf16 (0.76 GB, 0.23 ms at 3.35 TB/s over the 57 layers
// of a darknet53 forward at 1x64x2048). The second read comes from L2: a
// layer is at most 8.4 MB against 50 MB of L2.
//
// Design: two kernels on the caller's stream, nothing synchronised, so
// that a CUDA graph capture records both.
//  - Statistics: each group's span (C/G channels of one sample, contiguous)
//    is cut into S chunks, sized by the wrapper (ops/group_norm.
//    stats_layout) so that the grid has about 512 blocks, four a SM,
//    whatever the number of groups: 2 groups at batch 1 get 256 each. A
//    block writes the float32 moments (count, mean, M2) of its chunk to a
//    workspace: each thread folds its 16-byte vectors in (a vector's own
//    mean and M2 in two passes, then Chan's rule: one division a vector),
//    then a tree over the block's lanes.
//  - Apply: one block a chunk of one channel's plane, so the channel, and
//    with it gamma and beta, is the block's. Each thread loads its
//    vectors first, then the block merges its group's S partials by Chan's
//    rule in a fixed order (every block of a group gets the same bits),
//    forms scale = rstd * gamma[c] and shift = beta[c] - mean * scale as
//    ATen's ComputeFusedParamsCUDAKernel does (an fma), and writes
//    leaky(x * scale + shift) rounded once to the input's type.
// Variance is biased and rstd = rsqrtf(var + eps), as ATen's; all
// arithmetic is float32. Without atomics the result is the same every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // ops/group_norm.THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kStatsUnroll = 4;           // vectors a thread loads at once
constexpr int kApplyVecs = 4;             // vectors a thread applies
constexpr float kSlope = 0.1f;
constexpr unsigned kFull = 0xffffffffu;

struct Moments {
  float n, mean, m2;
};

// Chan's rule, in the order of ATen's WelfordOps::combine
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float r = b.n / n;
  const float d = b.mean - a.mean;
  return {n, a.mean + d * r, a.m2 + b.m2 + d * d * a.n * r};
}

// The block's moments, in thread 0.
__device__ __forceinline__ Moments block_merge(Moments m) {
  __shared__ Moments warp_m[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    const Moments o{__shfl_down_sync(kFull, m.n, off),
                    __shfl_down_sync(kFull, m.mean, off),
                    __shfl_down_sync(kFull, m.m2, off)};
    m = merge(m, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_m[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warp_m[lane] : Moments{0.f, 0.f, 0.f};
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      const Moments o{__shfl_down_sync(kFull, m.n, off),
                      __shfl_down_sync(kFull, m.mean, off),
                      __shfl_down_sync(kFull, m.m2, off)};
      m = merge(m, o);
    }
  }
  return m;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements in one load or store (16 bytes of the input type when V > 1)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// the moments of one vector: its mean, then the squares about it
template <typename T, int V>
__device__ __forceinline__ Moments moments_of(const Pack<T, V>& p) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) s += to_f32(p.v[j]);
  const float mean = s / V;
  float m2 = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = to_f32(p.v[j]) - mean;
    m2 += d * d;
  }
  return {(float)V, mean, m2};
}

// Block b: chunk b % S of group b / S, elements [k * chunk, min(span,
// (k + 1) * chunk)) of the group's span; chunk and span are multiples of V.
// part: (groups * S, 3) float32, (count, mean, M2) a chunk.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    group_norm_stats(const T* __restrict__ x, long long span,
                     long long chunk, int S, float* __restrict__ part) {
  const long long group = blockIdx.x / S;
  const long long begin = (blockIdx.x % S) * chunk;
  const long long end = min(begin + chunk, span);
  const Pack<T, V>* p =
      reinterpret_cast<const Pack<T, V>*>(x + group * span + begin);
  const long long nvec = (end - begin) / V;
  Moments m{0.f, 0.f, 0.f};
  for (long long i = threadIdx.x; i < nvec; i += kThreads * kStatsUnroll) {
    Pack<T, V> v[kStatsUnroll];
#pragma unroll
    for (int u = 0; u < kStatsUnroll; ++u)
      if (i + u * kThreads < nvec) v[u] = p[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kStatsUnroll; ++u)
      if (i + u * kThreads < nvec) m = merge(m, moments_of<T, V>(v[u]));
  }
  m = block_merge(m);
  if (threadIdx.x == 0) {
    float* o = part + 3ll * blockIdx.x;
    o[0] = m.n;
    o[1] = m.mean;
    o[2] = m.m2;
  }
}

// Block b: chunk b % P of plane b / P (plane = n * C + c), elements
// [k * L, min(HW, (k + 1) * L)) with L = kThreads * kApplyVecs * V; HW is a
// multiple of V. mean, rstd: (N * G,), written by the first block of each
// group.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    group_norm_apply(const T* __restrict__ x,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const float* __restrict__ part, int C, int cpg,
                     long long HW, int P, int S, float eps,
                     T* __restrict__ y, float* __restrict__ mean_out,
                     float* __restrict__ rstd_out) {
  constexpr long long kChunk = (long long)kThreads * kApplyVecs * V;
  const long long plane = blockIdx.x / P;
  const int k = blockIdx.x % P;
  const int c = (int)(plane % C);
  const long long ng = plane / cpg;
  const long long begin = k * kChunk;
  const long long nvec = (min(begin + kChunk, HW) - begin) / V;
  const long long base = plane * HW + begin;
  const Pack<T, V>* px = reinterpret_cast<const Pack<T, V>*>(x + base);
  Pack<T, V>* py = reinterpret_cast<Pack<T, V>*>(y + base);

  // the loads first: they do not wait for the statistics
  Pack<T, V> v[kApplyVecs];
#pragma unroll
  for (int u = 0; u < kApplyVecs; ++u) {
    const long long i = threadIdx.x + u * kThreads;
    if (i < nvec) v[u] = px[i];
  }

  Moments m{0.f, 0.f, 0.f};
  const float* gp = part + 3ll * ng * S;
  for (int i = threadIdx.x; i < S; i += kThreads)
    m = merge(m, Moments{gp[3 * i], gp[3 * i + 1], gp[3 * i + 2]});
  m = block_merge(m);
  __shared__ float s_scale, s_shift;
  if (threadIdx.x == 0) {
    const float rstd = rsqrtf(m.m2 / m.n + eps);
    const float scale = rstd * gamma[c];
    s_scale = scale;
    s_shift = __fmaf_rn(-scale, m.mean, beta[c]);
    if (k == 0 && c % cpg == 0) {
      mean_out[ng] = m.mean;
      rstd_out[ng] = rstd;
    }
  }
  __syncthreads();
  const float scale = s_scale, shift = s_shift;

#pragma unroll
  for (int u = 0; u < kApplyVecs; ++u) {
    const long long i = threadIdx.x + u * kThreads;
    if (i >= nvec) break;
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float h = __fmaf_rn(scale, to_f32(v[u].v[j]), shift);
      o.v[j] = from_f32<T>(h > 0.f ? h : h * kSlope);
    }
    py[i] = o;
  }
}

template <typename T, int V>
int launch(const void* x, const float* gamma, const float* beta,
           long long N, int C, int G, long long HW, float eps, int S,
           long long chunk, float* part, void* y, float* mean, float* rstd,
           cudaStream_t s) {
  const int cpg = C / G;
  const long long span = (long long)cpg * HW;
  const long long groups = N * G;
  constexpr long long kChunk = (long long)kThreads * kApplyVecs * V;
  const long long P = (HW + kChunk - 1) / kChunk;
  if (S < 1 || chunk < 1 || chunk % V || HW % V || (S - 1) * chunk >= span ||
      (long long)S * chunk < span || groups * S >= (1ll << 31) ||
      N * C * P >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  group_norm_stats<T, V><<<(unsigned)(groups * S), kThreads, 0, s>>>(
      static_cast<const T*>(x), span, chunk, S, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_norm_apply<T, V><<<(unsigned)(N * C * P), kThreads, 0, s>>>(
      static_cast<const T*>(x), gamma, beta, part, C, cpg, HW, (int)P, S,
      eps, static_cast<T*>(y), mean, rstd);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec, const void* x, const float* gamma,
               const float* beta, long long N, int C, int G, long long HW,
               float eps, int S, long long chunk, float* part, void* y,
               float* mean, float* rstd, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec == V)
    return launch<T, V>(x, gamma, beta, N, C, G, HW, eps, S, chunk, part,
                        y, mean, rstd, s);
  if (vec == 1)
    return launch<T, 1>(x, gamma, beta, N, C, G, HW, eps, S, chunk, part,
                        y, mean, rstd, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y: (N, C, HW) contiguous, bf16 (bf16 != 0) or float32; gamma, beta:
// (C,) float32. vec: elements a load, 16 / sizeof(element) or 1 (x
// 16-byte aligned and HW a multiple of it for the former). S, chunk: the
// statistics' chunks a group and their length (ops/group_norm.
// stats_layout); part: (N * G * S, 3) float32 scratch; mean, rstd:
// (N * G,) float32. Returns the cudaError_t.
extern "C" int lt_group_norm(const void* x, const float* gamma,
                             const float* beta, long long N, int C, int G,
                             long long HW, float eps, int bf16, int vec,
                             int S, long long chunk, float* part, void* y,
                             float* mean, float* rstd, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 0 || C <= 0 || G <= 0 || C % G || HW <= 0)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_vec<__nv_bfloat16>(vec, x, gamma, beta, N, C, G, HW, eps,
                                     S, chunk, part, y, mean, rstd, s);
  return launch_vec<float>(vec, x, gamma, beta, N, C, G, HW, eps, S, chunk,
                           part, y, mean, rstd, s);
}
