// Raymarch kernel: target rays through the fused TSDF volume, one thread a
// ray, its walk along the ray taken apart from its crossing test; and the
// packing of the coarse occupancy into bits that the walk reads.
//
// Replaces: lidar_transfer_tpu/ops/raycast.py::_raycast_impl (:234, an XLA
// lax.while_loop that advances every ray in lockstep until all are done;
// not a Pallas kernel). In plain PyTorch each step of that loop is some 30
// elementwise launches and a host read of done.all(), up to
// ceil(|dims| / fine_step) + 64 steps (about 1,500 at 2048x2048x208 with
// the engine's fine step of 2 voxels); here each thread walks its own ray
// until it is done, in one launch.
//
// What it computes, in ops/raycast.py::raycast_plain's float32 order
// (-fmad=false, IEEE divisions), so the plain version is its oracle:
//  - the slab entry and exit of the volume's box; start at
//    t0 = max(t_near, 0) + 1e-4, seeded with the field sampled there;
//  - each step samples the floor voxel: the tsdf where the position is
//    inside and its occupancy block is set, else 1; a crossing is
//    prev > 0 && val <= 0, with the linear t_hit; the step is fine where
//    the block is occupied, else coarse; the ray stops on a crossing, past
//    min(t_far, 1e4) or at max_steps;
//  - a hit is refined by 10 bisection steps on the trilinear field (8
//    corners) inside the bracket widened by 2 voxels, trusted only if the
//    bracket straddles;
//  - outputs: range, label (i32), remission (f32) read from the storage
//    dtype (float32, or the compact bf16 / int16 / bf16, never converted
//    as a volume), endpoints and hit.
//
// Bound on the card: bytes (probes/bounds.py raymarch): the distinct
// 32-byte sectors that the march's data touches, each once, the rays and
// the outputs; some 0.02 ms for the reference frame. The kernel is far
// from it because every ray is resident from the start (65,536 threads
// fill a fraction of the card's warp slots): it lasts as long as its
// longest rays' chains of dependent samples (half the rays take the same
// time; some 590 samples, about 1,000 cycles each on the H100), and a
// warp waits at a sample for whichever of its lanes waits longest. The
// design takes what it can off that chain:
//  - the next step depends on the occupancy alone, so a thread walks its
//    t sequence (the same float32 adds of dt_fine / dt_coarse, one by one,
//    with the same t_far and max_steps cut-offs) kAhead samples ahead of
//    the tsdf, keeping each sample's t and flat voxel index in registers;
//    then it issues the tsdf loads of the occupied ones together (one
//    device memory latency a batch, not one a sample; an unoccupied sample
//    loads nothing and its value is 1), and tests the crossings in order
//    with the plain rule. A crossing ends the ray and drops the rest of
//    the batch;
//  - the occupancy is read as bits (pack_kernel, launched by the wrapper
//    once a march): a 32-bit word is a brick of 4 x 4 x 2 cells, 1.7 MB
//    for the reference's 512 x 512 x 52 cells; a ray stays in one word for
//    several steps, so the thread keeps its last word and loads only when
//    the word changes, and neighbouring rays of a warp share words and
//    sectors;
//  - the tsdf gathers are streamed (gather_tsdf) so that they do not push
//    the words out of the caches.
// What is left on the chain is a sample's arithmetic and the occupancy
// word a warp's lanes change between them at almost every sample.
// Measured and not kept (PERF.md): walking 8 or 32 samples ahead; walking
// the next batch while the last one's loads are in flight; a batch that
// assumes its step and loads its 16 words together; a division-free
// floor; prefetching the word ahead; an L2 evict-last policy on the words;
// a cache of the refinement's corners.
// The seed sample at t0 is the loop's step 0 too, so its value is step 0's
// (the plain loop samples t0 twice; step 0 cannot cross).

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// samples a thread walks ahead of their tsdf loads
// (ops/raycast_cuda.AHEAD)
constexpr int kAhead = 16;
constexpr int kPackThreads = 256;

struct MarchArgs {
  int R, origin_stride;
  int X, Y, Z, block, max_steps;
  int wy, wz;  // words of the packed occupancy along y and z
  float lo[3], hi[3];
  float vox, dt_fine, dt_coarse, margin;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TsdfT>
__device__ __forceinline__ float tsdf_at(const TsdfT* tsdf, unsigned i) {
  return to_f32(__ldg(tsdf + i));
}

// The march's tsdf gathers, streamed (evict first from L1 and L2): each
// sector is read by a few neighbouring samples at most, and the occupancy
// words the walk reads at every sample stay cached.
template <typename TsdfT>
__device__ __forceinline__ float gather_tsdf(const TsdfT* tsdf, unsigned i) {
  return to_f32(__ldcs(tsdf + i));
}

// origin + dir * t per axis, then the grid coordinate (pos - lo) / vox
__device__ __forceinline__ void grid_of(const float o[3], const float d[3],
                                        float t, const MarchArgs& a,
                                        float g[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) g[k] = (o[k] + d[k] * t - a.lo[k]) / a.vox;
}

// The bit of cell (x, y, z): bit ((x & 3) * 4 + (y & 3)) * 2 + (z & 1) of
// word ((x >> 2) * wy + (y >> 2)) * wz + (z >> 1)
// (ops/raycast.pack_occupancy_plain).
__device__ __forceinline__ int word_of(int x, int y, int z, int wy,
                                       int wz) {
  return ((x >> 2) * wy + (y >> 2)) * wz + (z >> 1);
}
__device__ __forceinline__ int bit_of(int x, int y, int z) {
  return (((x & 3) << 2) | (y & 3)) << 1 | (z & 1);
}

// One walk sample at t: the flat index of its floor voxel (clamped into
// the volume), whether the position is inside, and the occupancy word and
// bit of its cell. kBlock: the block in voxels, 0 for a.block.
template <int kBlock>
__device__ __forceinline__ void sample_cell(const float o[3],
                                            const float d[3], float t,
                                            const MarchArgs& a,
                                            unsigned& flat, bool& inside,
                                            int& word, int& bit) {
  float g[3];
  grid_of(o, d, t, a, g);
  const int dims[3] = {a.X, a.Y, a.Z};
  int gi[3], ci[3];
  inside = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int v = (int)floorf(g[k]);
    inside = inside && v >= 0 && v < dims[k];
    gi[k] = min(max(v, 0), dims[k] - 1);
    ci[k] = kBlock ? gi[k] / kBlock : gi[k] / a.block;
  }
  flat = ((unsigned)gi[0] * (unsigned)a.Y + (unsigned)gi[1]) *
             (unsigned)a.Z +
         (unsigned)gi[2];
  word = word_of(ci[0], ci[1], ci[2], a.wy, a.wz);
  bit = bit_of(ci[0], ci[1], ci[2]);
}

// A thread's walk along its ray: t of the next sample, the samples taken,
// whether the last one is taken (the plain loop's done before its first
// step, or its cut-offs), and its last occupancy word (kept while the
// walk's cells stay in it).
struct Walk {
  float t;
  int steps;
  bool ended;
  int word_idx;
  uint32_t word;
};

// kAhead consecutive samples of a walk: t, the flat voxel index, whether
// occupied and whether taken (live), and the value the crossing test reads
// (the tsdf where occupied, else 1).
struct Batch {
  float t[kAhead];
  unsigned flat[kAhead];
  float v[kAhead];
  bool occ[kAhead], live[kAhead];
};

// The crossing test's state: the sample before the one tested (none yet
// before the first: the seed sample is step 0's), and the hit.
struct Crossing {
  float prev_t, prev_val;
  bool seeded, hit;
  float hit_t, hit_lo, hit_hi;
  unsigned hit_flat;
};

// Walk the next kAhead samples by the occupancy alone, with the plain
// loop's float32 adds and cut-offs; samples past the walk's end are not
// live.
template <int kBlock>
__device__ __forceinline__ void walk_batch(Batch& b, Walk& w,
                                           const uint32_t* words,
                                           const float o[3],
                                           const float d[3], float t_far,
                                           const MarchArgs& a) {
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    b.live[j] = !w.ended;
    b.occ[j] = false;
    b.t[j] = w.t;
    b.flat[j] = 0;
    if (!w.ended) {
      bool inside;
      int word, bit;
      sample_cell<kBlock>(o, d, w.t, a, b.flat[j], inside, word, bit);
      if (word != w.word_idx) {
        w.word = __ldg(words + word);
        w.word_idx = word;
      }
      b.occ[j] = inside && ((w.word >> bit) & 1u);
      ++w.steps;
      w.ended = w.t > t_far || w.steps >= a.max_steps;
      if (!w.ended) w.t = w.t + (b.occ[j] ? a.dt_fine : a.dt_coarse);
    }
  }
}

// The occupied samples' tsdf words, issued together.
template <typename TsdfT>
__device__ __forceinline__ void load_batch(Batch& b, const TsdfT* tsdf) {
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    b.v[j] = b.occ[j] ? gather_tsdf(tsdf, b.flat[j]) : 1.0f;
}

// The plain rule on the batch's live samples in order, up to the first
// crossing: prev > 0 && val <= 0, with the linear t_hit.
__device__ __forceinline__ void test_batch(const Batch& b, Crossing& c) {
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (b.live[j] && !c.hit) {
      if (c.seeded && c.prev_val > 0.0f && b.v[j] <= 0.0f) {
        const float denom = c.prev_val - b.v[j];
        const float frac = denom > 1e-12f ? c.prev_val / denom : 0.5f;
        c.hit = true;
        c.hit_t = c.prev_t + (b.t[j] - c.prev_t) * frac;
        c.hit_lo = c.prev_t;
        c.hit_hi = b.t[j];
        c.hit_flat = b.flat[j];
      }
      c.seeded = true;
      c.prev_t = b.t[j];
      c.prev_val = b.v[j];
    }
  }
}

// Trilinear tsdf at origin + dir * t: the 8 corners around the floor voxel
// (clipped to dims - 2), weights as ((wx * wy) * wz), summed in the plain
// version's order
template <typename TsdfT>
__device__ __forceinline__ float trilinear(const TsdfT* tsdf,
                                           const float o[3],
                                           const float d[3], float t,
                                           const MarchArgs& a) {
  float g[3];
  grid_of(o, d, t, a, g);
  const int dims[3] = {a.X, a.Y, a.Z};
  int gi[3];
  float f[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gi[k] = min(max((int)floorf(g[k]), 0), dims[k] - 2);
    f[k] = fminf(fmaxf(g[k] - (float)gi[k], 0.0f), 1.0f);
  }
  const unsigned base =
      ((unsigned)gi[0] * a.Y + gi[1]) * (unsigned)a.Z + gi[2];
  float acc = 0.0f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float w = ((dx ? f[0] : 1.0f - f[0]) *
                         (dy ? f[1] : 1.0f - f[1])) *
                        (dz ? f[2] : 1.0f - f[2]);
        const float corner = tsdf_at(
            tsdf, base + ((unsigned)dx * a.Y + dy) * (unsigned)a.Z + dz);
        acc = acc + w * corner;
      }
  return acc;
}

// One thread a word of the packed occupancy; cells past the grid are 0.
__global__ void __launch_bounds__(kPackThreads)
    pack_kernel(const unsigned char* __restrict__ occ, int cx, int cy,
                int cz, int wy, int wz, int n_words,
                uint32_t* __restrict__ words) {
  const int w = blockIdx.x * kPackThreads + threadIdx.x;
  if (w >= n_words) return;
  const int bz = w % wz, by = (w / wz) % wy, bx = w / (wz * wy);
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int x = 4 * bx + i, y = 4 * by + j, z = 2 * bz + k;
        if (x < cx && y < cy && z < cz &&
            __ldg(occ + ((long long)x * cy + y) * cz + z))
          bits |= 1u << bit_of(x, y, z);
      }
  words[w] = bits;
}

template <typename TsdfT, typename LabelT, int kBlock>
__global__ void __launch_bounds__(kThreads)
    raymarch_kernel(const TsdfT* __restrict__ tsdf,
                    const LabelT* __restrict__ label,
                    const TsdfT* __restrict__ rem,
                    const uint32_t* __restrict__ words,
                    const float* __restrict__ rays,
                    const float* __restrict__ origins, const MarchArgs a,
                    float* __restrict__ out_range,
                    int* __restrict__ out_label,
                    float* __restrict__ out_rem, float* __restrict__ out_ends,
                    bool* __restrict__ out_hit) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.R) return;
  float d[3], o[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d[k] = __ldg(rays + 3LL * r + k);
    o[k] = __ldg(origins + (long long)a.origin_stride * r + k);
  }

  // slab test of the box
  float t_near = -INFINITY, t_far = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float safe = fabsf(d[k]) > 1e-12f ? d[k]
                                            : (d[k] >= 0.0f ? 1e-12f : -1e-12f);
    const float inv = 1.0f / safe;
    const float t0 = (a.lo[k] - o[k]) * inv;
    const float t1 = (a.hi[k] - o[k]) * inv;
    t_near = fmaxf(t_near, fminf(t0, t1));
    t_far = fminf(t_far, fmaxf(t0, t1));
  }
  t_far = fminf(t_far, 1e4f);

  Walk w{fmaxf(t_near, 0.0f) + 1e-4f, 0, false, -1, 0u};
  w.ended = w.t > t_far || a.max_steps <= 0;
  Crossing c{w.t, 1.0f, false, false, 0.0f, 0.0f, 0.0f, 0u};
  while (!w.ended) {
    Batch b;
    walk_batch<kBlock>(b, w, words, o, d, t_far, a);
    load_batch(b, tsdf);
    test_batch(b, c);
    if (c.hit) break;
  }
  const bool hit = c.hit;
  const float hit_t = c.hit_t, hit_lo = c.hit_lo, hit_hi = c.hit_hi;
  const unsigned hit_flat = c.hit_flat;

  float rng = 0.0f, rem_v = 0.0f;
  int lbl = 0;
  if (hit) {
    float lo_t = fmaxf(hit_lo - a.margin, 0.0f);
    float hi_t = hit_hi + a.margin;
    float f_lo = trilinear(tsdf, o, d, lo_t, a);
    const float f_hi = trilinear(tsdf, o, d, hi_t, a);
    const bool bracket_ok = f_lo > 0.0f && f_hi <= 0.0f;
    for (int i = 0; i < 10; ++i) {
      const float mid = 0.5f * (lo_t + hi_t);
      const float f_mid = trilinear(tsdf, o, d, mid, a);
      if ((f_mid > 0.0f) == (f_lo > 0.0f)) {
        lo_t = mid;
        f_lo = f_mid;
      } else {
        hi_t = mid;
      }
    }
    rng = bracket_ok ? 0.5f * (lo_t + hi_t) : hit_t;
    lbl = (int)__ldg(label + hit_flat);
    rem_v = to_f32(__ldg(rem + hit_flat));
  }
  out_range[r] = rng;
  out_label[r] = lbl;
  out_rem[r] = rem_v;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    out_ends[3LL * r + k] = hit ? o[k] + d[k] * rng : 0.0f;
  out_hit[r] = hit;
}

template <typename TsdfT, typename LabelT>
void launch_march(unsigned int grid, cudaStream_t st, const void* tsdf,
                  const void* label, const void* rem, const uint32_t* words,
                  const float* rays, const float* origins,
                  const MarchArgs& a, float* out_range, int* out_label,
                  float* out_rem, float* out_ends, bool* out_hit) {
  const TsdfT* ts = (const TsdfT*)tsdf;
  const LabelT* lb = (const LabelT*)label;
  const TsdfT* rm = (const TsdfT*)rem;
  if (a.block == 4)
    raymarch_kernel<TsdfT, LabelT, 4><<<grid, kThreads, 0, st>>>(
        ts, lb, rm, words, rays, origins, a, out_range, out_label, out_rem,
        out_ends, out_hit);
  else
    raymarch_kernel<TsdfT, LabelT, 0><<<grid, kThreads, 0, st>>>(
        ts, lb, rm, words, rays, origins, a, out_range, out_label, out_rem,
        out_ends, out_hit);
}

}  // namespace

// Packs the (cx, cy, cz) bool occupancy into (wx, wy, wz) 32-bit words of
// 4 x 4 x 2 cells (wx = ceil(cx / 4), wy = ceil(cy / 4), wz = ceil(cz /
// 2)). Returns the cudaError_t.
extern "C" int lt_occupancy_bits(const void* occ, int cx, int cy, int cz,
                                 void* words, void* stream) {
  const int wx = (cx + 3) / 4, wy = (cy + 3) / 4, wz = (cz + 1) / 2;
  const long long n = (long long)wx * wy * wz;
  if (n <= 0) return (int)cudaSuccess;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned int grid =
      (unsigned int)((n + kPackThreads - 1) / kPackThreads);
  pack_kernel<<<grid, kPackThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)occ, cx, cy, cz, wy, wz, (int)n,
      (uint32_t*)words);
  return (int)cudaGetLastError();
}

// Marches R rays (rays (R, 3) f32; origins (3,) with origin_stride 0 or
// (R, 3) with 3) through the (X, Y, Z) state, float32 (tsdf f32, label
// i32, rem f32) or compact (bf16, int16, bf16), of fewer than 2^32 voxels,
// and the packed occupancy (lt_occupancy_bits of the (cx, cy, cz) grid of
// block^3 cells); writes range, label, remission, endpoints (R, 3) and
// hit. lo/hi: the box; vox, dt_fine, dt_coarse, margin: the float32
// scalars of ops/raycast_cuda.MarchParams. Returns the cudaError_t.
extern "C" int lt_raymarch(const void* tsdf, const void* label,
                           const void* rem, const void* words,
                           const float* rays, const float* origins,
                           int compact, int R, int origin_stride, int X,
                           int Y, int Z, int cx, int cy, int cz, int block,
                           int max_steps, float lo_x, float lo_y, float lo_z,
                           float hi_x, float hi_y, float hi_z, float vox,
                           float dt_fine, float dt_coarse, float margin,
                           float* out_range, int* out_label, float* out_rem,
                           float* out_ends, bool* out_hit, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  if (X < 2 || Y < 2 || Z < 2 || block < 1 ||
      (long long)X * Y * Z >= (1LL << 32) ||
      (origin_stride != 0 && origin_stride != 3) ||
      cx != (X + block - 1) / block || cy != (Y + block - 1) / block ||
      cz != (Z + block - 1) / block)
    return (int)cudaErrorInvalidValue;
  const MarchArgs a{R,
                    origin_stride,
                    X,
                    Y,
                    Z,
                    block,
                    max_steps,
                    (cy + 3) / 4,
                    (cz + 1) / 2,
                    {lo_x, lo_y, lo_z},
                    {hi_x, hi_y, hi_z},
                    vox,
                    dt_fine,
                    dt_coarse,
                    margin};
  const unsigned int grid = (unsigned int)((R + kThreads - 1) / kThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* w = (const uint32_t*)words;
  if (compact)
    launch_march<__nv_bfloat16, short>(grid, st, tsdf, label, rem, w, rays,
                                       origins, a, out_range, out_label,
                                       out_rem, out_ends, out_hit);
  else
    launch_march<float, int>(grid, st, tsdf, label, rem, w, rays, origins,
                             a, out_range, out_label, out_rem, out_ends,
                             out_hit);
  return (int)cudaGetLastError();
}
