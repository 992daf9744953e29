// Raymarch kernel: target rays through the fused TSDF volume, one thread a
// ray.
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
// 32-byte sectors that the march's data touches (occupancy bytes of the
// samples inside the box, tsdf words of the occupied samples and of a
// hit's refinement corners, its label and remission), each once, the rays
// and the outputs. The gathers of one ray depend on each other step by step,
// so the kernel is bound by their latency; a first kernel that is right:
// 128 threads a block, the state read through the read-only path, the
// tsdf word loaded beside the occupancy byte (its index is always inside
// the volume) rather than after it.

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct MarchArgs {
  int R, origin_stride;
  int X, Y, Z, cx, cy, cz, block, max_steps;
  float lo[3], hi[3];
  float vox, dt_fine, dt_coarse, margin;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TsdfT>
__device__ __forceinline__ float tsdf_at(const TsdfT* tsdf, long long i) {
  return to_f32(__ldg(tsdf + i));
}

// origin + dir * t per axis, then the grid coordinate (pos - lo) / vox
__device__ __forceinline__ void grid_of(const float o[3], const float d[3],
                                        float t, const MarchArgs& a,
                                        float g[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) g[k] = (o[k] + d[k] * t - a.lo[k]) / a.vox;
}

struct Sample {
  float val;
  bool occupied;
  long long flat;
};

template <typename TsdfT>
__device__ __forceinline__ Sample sample(const TsdfT* tsdf,
                                                const bool* occ,
                                                const float o[3],
                                                const float d[3], float t,
                                                const MarchArgs& a) {
  float g[3];
  grid_of(o, d, t, a, g);
  const int dims[3] = {a.X, a.Y, a.Z};
  int gi[3];
  bool inside = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int v = (int)floorf(g[k]);
    inside = inside && v >= 0 && v < dims[k];
    gi[k] = min(max(v, 0), dims[k] - 1);
  }
  Sample s;
  s.flat = ((long long)gi[0] * a.Y + gi[1]) * a.Z + gi[2];
  const long long cflat =
      ((long long)(gi[0] / a.block) * a.cy + gi[1] / a.block) * a.cz +
      gi[2] / a.block;
  // both loads issued together: the tsdf index is inside the volume
  const float v = tsdf_at(tsdf, s.flat);
  s.occupied = inside && __ldg(reinterpret_cast<const unsigned char*>(occ) +
                               cflat) != 0;
  s.val = s.occupied ? v : 1.0f;
  return s;
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
  const long long base = ((long long)gi[0] * a.Y + gi[1]) * a.Z + gi[2];
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
        const float corner =
            tsdf_at(tsdf, base + ((long long)dx * a.Y + dy) * a.Z + dz);
        acc = acc + w * corner;
      }
  return acc;
}

template <typename TsdfT, typename LabelT>
__global__ void __launch_bounds__(kThreads)
    raymarch_kernel(const TsdfT* __restrict__ tsdf,
                    const LabelT* __restrict__ label,
                    const TsdfT* __restrict__ rem,
                    const bool* __restrict__ occ,
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

  float t = fmaxf(t_near, 0.0f) + 1e-4f;
  float prev_t = t;
  float prev_val = sample(tsdf, occ, o, d, t, a).val;
  bool done = t > t_far;
  bool hit = false;
  float hit_t = 0.0f, hit_lo = 0.0f, hit_hi = 0.0f;
  long long hit_flat = 0;
  for (int step = 0; step < a.max_steps && !done; ++step) {
    const Sample s = sample(tsdf, occ, o, d, t, a);
    if (prev_val > 0.0f && s.val <= 0.0f) {
      const float denom = prev_val - s.val;
      const float frac = denom > 1e-12f ? prev_val / denom : 0.5f;
      hit = true;
      hit_t = prev_t + (t - prev_t) * frac;
      hit_lo = prev_t;
      hit_hi = t;
      hit_flat = s.flat;
      done = true;
    }
    done = done || t > t_far;
    const float dt = s.occupied ? a.dt_fine : a.dt_coarse;
    prev_t = t;
    prev_val = s.val;
    if (!done) t = t + dt;
  }

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

}  // namespace

// Marches R rays (rays (R, 3) f32; origins (3,) with origin_stride 0 or
// (R, 3) with 3) through the (X, Y, Z) state, float32 (tsdf f32, label
// i32, rem f32) or compact (bf16, int16, bf16), and the (cx, cy, cz) bool
// occupancy of block^3 cells; writes range, label, remission, endpoints
// (R, 3) and hit. lo/hi: the box; vox, dt_fine, dt_coarse, margin: the
// float32 scalars of ops/raycast_cuda.MarchParams. Returns the
// cudaError_t.
extern "C" int lt_raymarch(const void* tsdf, const void* label,
                           const void* rem, const void* occ,
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
      (origin_stride != 0 && origin_stride != 3))
    return (int)cudaErrorInvalidValue;
  const MarchArgs a{R,         origin_stride,
                    X,         Y,
                    Z,         cx,
                    cy,        cz,
                    block,     max_steps,
                    {lo_x, lo_y, lo_z},
                    {hi_x, hi_y, hi_z},
                    vox,       dt_fine,
                    dt_coarse, margin};
  const unsigned int grid = (unsigned int)((R + kThreads - 1) / kThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool* o = (const bool*)occ;
  if (compact) {
    raymarch_kernel<__nv_bfloat16, short><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)tsdf, (const short*)label,
        (const __nv_bfloat16*)rem, o, rays, origins, a, out_range, out_label,
        out_rem, out_ends, out_hit);
  } else {
    raymarch_kernel<float, int><<<grid, kThreads, 0, st>>>(
        (const float*)tsdf, (const int*)label, (const float*)rem, o, rays,
        origins, a, out_range, out_label, out_rem, out_ends, out_hit);
  }
  return (int)cudaGetLastError();
}
