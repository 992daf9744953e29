// Kernel C: class-aware TSDF integrate of S range images, in place.
//
// Replaces: lidar_transfer_tpu/ops/tsdf_pallas.py::_integrate_kernel_impl
// (bodies _kernel / _kernel_plane) in all its modes: reset or carried
// state, write_weight on or off, the S-scan chain (S > 1, as
// integrate_pallas_chain: the first image onto the init constants, all S
// folded in registers, the state written once), the float32 state
// (f32/f32/i32/f32) and the compact one (bf16/bf16/int16/bf16), and the
// optional geometry table (int8 row per voxel, -1 out of FOV) that
// tsdf_geometry.cu builds for a fixed placement.
//
// Semantics are those of lidar_transfer_tpu/ops/tsdf.py::integrate (the XLA
// version), not of the Pallas kernel: pitch is an exact asinf here, where
// the Pallas kernel approximates atan with a polynomial, and remission is a
// full float, where the Pallas kernel packs it into 14 bits beside the label.
// All S images share one fov and origin (the chain's invariant), so a voxel
// computes its depth, column and row once and reads the same pixel of each.
// Compute is float32 whatever the storage; a compact store rounds to
// nearest even (__float2bfloat16_rn), as torch's and XLA's converts do.
// The weight is carried in registers through the chain even when it is
// not written: the class-aware rule reads it.
//
// Design: one warp per (x, y) column walks z, the contiguous axis, 32
// voxels at a time, so every store of a warp is one coalesced line. Each
// lane computes the column's yaw, image column u and the x/y part of the
// range once. (One thread per column, walking z alone, stored 32 lines
// per warp instruction and measured 159 ms for 2048x2048x208 on an H100,
// slower than the plain PyTorch version.) Each voxel reads its pixel of
// the (S, H, W) images through the read-only cache (1.5 MB per 64x2048
// image: they live in L2). The arithmetic is written in the order of the
// plain PyTorch version (ops/tsdf.py) and the library is built with
// -fmad=false. Offsets are 64-bit: 2048x2048x208 voxels x 4 B is over
// 2^31 bytes.
//
// Bound on the card: state traffic, written once per call whatever S is
// (12 B/voxel f32 or 6 B/voxel compact in reset mode without the weight,
// 16 or 8 with it), plus the same again read when the state is carried; a
// voxel's sqrt and asin (unless the table gives the row: 1 B/voxel read)
// and three divisions per image come on top.

#include <cuda_bf16.h>

#include "tsdf_common.cuh"

namespace {

struct Params {
  int S, H, W, X, Y, Z, x_offset;
  float ox, oy, oz, vox;
  float fov_up, fov_down, fov_down_abs, fov, pi, trunc, obs_weight;
  int ax, ay, az;
  int reset, write_weight;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// kTable: the row comes from v_tab; kS > 0 fixes the image count at
// compile time (the single integrate), kS = 0 reads it from p.S (the
// chain). Measured at 2048x2048x208 on an H100 (64x2048 images): one
// kernel with both as run-time values took 64 registers and 7.07 ms for
// the single integrate (the earlier single-image, f32-only kernel:
// 6.05 ms); specialised, 5.32 ms.
// Six blocks per SM (at most 40 registers) took the chain from 9.53 to
// 9.02 ms with the table.
template <typename F, typename L, bool kTable, int kS>
__global__ void __launch_bounds__(lt::kThreads, 6)
    tsdf_integrate_kernel(F* __restrict__ tsdf, F* __restrict__ weight,
                          L* __restrict__ label, F* __restrict__ rem,
                          const float* __restrict__ depth_im,
                          const int* __restrict__ label_im,
                          const float* __restrict__ rem_im,
                          const signed char* __restrict__ v_tab,
                          const Params p) {
  const long long col =
      (long long)blockIdx.x * lt::kColumnsPerBlock + (threadIdx.x >> 5);
  if (col >= (long long)p.X * p.Y) return;
  const int x = (int)(col / p.Y);
  const int y = (int)(col % p.Y);
  const int gxi = x + p.x_offset;  // global x index of this slab's column

  const float px = p.ox + (float)gxi * p.vox;
  const float py = p.oy + (float)y * p.vox;
  const float pxy = px * px + py * py;
  const float yaw = -atan2f(py, px);
  const float u = 0.5f * (yaw / p.pi + 1.0f) * (float)p.W;
  const int ux = (int)fminf(fmaxf(floorf(u), 0.0f), (float)(p.W - 1));
  const bool crop_xy = gxi < p.ax && y < p.ay;
  const long long image = (long long)p.H * p.W;
  const int S = kS > 0 ? kS : p.S;

  const long long base = col * (long long)p.Z;
  for (int z = threadIdx.x & 31; z < p.Z; z += 32) {
    const long long idx = base + z;
    const float pz = p.oz + (float)z * p.vox;
    const float depth = sqrtf(pxy + pz * pz);
    int vy;
    bool in_fov;
    if (kTable) {
      const int raw = __ldg(v_tab + idx);
      in_fov = raw >= 0;
      vy = raw < 0 ? 0 : raw;
    } else {
      in_fov = lt::voxel_row(pz, depth, p.H, p.fov_up, p.fov_down,
                             p.fov_down_abs, p.fov, &vy);
    }
    const bool base_active = crop_xy && z < p.az && in_fov;

    float t = 1.0f, w = 0.0f, r = 0.0f;
    int l = 0;
    if (!p.reset) {
      if (!base_active) continue;  // carried state of an inactive voxel stays
      t = load(tsdf + idx);
      w = load(weight + idx);
      l = (int)label[idx];
      r = load(rem + idx);
    }
    bool changed = false;
    if (base_active) {
      const long long pix = (long long)vy * p.W + ux;
      for (int s = 0; s < S; ++s) {
        const long long off = s * image + pix;
        const float dval = __ldg(depth_im + off);
        const int nl = __ldg(label_im + off);
        const float nr = __ldg(rem_im + off);
        const float diff = dval - depth;
        const float dist = fminf(diff / p.trunc, 1.0f);
        const bool active = dval > 0.0f && diff >= -p.trunc;
        const bool same = l == nl;
        const float w_new = w + p.obs_weight;
        const float tsdf_avg = (t * w + dist) / w_new;
        const float rem_avg = (r * w + nr) / w_new;
        const bool upd_same = active && same;
        const bool upd_diff = active && !same && dist < w;
        t = upd_same ? tsdf_avg : (upd_diff ? dist : t);
        l = upd_diff ? nl : l;
        r = upd_same ? rem_avg : (upd_diff ? nr : r);
        w = upd_same ? w_new : w;
        changed = changed || upd_same || upd_diff;
      }
    }
    if (!p.reset && !changed) continue;
    store(tsdf + idx, t);
    label[idx] = (L)l;
    store(rem + idx, r);
    if (p.write_weight) store(weight + idx, w);
  }
}

template <typename F, typename L>
void launch_typed(dim3 grid, cudaStream_t st, F* tsdf, F* weight, L* label,
                  F* rem, const float* depth_im, const int* label_im,
                  const float* rem_im, const signed char* v_tab,
                  const Params& p) {
#define LT_LAUNCH(TABLE, S)                                           \
  tsdf_integrate_kernel<F, L, TABLE, S><<<grid, lt::kThreads, 0, st>>>( \
      tsdf, weight, label, rem, depth_im, label_im, rem_im, v_tab, p)
  if (v_tab != nullptr) {
    if (p.S == 1) LT_LAUNCH(true, 1); else LT_LAUNCH(true, 0);
  } else {
    if (p.S == 1) LT_LAUNCH(false, 1); else LT_LAUNCH(false, 0);
  }
#undef LT_LAUNCH
}

int launch(void* tsdf, void* weight, void* label, void* rem,
           const float* depth_im, const int* label_im, const float* rem_im,
           const signed char* v_tab, int compact, const Params& p,
           void* stream) {
  const long long cols = (long long)p.X * p.Y;
  if (cols <= 0 || p.Z <= 0) return (int)cudaSuccess;
  const long long blocks =
      (cols + lt::kColumnsPerBlock - 1) / lt::kColumnsPerBlock;
  const dim3 grid((unsigned int)blocks);
  const cudaStream_t st = (cudaStream_t)stream;
  if (compact) {
    launch_typed(grid, st, (__nv_bfloat16*)tsdf, (__nv_bfloat16*)weight,
                 (short*)label, (__nv_bfloat16*)rem, depth_im, label_im,
                 rem_im, v_tab, p);
  } else {
    launch_typed(grid, st, (float*)tsdf, (float*)weight, (int*)label,
                 (float*)rem, depth_im, label_im, rem_im, v_tab, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Updates the (X, Y, Z) state arrays in place from one (H, W) image.
// compact selects bf16/bf16/int16/bf16 storage (else f32/f32/i32/f32);
// v_tab is the (X, Y, Z) int8 row table or null; x_offset is the slab's
// first global x index; origin, fov and trunc are the float32 values the
// plain version uses. Returns the cudaError_t.
extern "C" int lt_tsdf_integrate(
    void* tsdf, void* weight, void* label, void* rem, const float* depth_im,
    const int* label_im, const float* rem_im, const signed char* v_tab,
    int compact, int H, int W, int X, int Y, int Z, int x_offset, float ox,
    float oy, float oz, float vox, float fov_up, float fov_down,
    float fov_down_abs, float fov, float pi, float trunc, float obs_weight,
    int ax, int ay, int az, int reset, int write_weight, void* stream) {
  const Params p{1,      H,        W,            X,   Y,     Z,
                 x_offset, ox,     oy,           oz,  vox,   fov_up,
                 fov_down, fov_down_abs, fov,    pi,  trunc, obs_weight,
                 ax,     ay,       az,           reset, write_weight};
  return launch(tsdf, weight, label, rem, depth_im, label_im, rem_im, v_tab,
                compact, p, stream);
}

// The S-scan chain: (S, H, W) image stacks, the first applied onto the
// init constants, the state written once. Other arguments as above.
extern "C" int lt_tsdf_integrate_chain(
    void* tsdf, void* weight, void* label, void* rem, const float* depth_ims,
    const int* label_ims, const float* rem_ims, const signed char* v_tab,
    int compact, int S, int H, int W, int X, int Y, int Z, int x_offset,
    float ox, float oy, float oz, float vox, float fov_up, float fov_down,
    float fov_down_abs, float fov, float pi, float trunc, float obs_weight,
    int ax, int ay, int az, int write_weight, void* stream) {
  const Params p{S,      H,        W,            X,   Y,     Z,
                 x_offset, ox,     oy,           oz,  vox,   fov_up,
                 fov_down, fov_down_abs, fov,    pi,  trunc, obs_weight,
                 ax,     ay,       az,           1,   write_weight};
  return launch(tsdf, weight, label, rem, depth_ims, label_ims, rem_ims,
                v_tab, compact, p, stream);
}
