// Kernel C: class-aware TSDF integrate of one range image, in place.
//
// Replaces: lidar_transfer_tpu/ops/tsdf_pallas.py::_integrate_kernel_impl
// (bodies _kernel / _kernel_plane) in the modes the mergemesh path uses:
// reset or carried state, write_weight on or off, f32 state. The S-scan
// chain and the compact (bf16/int16) state are not ported yet.
//
// Semantics are those of lidar_transfer_tpu/ops/tsdf.py::integrate (the XLA
// version), not of the Pallas kernel: pitch is an exact asinf here, where
// the Pallas kernel approximates atan with a polynomial, and remission is a
// full float, where the Pallas kernel packs it into 14 bits beside the label.
// Labels stay int32.
//
// Design: one warp per (x, y) column walks z, the contiguous axis, 32
// voxels at a time, so every store of a warp is one coalesced 128-byte
// line. Each lane computes the column's yaw, image column u and the x/y
// part of the range once. (One thread per column, walking z alone, stored
// 32 lines per warp instruction and measured 159 ms for 2048x2048x208 on
// an H100, slower than the plain PyTorch version.) Each voxel reads its
// pixel of the (H, W) images through the read-only cache (1.5 MB for
// 64x2048: they live in L2). The arithmetic is
// written in the order of the plain PyTorch version (ops/tsdf.py) and the
// library is built with -fmad=false, so no product is fused into an add the
// plain version rounds separately. Offsets are 64-bit: 2048x2048x208 voxels
// x 4 B is over 2^31 bytes.
//
// Bound on the card: state traffic, 12 B/voxel written in reset mode without
// the weight (16 B/voxel with it), plus 16 B/voxel read when the state is
// carried; a voxel's sqrt, asin and three divisions come on top.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColumnsPerBlock = kThreads / 32;  // one warp per column

struct Params {
  int H, W, X, Y, Z, x_offset;
  float ox, oy, oz, vox;
  float fov_up, fov_down, fov_down_abs, fov, pi, trunc, obs_weight;
  int ax, ay, az;
  int reset, write_weight;
};

__global__ void tsdf_integrate_kernel(float* __restrict__ tsdf,
                                      float* __restrict__ weight,
                                      int* __restrict__ label,
                                      float* __restrict__ rem,
                                      const float* __restrict__ depth_im,
                                      const int* __restrict__ label_im,
                                      const float* __restrict__ rem_im,
                                      const Params p) {
  const long long col =
      (long long)blockIdx.x * kColumnsPerBlock + (threadIdx.x >> 5);
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

  const long long base = col * (long long)p.Z;
  for (int z = threadIdx.x & 31; z < p.Z; z += 32) {
    const long long idx = base + z;
    const float pz = p.oz + (float)z * p.vox;
    const float depth = sqrtf(pxy + pz * pz);
    const float safe = fmaxf(depth, 1e-12f);
    const float pitch = asinf(fminf(fmaxf(pz / safe, -1.0f), 1.0f));
    const bool in_fov = pitch <= p.fov_up && pitch >= p.fov_down;
    const float v = (1.0f - (pitch + p.fov_down_abs) / p.fov) * (float)p.H;
    const int vy = (int)fminf(fmaxf(floorf(v), 0.0f), (float)(p.H - 1));
    const long long pix = (long long)vy * p.W + ux;
    const float dval = __ldg(depth_im + pix);
    const int nl = __ldg(label_im + pix);
    const float nr = __ldg(rem_im + pix);
    const float diff = dval - depth;
    const float dist = fminf(diff / p.trunc, 1.0f);
    const bool active = crop_xy && z < p.az && in_fov && dval > 0.0f &&
                        diff >= -p.trunc;

    float t0 = 1.0f, w0 = 0.0f, r0 = 0.0f;
    int l0 = 0;
    if (!p.reset) {
      if (!active) continue;  // carried state of an inactive voxel stays
      t0 = tsdf[idx];
      w0 = weight[idx];
      l0 = label[idx];
      r0 = rem[idx];
    }
    const bool same = l0 == nl;
    const float w_new = w0 + p.obs_weight;
    const float tsdf_avg = (t0 * w0 + dist) / w_new;
    const float rem_avg = (r0 * w0 + nr) / w_new;
    const bool upd_same = active && same;
    const bool upd_diff = active && !same && dist < w0;
    if (!p.reset && !upd_same && !upd_diff) continue;
    tsdf[idx] = upd_same ? tsdf_avg : (upd_diff ? dist : t0);
    label[idx] = upd_diff ? nl : l0;
    rem[idx] = upd_same ? rem_avg : (upd_diff ? nr : r0);
    if (p.write_weight) weight[idx] = upd_same ? w_new : w0;
  }
}

}  // namespace

// Updates the (X, Y, Z) state arrays in place from one (H, W) image.
// x_offset is the slab's first global x index; origin, fov and trunc are
// the float32 values the plain version uses. Returns the cudaError_t.
extern "C" int lt_tsdf_integrate(float* tsdf, float* weight, int* label,
                                 float* rem, const float* depth_im,
                                 const int* label_im, const float* rem_im,
                                 int H, int W, int X, int Y, int Z,
                                 int x_offset, float ox, float oy, float oz,
                                 float vox, float fov_up, float fov_down,
                                 float fov_down_abs, float fov, float pi,
                                 float trunc, float obs_weight, int ax, int ay,
                                 int az, int reset, int write_weight,
                                 void* stream) {
  const long long cols = (long long)X * Y;
  if (cols <= 0 || Z <= 0) return (int)cudaSuccess;
  Params p{H,      W,     X,           Y,    Z,     x_offset,     ox,
           oy,     oz,    vox,         fov_up, fov_down, fov_down_abs, fov,
           pi,     trunc, obs_weight,  ax,   ay,    az,           reset,
           write_weight};
  const long long blocks = (cols + kColumnsPerBlock - 1) / kColumnsPerBlock;
  tsdf_integrate_kernel<<<(unsigned int)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(tsdf, weight, label, rem,
                                                  depth_im, label_im, rem_im,
                                                  p);
  return (int)cudaGetLastError();
}
