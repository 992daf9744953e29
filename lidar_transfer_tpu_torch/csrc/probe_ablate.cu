// Probe kernel: the reset-mode integrate body on precomputed columns, with
// its divisions ("precols") or with multiplications in their place
// ("nodiv").
//
// Replaces: scripts/probe_integrate_ablate.py::kernel_call (the
// pl.pallas_call at :57) with its two bodies: TP._kernel (the Pallas
// integrate, lidar_transfer_tpu/ops/tsdf_pallas.py:85, reset, with the
// geometry table, no weight write) as kDiv = true, and nodiv_kernel (:73) as
// kDiv = false. Both read the int8 row table (-1 out of FOV), the columns
// dcol and lrcol (X, CW, Y) f32 (row v of voxel (x, y, z) is dcol[x, v, y];
// lrcol packs label * 16384 + round(remission * 16383)), apply the crop
// gx < ax, gy < ay, gz < az (ax = params[1, 0], ay = params[0, 6],
// az = params[0, 7], as tsdf_pallas._params lays them out) and write the
// compact state: tsdf bf16, label int16, remission bf16. The arithmetic is
// the script's, in its order (-fmad=false), so the plain version
// (probes/ablate.py) agrees bit for bit.
//
// Design: one warp per (x, y) column, lanes along z, a block over BX
// x-planes of 8 y-columns (as probe_parts.cu). Bound on the card: the
// 5 B/voxel of writes and table read, then the two column reads a voxel;
// kDiv's three divisions a voxel (none in the other case) are what the two
// cases tell apart.

#include <cuda_bf16.h>

#include "tsdf_common.cuh"

namespace {

struct AblateParams {
  int X, Y, Z, CW, BX;
  float vox, trunc, inv_trunc;
};

template <bool kDiv>
__global__ void __launch_bounds__(lt::kThreads)
    probe_ablate_kernel(__nv_bfloat16* __restrict__ out_tsdf,
                        short* __restrict__ out_label,
                        __nv_bfloat16* __restrict__ out_rem,
                        const float* __restrict__ params,
                        const float* __restrict__ dcol,
                        const float* __restrict__ lrcol,
                        const signed char* __restrict__ v_tab,
                        const AblateParams p) {
  const int y = blockIdx.x * lt::kColumnsPerBlock + (threadIdx.x >> 5);
  if (y >= p.Y) return;
  const int lane = threadIdx.x & 31;
  const float ox = __ldg(params + 0);
  const float oy = __ldg(params + 1);
  const float oz = __ldg(params + 2);
  const float obs_w = __ldg(params + 5);
  const float ay = __ldg(params + 6);
  const float az = __ldg(params + 7);
  const float ax = __ldg(params + 8);
  const float inv_obs = 1.0f / obs_w;
  const float gy = (float)y;
  const float inv_label = 1.0f / 16384.0f;
  const float inv_rem = (float)(1.0 / 16383.0);

  for (int bx = 0; bx < p.BX; ++bx) {
    const int x = blockIdx.y * p.BX + bx;
    if (x >= p.X) return;
    const float gx = (float)x;
    const float px = ox + gx * p.vox;
    const float py = oy + gy * p.vox;
    const float rxy2 = px * px + py * py;
    const bool in_crop_xy = gx < ax && gy < ay;
    const long long base = ((long long)x * p.Y + y) * p.Z;
    const long long col = (long long)x * p.CW * p.Y + y;  // dcol[x, 0, y]
    for (int z = lane; z < p.Z; z += 32) {
      const long long idx = base + z;
      const float gz = (float)z;
      const float pz = oz + gz * p.vox;
      const float depth = sqrtf(rxy2 + pz * pz);
      const int raw = __ldg(v_tab + idx);
      const bool in_fov = raw >= 0;
      // a row past the columns (a table built for more image rows than
      // CW) reads the last one, so every read stays inside dcol and lrcol
      const int v = raw < 0 ? 0 : min(raw, p.CW - 1);
      const long long off = col + (long long)v * p.Y;
      const float dval = __ldg(dcol + off);
      const float lr = __ldg(lrcol + off);
      const float new_label = floorf(lr * inv_label);
      const float new_rem = (lr - new_label * 16384.0f) * inv_rem;
      const float diff = dval - depth;
      const bool active = in_crop_xy && gz < az && in_fov && dval > 0.0f &&
                          diff >= -p.trunc;
      // reset: the prior state is tsdf 1, weight 0, label 0, remission 0
      const bool same = new_label == 0.0f;
      float dist, tsdf_avg, rem_avg;
      bool closer;
      if (kDiv) {
        dist = fminf(1.0f, diff / p.trunc);
        const float w_new = 0.0f + obs_w;
        tsdf_avg = (1.0f * 0.0f + dist) / w_new;
        rem_avg = (0.0f * 0.0f + new_rem) / w_new;
        closer = dist < 0.0f;
      } else {
        dist = fminf(1.0f, diff * p.inv_trunc);
        tsdf_avg = dist * inv_obs * obs_w;
        rem_avg = new_rem;
        closer = dist < 0.0f;
      }
      const bool upd_same = active && same;
      const bool upd_diff = active && !same && closer;
      const float t = upd_same ? tsdf_avg : (upd_diff ? dist : 1.0f);
      const float l = upd_diff ? new_label : 0.0f;
      const float r = upd_same ? rem_avg : (upd_diff ? new_rem : 0.0f);
      out_tsdf[idx] = __float2bfloat16_rn(t);
      out_label[idx] = (short)(int)l;
      out_rem[idx] = __float2bfloat16_rn(r);
    }
  }
}

}  // namespace

// Writes the (X, Y, Z) compact outputs from params (2, 8) f32, the columns
// (X, CW, Y) f32 and the (X, Y, Z) int8 table. div selects the divisions
// ("precols") or the multiplications ("nodiv"); inv_trunc is the float32
// 1 / trunc of the latter. X % BX == 0. Returns the cudaError_t.
extern "C" int lt_probe_ablate(void* out_tsdf, void* out_label, void* out_rem,
                               const float* params, const float* dcol,
                               const float* lrcol, const signed char* v_tab,
                               int div, int X, int Y, int Z, int CW, int BX,
                               float vox, float trunc, float inv_trunc,
                               void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return (int)cudaSuccess;
  const AblateParams p{X, Y, Z, CW, BX, vox, trunc, inv_trunc};
  const dim3 grid((Y + lt::kColumnsPerBlock - 1) / lt::kColumnsPerBlock,
                  X / BX);
  const cudaStream_t st = (cudaStream_t)stream;
  auto* tsdf = (__nv_bfloat16*)out_tsdf;
  auto* label = (short*)out_label;
  auto* rem = (__nv_bfloat16*)out_rem;
  if (div) {
    probe_ablate_kernel<true><<<grid, lt::kThreads, 0, st>>>(
        tsdf, label, rem, params, dcol, lrcol, v_tab, p);
  } else {
    probe_ablate_kernel<false><<<grid, lt::kThreads, 0, st>>>(
        tsdf, label, rem, params, dcol, lrcol, v_tab, p);
  }
  return (int)cudaGetLastError();
}
