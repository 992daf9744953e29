// Probe kernel: the integrate body with parts taken out.
//
// Replaces: scripts/probe_kernel_parts.py::probe (the pl.pallas_call at
// :115; body make_kernel :25). Each variant of the script is a template case:
//   kWriteOnly - the constants 1, 2, 3 into the outputs (the write floor);
//   kNoGeom    - depth = gz, row = min(int(gz), H - 1), in FOV iff gz > 1;
//   kNoGather  - every voxel reads row 0 of its image column;
//   kFull      - depth sqrt, the pitch polynomial t * (1 - 0.33 t^2), the
//                row, the gathered depth and packed label/remission, the
//                reset-mode rule.
// kOut is 1 (tsdf) or 3 (tsdf bf16, label int16, remission bf16).
//
// Inputs are the script's: params (2, 8) f32 (origin, fov up and down in
// radians), dcol and lrcol (X, CW, Y) f32. Image row v of voxel (x, y, z) is
// dcol[x, v, y], as the script's take_along_axis over the transposed column
// reads it. The arithmetic is the script's, in its order, and the library is
// built with -fmad=false, so the plain version (probes/parts.py) agrees bit
// for bit. Stores round to nearest even (bf16) and truncate (int16), as
// XLA's and torch's converts do.
//
// Design: one warp per (x, y) column, lanes along z (coalesced stores), as in
// tsdf_integrate.cu; a block covers BX x-planes of 8 y-columns, so BX is the
// script's x-planes per grid step. Bound on the card: the output writes
// (6 B/voxel with three outputs, 2 with one), then the two 4-byte column
// reads of a voxel (from L1/L2: a column's 64 rows are 256 B apart in y) and
// its sqrt and two divisions.

#include <cuda_bf16.h>

#include "tsdf_common.cuh"

namespace {

enum Variant { kWriteOnly = 0, kNoGeom = 1, kNoGather = 2, kFull = 3 };

struct PartsParams {
  int X, Y, Z, H, CW, BX;
  float vox, trunc;
};

template <int kVariant, int kOut>
__global__ void __launch_bounds__(lt::kThreads)
    probe_parts_kernel(__nv_bfloat16* __restrict__ out_tsdf,
                       short* __restrict__ out_label,
                       __nv_bfloat16* __restrict__ out_rem,
                       const float* __restrict__ params,
                       const float* __restrict__ dcol,
                       const float* __restrict__ lrcol, const PartsParams p) {
  const int y = blockIdx.x * lt::kColumnsPerBlock + (threadIdx.x >> 5);
  if (y >= p.Y) return;
  const int lane = threadIdx.x & 31;
  const float ox = __ldg(params + 0);
  const float oy = __ldg(params + 1);
  const float oz = __ldg(params + 2);
  const float fov_up = __ldg(params + 3);
  const float fov_down = __ldg(params + 4);
  const float fov_down_abs = fabsf(fov_down);
  const float fov = fabsf(fov_up) + fov_down_abs;
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
    const float r = sqrtf(rxy2);
    const long long base = ((long long)x * p.Y + y) * p.Z;
    const long long col = (long long)x * p.CW * p.Y + y;  // dcol[x, 0, y]
    for (int z = lane; z < p.Z; z += 32) {
      const long long idx = base + z;
      if (kVariant == kWriteOnly) {
        out_tsdf[idx] = __float2bfloat16_rn(1.0f);
        if (kOut == 3) {
          out_label[idx] = 2;
          out_rem[idx] = __float2bfloat16_rn(3.0f);
        }
        continue;
      }
      const float gz = (float)z;
      const float pz = oz + gz * p.vox;
      float depth;
      int v;
      bool in_fov;
      if (kVariant == kNoGeom) {
        depth = gz;
        v = min((int)gz, p.H - 1);
        in_fov = gz > 1.0f;
      } else {
        depth = sqrtf(rxy2 + pz * pz);
        const float t = pz / fmaxf(r, 1e-12f);
        const float pitch = t * (1.0f - 0.33f * t * t);
        in_fov = pitch <= fov_up && pitch >= fov_down;
        const float vf = (1.0f - (pitch + fov_down_abs) / fov) * (float)p.H;
        v = (int)fminf(fmaxf(floorf(vf), 0.0f), (float)(p.H - 1));
      }
      float dval, lr;
      if (kVariant == kNoGather) {
        dval = __ldg(dcol + col) + 0.0f * depth;
        lr = __ldg(lrcol + col) + 0.0f * depth;
      } else {
        const long long off = col + (long long)v * p.Y;
        dval = __ldg(dcol + off);
        lr = __ldg(lrcol + off);
      }
      const float new_label = floorf(lr * inv_label);
      const float new_rem = (lr - new_label * 16384.0f) * inv_rem;
      const float diff = dval - depth;
      const float dist = fminf(1.0f, diff / p.trunc);
      const bool active = in_fov && dval > 0.0f && diff >= -p.trunc;
      const bool upd = active && dist < 0.0f;
      out_tsdf[idx] = __float2bfloat16_rn(upd ? dist : 1.0f);
      if (kOut == 3) {
        out_label[idx] = (short)(int)(upd ? new_label : 0.0f);
        out_rem[idx] = __float2bfloat16_rn(upd ? new_rem : 0.0f);
      }
    }
  }
}

template <int kVariant>
void launch_variant(dim3 grid, cudaStream_t st, int n_out,
                    __nv_bfloat16* tsdf, short* label, __nv_bfloat16* rem,
                    const float* params, const float* dcol,
                    const float* lrcol, const PartsParams& p) {
  if (n_out == 3) {
    probe_parts_kernel<kVariant, 3><<<grid, lt::kThreads, 0, st>>>(
        tsdf, label, rem, params, dcol, lrcol, p);
  } else {
    probe_parts_kernel<kVariant, 1><<<grid, lt::kThreads, 0, st>>>(
        tsdf, label, rem, params, dcol, lrcol, p);
  }
}

}  // namespace

// Writes the variant's (X, Y, Z) outputs: tsdf bf16 and, with n_out = 3,
// label int16 and remission bf16 (null otherwise). variant: 0 writeonly,
// 1 nogeom, 2 nogather, 3 full. X % BX == 0, H <= CW. Returns the
// cudaError_t.
extern "C" int lt_probe_parts(void* out_tsdf, void* out_label, void* out_rem,
                              const float* params, const float* dcol,
                              const float* lrcol, int variant, int n_out,
                              int X, int Y, int Z, int H, int CW, int BX,
                              float vox, float trunc, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return (int)cudaSuccess;
  const PartsParams p{X, Y, Z, H, CW, BX, vox, trunc};
  const dim3 grid((Y + lt::kColumnsPerBlock - 1) / lt::kColumnsPerBlock,
                  X / BX);
  const cudaStream_t st = (cudaStream_t)stream;
  auto* tsdf = (__nv_bfloat16*)out_tsdf;
  auto* label = (short*)out_label;
  auto* rem = (__nv_bfloat16*)out_rem;
  switch (variant) {
    case kWriteOnly:
      launch_variant<kWriteOnly>(grid, st, n_out, tsdf, label, rem, params,
                                 dcol, lrcol, p);
      break;
    case kNoGeom:
      launch_variant<kNoGeom>(grid, st, n_out, tsdf, label, rem, params,
                              dcol, lrcol, p);
      break;
    case kNoGather:
      launch_variant<kNoGather>(grid, st, n_out, tsdf, label, rem, params,
                                dcol, lrcol, p);
      break;
    case kFull:
      launch_variant<kFull>(grid, st, n_out, tsdf, label, rem, params, dcol,
                            lrcol, p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
