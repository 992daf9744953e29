// Probe kernel: the integrate body with parts taken out.
//
// Replaces: scripts/probe_kernel_parts.py::probe (the pl.pallas_call at
// :115; body make_kernel :25). Each variant of the script is a template case:
//   kWriteOnly - the constants 1, 2, 3 into the outputs (the write floor);
//   kNoGeom    - depth = gz, row = min(int(gz), H - 1), in FOV iff gz > 1;
//   kNoGather  - every voxel reads row 0 of its image column;
//   kFullBody  - depth sqrt, the pitch polynomial t * (1 - 0.33 t^2), the
//                row, the gathered depth and packed label/remission, the
//                reset-mode rule.
// kOut is 1 (tsdf) or 3 (tsdf bf16, label int16, remission bf16).
//
// Inputs are the script's: params (2, 8) f32 (origin, fov up and down in
// radians), dcol and lrcol (X, CW, Y) f32. Image row v of voxel (x, y, z) is
// dcol[x, v, y], as the script's take_along_axis over the transposed column
// reads it. The arithmetic is the script's, in its order (a voxel's sqrt,
// pitch, row and three divisions stay per voxel), and the library is built
// with -fmad=false, so the plain version (probes/parts.py) agrees bit for
// bit. Stores round to nearest even (bf16) and truncate (int16), as XLA's
// and torch's converts do.
//
// Bound on the card: the output writes (6 B/voxel with three outputs, 2
// with one) and the two column arrays read once. The layout before this one
// (one warp per (x, y) column, lanes along z, a 2-byte store per output,
// lane and voxel) reached 0.46 of it: every store a 64-byte warp access,
// and the four 32-byte sectors of a column row's 128-byte line read by
// warps that ran at different times.
//
// Design: the ablate probe's layout (probe_runs.cuh), which took that
// kernel from 0.47 to 0.61 of its bound. Runs of 8 consecutive columns
// are dealt to the warps in turn, BX runs a warp; lane c holds column c's
// x/y terms (rxy2 and its sqrt), its 32-bit column offset and, for
// kNoGather, the column's row-0 words, and hands them on by shuffle; the
// warp folds 32 neighbours along z, writes each voxel into its tile in
// shared memory, and each lane stores 8 voxels of each array as one 16-byte
// vector (4 or 1 where sizes or alignment forbid 8); the column loads carry
// a 128-byte L2 prefetch. kWriteOnly is the same store path with constants.
// Where Z is a multiple of a chunk (256 voxels; the probe's Z = 256) a chunk
// lies in one column: the warp takes the column's terms by shuffle once a
// chunk and walks z without the carry, which took full BX2 x3 from 1.177 to
// 1.089 ms; 4 blocks an SM with more registers took 1.120.
// probes/parts.py::parts_plan computes the partition on the host; the CPU
// tests walk it.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, 1024x1024x256, device ms, median
// of three in turns with the layout before): full BX2 x3 1.402 -> 1.089
// (0.59 of the 0.641 bound), x1 0.986 -> 0.807, BX4 1.399 -> 1.121, BX8
// 1.411 -> 1.149, nogather 0.814 -> 0.734, writeonly 0.491 -> 0.498 and
// nogeom 0.955 -> 1.220: its row is z (up to H - 1), so a warp's 32 lanes
// read 32 rows, 32 sectors a load, where the layout before had the 8 warps
// of a block on 8 neighbouring columns share each sector in L1.

#include <cuda_bf16.h>
#include <stdint.h>

#include "probe_runs.cuh"

namespace {

constexpr int kWarps = lt::kRunWarps;
constexpr int kCols = lt::kRunCols;
constexpr unsigned int kFull = lt::kAllLanes;

enum Variant { kWriteOnly = 0, kNoGeom = 1, kNoGather = 2, kFullBody = 3 };

struct PartsParams {
  int X, Y, Z, H, CW, BX;
  float vox, trunc;
};

// Off: the column offsets' type (int where the columns hold < 2^31 words);
// kColChunk: Z is a multiple of a chunk (32 * kVec voxels), so a chunk lies
// in one column, whose terms a warp takes once a chunk
template <int kVariant, int kOut, int kVec, typename Off, bool kColChunk>
__global__ void __launch_bounds__(kWarps * 32, lt::kRunMinBlocks)
    probe_parts_kernel(unsigned short* __restrict__ out_tsdf,
                       short* __restrict__ out_label,
                       unsigned short* __restrict__ out_rem,
                       const float* __restrict__ params,
                       const float* __restrict__ dcol,
                       const float* __restrict__ lrcol, const PartsParams p) {
  constexpr int kChunk = 32 * kVec;  // voxels of one pass of the warp
  constexpr bool kTile = kVec > 1;   // else a lane stores the voxel it folds
  constexpr int kTileLen = kTile ? kChunk : 4;
  constexpr bool kThree = kOut == 3;
  // which column terms the variant reads
  constexpr bool kGeom = kVariant == kNoGather || kVariant == kFullBody;
  constexpr bool kGather = kVariant == kNoGeom || kVariant == kFullBody;
  constexpr bool kRow0 = kVariant == kNoGather;
  __shared__ __align__(16) unsigned short s_tile_t[kWarps][kTileLen];
  __shared__ __align__(16) short s_tile_l[kThree ? kWarps : 1][kTileLen];
  __shared__ __align__(16) unsigned short s_tile_r[kThree ? kWarps : 1]
                                                  [kTileLen];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned short* const s_t = s_tile_t[warp];
  short* const s_l = s_tile_l[kThree ? warp : 0];
  unsigned short* const s_r = s_tile_r[kThree ? warp : 0];

  const float ox = __ldg(params + 0);
  const float oy = __ldg(params + 1);
  const float oz = __ldg(params + 2);
  const float fov_up = __ldg(params + 3);
  const float fov_down = __ldg(params + 4);
  const float fov_down_abs = fabsf(fov_down);
  const float fov = fabsf(fov_up) + fov_down_abs;
  const float inv_label = 1.0f / 16384.0f;
  const float inv_rem = (float)(1.0 / 16383.0);
  const long long ncols = (long long)p.X * p.Y;
  // run k of the warp: the warps of the grid take neighbouring runs at
  // once, so that the four 32-byte sectors of a 128-byte line of a column
  // row are read at about one time
  const long long first_run = (long long)blockIdx.x * kWarps + warp;
  const long long run_step = (long long)gridDim.x * kWarps;

  for (int k = 0; k < p.BX; ++k) {
    const long long col0 = (first_run + k * run_step) * kCols;
    if (col0 >= ncols) return;  // the whole warp
    const int cols_here = (int)min((long long)kCols, ncols - col0);
    const int n = cols_here * p.Z;  // voxels of this run

    // ---- lane c holds column c: rxy2, its sqrt, offset of dcol[x, 0, y]
    // and (kNoGather) the column's row-0 words
    float my_pxy = 0.0f, my_r = 0.0f, my_d0 = 0.0f, my_lr0 = 0.0f;
    Off my_off = 0;
    if (kVariant != kWriteOnly && lane < cols_here) {
      const long long col = col0 + lane;
      const int x = (int)(col / p.Y);
      const int y = (int)(col % p.Y);
      const float px = ox + (float)x * p.vox;
      const float py = oy + (float)y * p.vox;
      my_pxy = px * px + py * py;
      my_r = sqrtf(my_pxy);
      my_off = (Off)x * p.CW * p.Y + y;
      if (kVariant == kNoGather) {
        my_d0 = __ldg(dcol + my_off);
        my_lr0 = __ldg(lrcol + my_off);
      }
    }

    const long long base = col0 * (long long)p.Z;
    unsigned short* const g_t = out_tsdf + base;
    short* const g_l = out_label + base;
    unsigned short* const g_r = out_rem + base;

    // one voxel at height z of the column (offset, rxy2, its sqrt, row-0
    // words), in the script's order
    auto fold = [&](Off coff, float pxy, float r, float d0, float lr0, int z,
                    float& t_val, float& l_val, float& r_val) {
      const float gz = (float)z;
      float depth;
      int v;
      bool in_fov;
      if (kVariant == kNoGeom) {
        depth = gz;
        v = min((int)gz, p.H - 1);
        in_fov = gz > 1.0f;
      } else {
        const float pz = oz + gz * p.vox;
        depth = sqrtf(pxy + pz * pz);
        const float t = pz / fmaxf(r, 1e-12f);
        const float pitch = t * (1.0f - 0.33f * t * t);
        in_fov = pitch <= fov_up && pitch >= fov_down;
        const float vf = (1.0f - (pitch + fov_down_abs) / fov) * (float)p.H;
        v = (int)fminf(fmaxf(floorf(vf), 0.0f), (float)(p.H - 1));
      }
      float dval, lr;
      if (kVariant == kNoGather) {
        dval = d0 + 0.0f * depth;
        lr = lr0 + 0.0f * depth;
      } else {
        const Off off = coff + (Off)v * p.Y;
        dval = lt::load_col(dcol + off);
        lr = lt::load_col(lrcol + off);
      }
      const float new_label = floorf(lr * inv_label);
      const float new_rem = (lr - new_label * 16384.0f) * inv_rem;
      const float diff = dval - depth;
      const float dist = fminf(1.0f, diff / p.trunc);
      const bool active = in_fov && dval > 0.0f && diff >= -p.trunc;
      const bool upd = active && dist < 0.0f;
      t_val = upd ? dist : 1.0f;
      l_val = upd ? new_label : 0.0f;
      r_val = upd ? new_rem : 0.0f;
    };

    // the lane's voxel walks the run 32 at a time: (c, z) by carry; with
    // kColChunk a chunk lies in one column (cz, from zc on)
    int c = lane / p.Z;
    int z = lane - c * p.Z;
    int cz = 0, zc = 0;

    for (int i0 = 0; i0 < n; i0 += kChunk) {
      Off u_off = 0;
      float u_pxy = 0.0f, u_r = 0.0f, u_d0 = 0.0f, u_lr0 = 0.0f;
      if constexpr (kColChunk && kVariant != kWriteOnly) {
        if (kGather) u_off = __shfl_sync(kFull, my_off, cz);
        if (kGeom) {
          u_pxy = __shfl_sync(kFull, my_pxy, cz);
          u_r = __shfl_sync(kFull, my_r, cz);
        }
        if (kRow0) {
          u_d0 = __shfl_sync(kFull, my_d0, cz);
          u_lr0 = __shfl_sync(kFull, my_lr0, cz);
        }
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int t_i = j * 32 + lane;  // in the tile
        const int i = i0 + t_i;
        float t_val, l_val, r_val;
        if (kVariant == kWriteOnly) {
          t_val = 1.0f;
          l_val = 2.0f;
          r_val = 3.0f;
        } else if constexpr (kColChunk) {
          fold(u_off, u_pxy, u_r, u_d0, u_lr0, zc + t_i, t_val, l_val,
               r_val);
        } else {
          // past the run (the last chunk's tail) a lane computes on the
          // run's last column, inside the arrays, and stores nothing
          const int cc = min(c, cols_here - 1);
          fold(kGather ? __shfl_sync(kFull, my_off, cc) : (Off)0,
               kGeom ? __shfl_sync(kFull, my_pxy, cc) : 0.0f,
               kGeom ? __shfl_sync(kFull, my_r, cc) : 0.0f,
               kRow0 ? __shfl_sync(kFull, my_d0, cc) : 0.0f,
               kRow0 ? __shfl_sync(kFull, my_lr0, cc) : 0.0f, z, t_val,
               l_val, r_val);
        }
        if constexpr (kTile) {
          s_t[t_i] = lt::bf16_bits(t_val);
          if constexpr (kThree) {
            s_l[t_i] = (short)(int)l_val;
            s_r[t_i] = lt::bf16_bits(r_val);
          }
        } else if (i < n) {
          __stcs(g_t + i, lt::bf16_bits(t_val));
          if constexpr (kThree) {
            __stcs(g_l + i, (short)(int)l_val);
            __stcs(g_r + i, lt::bf16_bits(r_val));
          }
        }
        if constexpr (!kColChunk) {
          z += 32;
          while (z >= p.Z) {
            z -= p.Z;
            ++c;
          }
        }
      }
      if constexpr (kColChunk) {
        zc += kChunk;
        if (zc == p.Z) {
          zc = 0;
          ++cz;
        }
      }
      if constexpr (kTile) {
        __syncwarp();
        if (i0 + lane * kVec < n) {
          lt::tile_to_global<kVec>(s_t, g_t + i0, lane);
          if constexpr (kThree) {
            lt::tile_to_global<kVec>(s_l, g_l + i0, lane);
            lt::tile_to_global<kVec>(s_r, g_r + i0, lane);
          }
        }
        __syncwarp();
      }
    }
  }
}

struct Launch {
  unsigned int grid;
  cudaStream_t st;
  unsigned short* tsdf;
  short* label;
  unsigned short* rem;
  const float* params;
  const float* dcol;
  const float* lrcol;
  PartsParams p;
};

template <int kVariant, int kOut, int kVec, typename Off, bool kColChunk>
void launch(const Launch& a) {
  probe_parts_kernel<kVariant, kOut, kVec, Off, kColChunk>
      <<<a.grid, kWarps * 32, 0, a.st>>>(a.tsdf, a.label, a.rem, a.params,
                                         a.dcol, a.lrcol, a.p);
}

template <int kVariant, int kOut, int kVec>
void launch_off(bool small, const Launch& a) {
  if (small)
    launch<kVariant, kOut, kVec, int, false>(a);
  else
    launch<kVariant, kOut, kVec, long long, false>(a);
}

template <int kVariant, int kOut>
void launch_vec(int vec, bool small, const Launch& a) {
  if (vec == 8 && small && a.p.Z % (32 * 8) == 0)
    launch<kVariant, kOut, 8, int, true>(a);
  else if (vec == 8)
    launch_off<kVariant, kOut, 8>(small, a);
  else if (vec == 4)
    launch_off<kVariant, kOut, 4>(small, a);
  else
    launch_off<kVariant, kOut, 1>(small, a);
}

template <int kVariant>
void launch_out(int n_out, int vec, bool small, const Launch& a) {
  if (n_out == 3)
    launch_vec<kVariant, 3>(vec, small, a);
  else
    launch_vec<kVariant, 1>(vec, small, a);
}

}  // namespace

// Writes the variant's (X, Y, Z) outputs: tsdf bf16 and, with n_out = 3,
// label int16 and remission bf16 (null otherwise). variant: 0 writeonly,
// 1 nogeom, 2 nogather, 3 full. H <= CW. The partition comes from the host
// (probes/parts.py::parts_plan): grid blocks of 8 warps, each warp walking
// BX runs of 8 columns, vec (8, 4 or 1) voxels a lane stores per access;
// the entry refuses a vec the pointers or sizes do not allow. Returns the
// cudaError_t.
extern "C" int lt_probe_parts(void* out_tsdf, void* out_label, void* out_rem,
                              const float* params, const float* dcol,
                              const float* lrcol, int variant, int n_out,
                              int X, int Y, int Z, int H, int CW, int BX,
                              long long grid, int vec, float vox, float trunc,
                              void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return (int)cudaSuccess;
  const long long ncols = (long long)X * Y;
  const uintptr_t outs =
      (uintptr_t)out_tsdf | (uintptr_t)out_label | (uintptr_t)out_rem;
  if (BX < 1 || grid != lt::run_grid(ncols, BX) ||
      (n_out != 1 && n_out != 3) || (vec != 1 && vec != 4 && vec != 8) ||
      !lt::run_vec_fits(vec, Z, ncols, outs, 0) || H < 1 || H > CW)
    return (int)cudaErrorInvalidValue;
  const Launch a{(unsigned int)grid,
                 (cudaStream_t)stream,
                 (unsigned short*)out_tsdf,
                 (short*)out_label,
                 (unsigned short*)out_rem,
                 params,
                 dcol,
                 lrcol,
                 PartsParams{X, Y, Z, H, CW, BX, vox, trunc}};
  const bool small = (long long)X * CW * Y < (1LL << 31);
  switch (variant) {
    case kWriteOnly:
      launch_out<kWriteOnly>(n_out, vec, small, a);
      break;
    case kNoGeom:
      launch_out<kNoGeom>(n_out, vec, small, a);
      break;
    case kNoGather:
      launch_out<kNoGather>(n_out, vec, small, a);
      break;
    case kFullBody:
      launch_out<kFullBody>(n_out, vec, small, a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
