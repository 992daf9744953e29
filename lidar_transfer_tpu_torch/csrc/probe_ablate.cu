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
// (probes/ablate.py) agrees bit for bit. Every voxel reads its row's two
// column words and, with kDiv, performs the three divisions, as TP._kernel
// does: the integrate's shortcuts (no work out of the FOV, no division in
// free space) are not taken, since the probe exists to price them.
//
// Bound on the card: the 7 B/voxel of writes and table read, and the two
// column arrays read once; what stood in the way in the layout before this
// one (one warp per column, 2-byte stores, a one-byte table load a lane and
// step) was the operations a warp issues per voxel.
//
// Design: the layout of the integrate (tsdf_integrate.cu), which measured
// those costs and removed them.
//  - A warp owns runs of kCols consecutive (x, y) columns, kCols * Z
//    contiguous voxels each, and walks them in chunks of 32 * kVec voxels
//    with no block-wide barrier. BX, the script's x-planes a grid step, is
//    the runs a warp walks in turn: warp w of the grid's G takes runs w,
//    w + G, ..., so that at any time neighbouring warps are on neighbouring
//    runs (the outputs do not depend on BX). With runs w * BX .. w * BX +
//    BX - 1 instead, BX 2 and 4 took 1.8 and 2.8 times as long as BX 1.
//  - Lane c holds column c's range in x/y, crop bit and column offset; a
//    voxel takes its column's by shuffle.
//  - Fold: in step j of a chunk lane l takes voxel j * 32 + l, a warp on 32
//    neighbours along z. They read rows of one image column in
//    dcol[x, :, y], the next column of the run (y + 1) the same 32-byte
//    sectors again, and the runs of the next three warps the other three
//    sectors of each 128-byte line: the loads ask L2 for the whole line.
//  - Column offsets are 32-bit where the columns hold fewer than 2^31
//    words: one shuffle and one 32-bit multiply-add a voxel.
//  - The table's rows of a chunk are one coalesced load of kVec bytes a
//    lane, issued a chunk ahead, handed to the fold through shared memory.
//  - The fold writes its voxel into the warp's tile in shared memory; then
//    each lane stores its kVec = 8 consecutive voxels of each array as one
//    16-byte vector, a warp's store 512 contiguous bytes. (The integrate
//    keeps 4 voxels and 8 bytes; here, with every voxel's arithmetic the
//    same, 8 measured faster.)
//  - kVec = 4, then 1, where the pointers or sizes do not allow 8: a table
//    off its 8- or 4-byte alignment, or a last run that ends inside a
//    vector (X * Y not a multiple of kCols and Z not one of kVec). With
//    kVec = 1 the lane that folds a voxel loads its row and stores it, one
//    word an array.
// probes/ablate.py::ablate_plan computes the same partition on the host
// (runs, blocks, kVec) and builds the launch from it; the CPU tests walk it.

#include <cuda_bf16.h>
#include <stdint.h>

#include "probe_runs.cuh"

namespace {

using lt::bf16_bits;
using lt::load_col;
using lt::tile_to_global;
using lt::Word;
constexpr int kWarps = lt::kRunWarps;
constexpr int kCols = lt::kRunCols;
constexpr int kMinBlocks = lt::kRunMinBlocks;
constexpr unsigned int kFull = lt::kAllLanes;

struct AblateParams {
  int X, Y, Z, CW, BX;
  float vox, trunc, inv_trunc;
};

// Off: the column offsets' type (int where the columns hold < 2^31 words)
template <bool kDiv, int kVec, typename Off>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    probe_ablate_kernel(unsigned short* __restrict__ out_tsdf,
                        short* __restrict__ out_label,
                        unsigned short* __restrict__ out_rem,
                        const float* __restrict__ params,
                        const float* __restrict__ dcol,
                        const float* __restrict__ lrcol,
                        const signed char* __restrict__ v_tab,
                        const AblateParams p) {
  constexpr int kChunk = 32 * kVec;  // voxels of one pass of the warp
  constexpr bool kTile = kVec > 1;   // else a lane moves the voxel it folds
  constexpr int kTileLen = kTile ? kChunk : 4;
  __shared__ __align__(16) unsigned short s_tile_f[kWarps][2][kTileLen];
  __shared__ __align__(16) short s_tile_l[kWarps][kTileLen];
  __shared__ __align__(16) signed char s_tile_rows[kWarps][kTileLen];
  typedef typename Word<kVec>::type Rows;  // a lane's kVec table rows

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned short* const s_t = s_tile_f[warp][0];
  unsigned short* const s_r = s_tile_f[warp][1];
  short* const s_l = s_tile_l[warp];
  signed char* const s_rows = s_tile_rows[warp];

  const float ox = __ldg(params + 0);
  const float oy = __ldg(params + 1);
  const float oz = __ldg(params + 2);
  const float obs_w = __ldg(params + 5);
  const float ay = __ldg(params + 6);
  const float az = __ldg(params + 7);
  const float ax = __ldg(params + 8);
  const float inv_obs = 1.0f / obs_w;
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

    // ---- lane c holds column c: x/y range, crop, offset of dcol[x, 0, y]
    float my_pxy = 0.0f;
    Off my_off = 0;
    bool my_crop = false;
    if (lane < cols_here) {
      const long long col = col0 + lane;
      const int x = (int)(col / p.Y);
      const int y = (int)(col % p.Y);
      const float gx = (float)x;
      const float gy = (float)y;
      const float px = ox + gx * p.vox;
      const float py = oy + gy * p.vox;
      my_pxy = px * px + py * py;
      my_crop = gx < ax && gy < ay;
      my_off = (Off)x * p.CW * p.Y + y;
    }
    const unsigned int crop_bits = __ballot_sync(kFull, my_crop);

    const long long base = col0 * (long long)p.Z;
    unsigned short* const g_t = out_tsdf + base;
    short* const g_l = out_label + base;
    unsigned short* const g_r = out_rem + base;
    const signed char* const g_tab = v_tab + base;

    // the lane's voxel walks the run 32 at a time: (c, z) by carry
    int c = lane / p.Z;
    int z = lane - c * p.Z;

    Rows rows_next{};
    if (lane * kVec < n)
      rows_next = __ldcs(reinterpret_cast<const Rows*>(g_tab) + lane);

    for (int i0 = 0; i0 < n; i0 += kChunk) {
      const Rows rows_now = rows_next;
      if constexpr (kTile) reinterpret_cast<Rows*>(s_rows)[lane] = rows_now;
      const int ahead = i0 + kChunk + lane * kVec;
      if (ahead < n)
        rows_next = __ldcs(reinterpret_cast<const Rows*>(g_tab + i0 + kChunk) +
                           lane);
      if constexpr (kTile) __syncwarp();

#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int t_i = j * 32 + lane;  // in the tile
        const int i = i0 + t_i;
        // past the run (the last chunk's tail) a lane computes on the
        // run's last column and row 0..CW-1, inside the arrays, and stores
        // nothing
        const int cc = min(c, cols_here - 1);
        const float pxy = __shfl_sync(kFull, my_pxy, cc);
        const Off coff = __shfl_sync(kFull, my_off, cc);
        const bool in_crop_xy = (crop_bits >> cc) & 1u;
        const float gz = (float)z;
        const float pz = oz + gz * p.vox;
        const float depth = sqrtf(pxy + pz * pz);
        int raw;
        if constexpr (kTile) {
          raw = s_rows[t_i];
        } else {
          raw = (signed char)rows_now;
        }
        const bool in_fov = raw >= 0;
        // a row past the columns (a table built for more image rows than
        // CW) reads the last one, so every read stays inside dcol and lrcol
        const int v = raw < 0 ? 0 : min(raw, p.CW - 1);
        const Off off = coff + (Off)v * p.Y;
        const float dval = load_col(dcol + off);
        const float lr = load_col(lrcol + off);
        const float new_label = floorf(lr * inv_label);
        const float new_rem = (lr - new_label * 16384.0f) * inv_rem;
        const float diff = dval - depth;
        const bool active = in_crop_xy && gz < az && in_fov && dval > 0.0f &&
                            diff >= -p.trunc;
        // reset: the prior state is tsdf 1, weight 0, label 0, remission 0
        const bool same = new_label == 0.0f;
        float dist, tsdf_avg, rem_avg;
        if (kDiv) {
          dist = fminf(1.0f, diff / p.trunc);
          const float w_new = 0.0f + obs_w;
          tsdf_avg = (1.0f * 0.0f + dist) / w_new;
          rem_avg = (0.0f * 0.0f + new_rem) / w_new;
        } else {
          dist = fminf(1.0f, diff * p.inv_trunc);
          tsdf_avg = dist * inv_obs * obs_w;
          rem_avg = new_rem;
        }
        const bool closer = dist < 0.0f;
        const bool upd_same = active && same;
        const bool upd_diff = active && !same && closer;
        const float t = upd_same ? tsdf_avg : (upd_diff ? dist : 1.0f);
        const float l = upd_diff ? new_label : 0.0f;
        const float r = upd_same ? rem_avg : (upd_diff ? new_rem : 0.0f);
        if constexpr (kTile) {
          s_t[t_i] = bf16_bits(t);
          s_l[t_i] = (short)(int)l;
          s_r[t_i] = bf16_bits(r);
        } else if (i < n) {
          __stcs(g_t + i, bf16_bits(t));
          __stcs(g_l + i, (short)(int)l);
          __stcs(g_r + i, bf16_bits(r));
        }
        z += 32;
        while (z >= p.Z) {
          z -= p.Z;
          ++c;
        }
      }
      if constexpr (kTile) {
        __syncwarp();
        if (i0 + lane * kVec < n) {
          tile_to_global<kVec>(s_t, g_t + i0, lane);
          tile_to_global<kVec>(s_l, g_l + i0, lane);
          tile_to_global<kVec>(s_r, g_r + i0, lane);
        }
        __syncwarp();
      }
    }
  }
}

template <int kVec, typename Off>
void launch_vec(bool div, unsigned int grid, cudaStream_t st,
                unsigned short* tsdf, short* label, unsigned short* rem,
                const float* params, const float* dcol, const float* lrcol,
                const signed char* v_tab, const AblateParams& p) {
  if (div) {
    probe_ablate_kernel<true, kVec, Off><<<grid, kWarps * 32, 0, st>>>(
        tsdf, label, rem, params, dcol, lrcol, v_tab, p);
  } else {
    probe_ablate_kernel<false, kVec, Off><<<grid, kWarps * 32, 0, st>>>(
        tsdf, label, rem, params, dcol, lrcol, v_tab, p);
  }
}

template <int kVec>
void launch_off(bool small, bool div, unsigned int grid, cudaStream_t st,
                unsigned short* tsdf, short* label, unsigned short* rem,
                const float* params, const float* dcol, const float* lrcol,
                const signed char* v_tab, const AblateParams& p) {
  if (small)
    launch_vec<kVec, int>(div, grid, st, tsdf, label, rem, params, dcol,
                          lrcol, v_tab, p);
  else
    launch_vec<kVec, long long>(div, grid, st, tsdf, label, rem, params,
                                dcol, lrcol, v_tab, p);
}

}  // namespace

// Writes the (X, Y, Z) compact outputs from params (2, 8) f32, the columns
// (X, CW, Y) f32 and the (X, Y, Z) int8 table. div selects the divisions
// ("precols") or the multiplications ("nodiv"); inv_trunc is the float32
// 1 / trunc of the latter. The partition comes from the host
// (probes/ablate.py::ablate_plan): grid blocks of kWarps warps, each warp
// walking BX runs of kCols columns, vec (8, 4 or 1) voxels a lane moves per
// access; the entry refuses a vec the pointers or sizes do not allow.
// Returns the cudaError_t.
extern "C" int lt_probe_ablate(void* out_tsdf, void* out_label, void* out_rem,
                               const float* params, const float* dcol,
                               const float* lrcol, const signed char* v_tab,
                               int div, int X, int Y, int Z, int CW, int BX,
                               long long grid, int vec, float vox, float trunc,
                               float inv_trunc, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return (int)cudaSuccess;
  const long long ncols = (long long)X * Y;
  const uintptr_t outs =
      (uintptr_t)out_tsdf | (uintptr_t)out_label | (uintptr_t)out_rem;
  if (BX < 1 || grid != lt::run_grid(ncols, BX) ||
      (vec != 1 && vec != 4 && vec != 8) ||
      !lt::run_vec_fits(vec, Z, ncols, outs, (uintptr_t)v_tab))
    return (int)cudaErrorInvalidValue;
  const AblateParams p{X, Y, Z, CW, BX, vox, trunc, inv_trunc};
  const cudaStream_t st = (cudaStream_t)stream;
  auto* tsdf = (unsigned short*)out_tsdf;
  auto* label = (short*)out_label;
  auto* rem = (unsigned short*)out_rem;
  const unsigned int g = (unsigned int)grid;
  const bool small = (long long)X * CW * Y < (1LL << 31);
  if (vec == 8) {
    launch_off<8>(small, div, g, st, tsdf, label, rem, params, dcol, lrcol,
                  v_tab, p);
  } else if (vec == 4) {
    launch_off<4>(small, div, g, st, tsdf, label, rem, params, dcol, lrcol,
                  v_tab, p);
  } else {
    launch_off<1>(small, div, g, st, tsdf, label, rem, params, dcol, lrcol,
                  v_tab, p);
  }
  return (int)cudaGetLastError();
}
