// The partition and store path shared by the ablate and parts probe kernels
// (probe_ablate.cu, probe_parts.cu), the layout of the integrate
// (tsdf_integrate.cu):
//  - A warp owns runs of kCols consecutive (x, y) columns, kCols * Z
//    contiguous voxels each, and walks them in chunks of 32 * kVec voxels
//    with no block-wide barrier. Warp w of the grid's G takes runs w,
//    w + G, ..., so that at any time neighbouring warps are on neighbouring
//    runs; BX, the script's x-planes a grid step, is the runs a warp walks.
//  - Fold: in step j of a chunk lane l takes voxel j * 32 + l, a warp on 32
//    neighbours along z; it writes the voxel into the warp's tile in shared
//    memory, and then each lane stores its kVec consecutive voxels of each
//    array as one vector (kVec = 8: 16 bytes of 2-byte words).
//  - kVec = 4, then 1, where the pointers or sizes do not allow 8.
// probes/runs.py::run_plan computes the same partition on the host.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace lt {

constexpr int kRunWarps = 8;  // warps a block
constexpr int kRunCols = 8;   // consecutive columns of a run
constexpr int kRunMinBlocks = 6;
constexpr unsigned int kAllLanes = 0xffffffffu;

// kBytes bytes as one access
template <int kBytes> struct Word;
template <> struct Word<1> { typedef unsigned char type; };
template <> struct Word<4> { typedef unsigned int type; };
template <> struct Word<8> { typedef uint2 type; };
template <> struct Word<16> { typedef uint4 type; };

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// A lane's kVec voxels of 2-byte words from the tile to device memory.
template <int kVec, typename T>
__device__ __forceinline__ void tile_to_global(const T* tile, T* out, int v) {
  static_assert(sizeof(T) == 2, "compact words");
  typedef typename Word<kVec * 2>::type W;
  __stcs(reinterpret_cast<W*>(out) + v, reinterpret_cast<const W*>(tile)[v]);
}

// A column word, with a 128-byte prefetch into L2: the four 32-byte
// sectors of a line belong to the runs of four neighbouring warps
__device__ __forceinline__ float load_col(const float* p) {
  float v;
  asm("ld.global.nc.L2::128B.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// kVec voxels a lane where every vector of every run is whole and aligned:
// a run starts at a multiple of kRunCols * Z voxels, and only the last,
// short run of a column count that kRunCols does not divide can end inside
// a vector. outs: the output pointers or'ed; table: a byte table read vec
// bytes a lane (0 where there is none).
inline bool run_vec_fits(int vec, int Z, long long ncols, uintptr_t outs,
                         uintptr_t table) {
  return vec == 1 ||
         ((Z % vec == 0 || ncols % kRunCols == 0) && kRunCols % vec == 0 &&
          (outs & (2 * vec - 1)) == 0 && (table & (vec - 1)) == 0);
}

// The grid a partition of BX runs a warp takes.
inline long long run_grid(long long ncols, int BX) {
  const long long runs = (ncols + kRunCols - 1) / kRunCols;
  const long long per_block = (long long)kRunWarps * BX;
  return (runs + per_block - 1) / per_block;
}

}  // namespace lt
