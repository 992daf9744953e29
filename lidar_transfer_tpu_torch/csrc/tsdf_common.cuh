// Voxel geometry shared by the TSDF integrate (tsdf_integrate.cu) and the
// geometry-table kernel (tsdf_geometry.cu), so that a table built by one
// holds exactly the rows the other computes in place.
//
// The expressions are those of lidar_transfer_tpu_torch/ops/tsdf.py (the
// plain versions), in the same order; the library is built with
// -fmad=false, so no product is fused into an add the plain version rounds
// separately.

#pragma once

#include <cuda_runtime.h>

namespace lt {

// One warp per (x, y) column: lanes walk z, the contiguous axis.
constexpr int kThreads = 256;
constexpr int kColumnsPerBlock = kThreads / 32;

// Image row of a voxel at height pz and distance depth from the origin;
// returns false when the voxel's pitch lies outside [fov_down, fov_up].
__device__ __forceinline__ bool voxel_row(float pz, float depth, int H,
                                          float fov_up, float fov_down,
                                          float fov_down_abs, float fov,
                                          int* row) {
  const float safe = fmaxf(depth, 1e-12f);
  const float pitch = asinf(fminf(fmaxf(pz / safe, -1.0f), 1.0f));
  const float v = (1.0f - (pitch + fov_down_abs) / fov) * (float)H;
  *row = (int)fminf(fmaxf(floorf(v), 0.0f), (float)(H - 1));
  return pitch <= fov_up && pitch >= fov_down;
}

}  // namespace lt
