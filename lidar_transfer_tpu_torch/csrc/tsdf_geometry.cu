// Kernel D: the geometry table of a fixed volume placement.
//
// Replaces: lidar_transfer_tpu/ops/tsdf_pallas.py::_precompute_geometry_impl
// (body _geom_kernel). Writes each voxel's image row as int8, -1 where its
// pitch lies outside the vertical FOV. The integrate kernel
// (tsdf_integrate.cu) reads the table instead of computing asinf per
// voxel. Pitch is the exact asinf of lt::voxel_row (tsdf_common.cuh), the
// expression the integrate kernel itself evaluates, not the Pallas atan
// polynomial, so an integrate with the table equals one without it.
//
// Design: one warp per (x, y) column walks z, as the integrate kernel does;
// a warp's store is 32 contiguous bytes. Bound on the card: the per-voxel
// sqrt, asin and division (1 B/voxel written). Built once per placement,
// off the per-frame path, so it is kept simple.

#include "tsdf_common.cuh"

namespace {

struct GeomParams {
  int H, X, Y, Z;
  float ox, oy, oz, vox;
  float fov_up, fov_down, fov_down_abs, fov;
};

__global__ void tsdf_geometry_kernel(signed char* __restrict__ v_tab,
                                     const GeomParams p) {
  const long long col =
      (long long)blockIdx.x * lt::kColumnsPerBlock + (threadIdx.x >> 5);
  if (col >= (long long)p.X * p.Y) return;
  const int x = (int)(col / p.Y);
  const int y = (int)(col % p.Y);
  const float px = p.ox + (float)x * p.vox;
  const float py = p.oy + (float)y * p.vox;
  const float pxy = px * px + py * py;
  const long long base = col * (long long)p.Z;
  for (int z = threadIdx.x & 31; z < p.Z; z += 32) {
    const float pz = p.oz + (float)z * p.vox;
    const float depth = sqrtf(pxy + pz * pz);
    int row;
    const bool in_fov = lt::voxel_row(pz, depth, p.H, p.fov_up, p.fov_down,
                                      p.fov_down_abs, p.fov, &row);
    v_tab[base + z] = (signed char)(in_fov ? row : -1);
  }
}

}  // namespace

// Fills the (X, Y, Z) int8 table v_tab; origin and fov are the float32
// values of the plain version. H <= 128. Returns the cudaError_t.
extern "C" int lt_tsdf_geometry(signed char* v_tab, int H, int X, int Y,
                                int Z, float ox, float oy, float oz,
                                float vox, float fov_up, float fov_down,
                                float fov_down_abs, float fov, void* stream) {
  const long long cols = (long long)X * Y;
  if (cols <= 0 || Z <= 0) return (int)cudaSuccess;
  const GeomParams p{H,  X,   Y,      Z,        ox,           oy,
                     oz, vox, fov_up, fov_down, fov_down_abs, fov};
  const long long blocks =
      (cols + lt::kColumnsPerBlock - 1) / lt::kColumnsPerBlock;
  tsdf_geometry_kernel<<<(unsigned int)blocks, lt::kThreads, 0,
                         (cudaStream_t)stream>>>(v_tab, p);
  return (int)cudaGetLastError();
}
