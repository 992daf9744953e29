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
// not written: the class-aware rule reads it. The arithmetic is written in
// the order of the plain PyTorch version (ops/tsdf.py) and the library is
// built with -fmad=false. Offsets are 64-bit: 2048x2048x208 voxels x 4 B is
// over 2^31 bytes.
//
// Bound on the card: state traffic, written once per call whatever S is
// (12 B/voxel f32 or 6 B/voxel compact in reset mode without the weight,
// 16 or 8 with it), plus the same again read when the state is carried, and
// the table's 1 B/voxel. What stood in the way of those bytes was not the
// memory but the operations a warp issues per voxel, so the design is
// about those.
//
// Design. A warp owns kCols consecutive (x, y) columns, one contiguous run
// of kCols * Z voxels (z is the contiguous axis), and walks it in chunks of
// 32 * kVec voxels with no block-wide barrier anywhere.
//  - Lane c computes column c's yaw, image column and x/y range once (one
//    atan2f a column); a voxel fetches its column's by shuffle.
//  - Fold: in step j of a chunk lane l takes voxel j * 32 + l, so a warp is
//    always on 32 neighbours along z and leaves the cheap path only where a
//    surface crosses them. (With kVec consecutive voxels a lane, every step
//    of every warp had some lane in a truncation band and paid the IEEE
//    divisions for all 32: 8.3 ms for the S = 3 chain where this takes 5.6.)
//  - No arithmetic that cannot change the result: a voxel out of the crop
//    or the FOV does none; min(diff / trunc, 1) is 1 without the division
//    when diff >= trunc (the division is correctly rounded and so monotone,
//    and trunc / trunc is 1), which is all of free space; the two averages
//    and their divisions run only for an update of the same class; label
//    and remission are read only where the depth test passed. The
//    divisions that remain are IEEE divisions, as in the plain version: the
//    results are bit for bit those of the kernel this replaces.
//  - The images arrive column-major and packed, (W, S, 3, H) float32 (depth,
//    label bits, remission; ops/tsdf_cuda.pack_columns), so that the rows a
//    warp's 32 neighbours read lie in one or two 32-byte sectors of one
//    image column and stay in L1 for the next step. (Row-major images cost
//    3*S loads a voxel, each lane in another sector 8 KB apart. Staging
//    whole image columns in shared memory, the other way to get there,
//    moved 2.3 KB a column at S = 3 from L2, as much as the state itself,
//    and cost 2 ms of the chain.) With S fixed at compile time (1 to 4)
//    every image's depth is loaded before the first is used.
//  - The table's rows of a chunk are one coalesced load of kVec bytes a
//    lane, issued a chunk ahead, and handed to the fold through shared
//    memory. (One byte a lane and step, each step waiting for its own
//    32-byte sector from device memory, made the table slower than asinf.)
//  - The fold writes its voxel into the warp's tile in shared memory (2 KB
//    a warp); then each lane moves its kVec = 4 consecutive voxels of each
//    array with one access, 16 bytes of a float32 state and 8 of a compact
//    one, so a warp's store is 512 or 256 contiguous bytes. (8 voxels and 16
//    bytes a lane for the compact state measured 5.2 ms for the chain
//    against 4.2: twice the steps per chunk, unrolled, cost more than the
//    wider store gained.) A run starts at a multiple of kCols * Z voxels,
//    so its vectors are aligned whatever Z is.
//  - kVec = 1, for pointers off their alignment (an odd slab) and for a
//    last run that ends inside a vector (Z and X * Y both odd sizes): the
//    lane that folds a voxel also loads and stores it, one word an array
//    straight from registers, with no tile and no second walk in carried
//    mode. (Through the tile the compact single integrate at Z = 206 took
//    5.6 ms where the warp-per-column kernel before it took 4.8.)
//  - Carried mode reads a vector only if one of its voxels is in the crop
//    and the FOV (a ballot per step), and writes it only if one of them
//    changed (the others get their own bits back).
// Measured on an H100 at 2048x2048x208, 64x2048 images; PERF.md has the
// table.

#include <cuda_bf16.h>
#include <stdint.h>

#include "tsdf_common.cuh"

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kCols = 8;   // consecutive columns a warp owns (<= 32); 4, 16
                           // and 32 measured within 3 % of 8
constexpr int kWide = 4;   // voxels a lane moves per access
// 6 blocks an SM (at most 40 registers): the chain's compact case took
// 4.25 ms against 4.63 with the compiler's own 52-60 registers
constexpr int kMinBlocks = 6;
constexpr unsigned int kFull = 0xffffffffu;

struct Params {
  int S, H, W, X, Y, Z, x_offset;
  float ox, oy, oz, vox;
  float fov_up, fov_down, fov_down_abs, fov, pi, trunc, obs_weight;
  int ax, ay, az;
  int reset, write_weight;
};

// ---- storage: T is the stored word (float / bf16 bits; int / short) ----
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(unsigned short v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ unsigned short from_float<unsigned short>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// A lane's kVec consecutive voxels between the warp's tile and device
// memory: one access of kVec words of T (16 or 8 bytes).
template <int kBytes> struct Wide;
template <> struct Wide<16> { typedef uint4 type; };
template <> struct Wide<8> { typedef uint2 type; };
template <typename T, int kVec>
__device__ __forceinline__ void tile_to_global(const T* tile, T* out, int v) {
  typedef typename Wide<kVec * sizeof(T)>::type W;
  __stcs(reinterpret_cast<W*>(out) + v, reinterpret_cast<const W*>(tile)[v]);
}
template <typename T, int kVec>
__device__ __forceinline__ void global_to_tile(const T* in, T* tile, int v) {
  typedef typename Wide<kVec * sizeof(T)>::type W;
  reinterpret_cast<W*>(tile)[v] = __ldcs(reinterpret_cast<const W*>(in) + v);
}

// The int8 rows of a lane's kVec voxels as one word.
template <int kVec>
__device__ __forceinline__ unsigned int load_rows(const signed char* p) {
  static_assert(kVec == 4 || kVec == 1, "rows move as one 32-bit word");
  if (kVec == 4) return __ldcs(reinterpret_cast<const unsigned int*>(p));
  return (unsigned char)__ldcs(p);
}
__device__ __forceinline__ void rows_to_tile(signed char* tile,
                                             unsigned int rows) {
  *reinterpret_cast<unsigned int*>(tile) = rows;
}

// F, L: stored words of tsdf/weight/rem and of label. kVec: voxels a lane
// moves per access to device memory. kTable: the row comes from v_tab.
// kS > 0 fixes the image count at compile time (1 to 4: the single
// integrate and the usual windows), kS = 0 reads it from p.S: one kernel
// with table and S as run-time values measured 17 % slower than specialised
// ones, and the compact chain of S = 3 took 5.2 ms with S read at run time
// where it takes 4.2.
template <typename F, typename L, int kVec, bool kTable, int kS>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    tsdf_integrate_kernel(F* __restrict__ tsdf, F* __restrict__ weight,
                          L* __restrict__ label, F* __restrict__ rem,
                          const float* __restrict__ packed,
                          const signed char* __restrict__ v_tab,
                          const Params p) {
  constexpr int kChunk = 32 * kVec;  // voxels of one pass of the warp
  constexpr bool kTile = kVec > 1;   // else a lane moves the voxel it folds
  constexpr int kTileLen = kTile ? kChunk : 4;
  // the warp's tile: kChunk voxels of each state array
  __shared__ __align__(16) F s_tile_f[kWarps][3][kTileLen];
  __shared__ __align__(16) L s_tile_l[kWarps][kTileLen];
  __shared__ __align__(4) signed char
      s_tile_rows[kWarps][kTable && kTile ? kChunk : 8];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  F* const s_t = s_tile_f[warp][0];
  F* const s_w = s_tile_f[warp][1];
  F* const s_r = s_tile_f[warp][2];
  L* const s_l = s_tile_l[warp];
  signed char* const s_rows = s_tile_rows[warp];

  const int S = kS > 0 ? kS : p.S;
  const int chunk = 3 * S * p.H;  // floats of one image column
  const long long ncols = (long long)p.X * p.Y;
  const long long col0 = ((long long)blockIdx.x * kWarps + warp) * kCols;
  if (col0 >= ncols) return;  // the whole warp
  const int cols_here = (int)min((long long)kCols, ncols - col0);
  const int n = cols_here * p.Z;  // voxels of this warp's run

  // ---- lane c holds column c: x/y range and image column (-1: cropped)
  float my_pxy = 0.0f;
  int my_ux = -1;
  if (lane < cols_here) {
    const long long col = col0 + lane;
    const int x = (int)(col / p.Y);
    const int y = (int)(col % p.Y);
    const int gxi = x + p.x_offset;  // global x index of this slab's column
    const float px = p.ox + (float)gxi * p.vox;
    const float py = p.oy + (float)y * p.vox;
    my_pxy = px * px + py * py;
    if (gxi < p.ax && y < p.ay) {
      const float yaw = -atan2f(py, px);
      const float u = 0.5f * (yaw / p.pi + 1.0f) * (float)p.W;
      my_ux = (int)fminf(fmaxf(floorf(u), 0.0f), (float)(p.W - 1));
    }
  }

  const long long base = col0 * (long long)p.Z;
  F* const g_t = tsdf + base;
  F* const g_w = weight + base;
  F* const g_r = rem + base;
  L* const g_l = label + base;
  const signed char* const g_tab = kTable ? v_tab + base : nullptr;
  const float neg_trunc = -p.trunc;

  // the lane's voxel walks the run 32 at a time: (c, z) by carry, no division
  int c = lane / p.Z;
  int z = lane - c * p.Z;

  // the table's rows of a chunk come as one coalesced load, a chunk ahead
  unsigned int rows_next = 0;
  if (kTable && lane * kVec < n)
    rows_next = load_rows<kVec>(g_tab + lane * kVec);

  for (int i0 = 0; i0 < n; i0 += kChunk) {
    const bool have_vec = i0 + lane * kVec < n;  // the lane's own vector
    unsigned int changed_bits = 0;  // of the lane's own kVec voxels
    const unsigned int rows_now = rows_next;
    if (kTable) {
      if constexpr (kTile) rows_to_tile(s_rows + lane * kVec, rows_now);
      const int ahead = i0 + kChunk + lane * kVec;
      if (ahead < n) rows_next = load_rows<kVec>(g_tab + ahead);
      if constexpr (kTile) __syncwarp();
    }

    if constexpr (kTile) {
      if (!p.reset) {
        // carried: which vectors hold a voxel in the crop and the FOV?
        unsigned int act_bits = 0;
        int ca = c, za = z;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int i = i0 + j * 32 + lane;
          const int cc = min(ca, kCols - 1);
          const int ux = __shfl_sync(kFull, my_ux, cc);
          const float pxy = __shfl_sync(kFull, my_pxy, cc);
          bool act = i < n && ux >= 0 && za < p.az;
          if (act) {
            if (kTable) {
              act = s_rows[j * 32 + lane] >= 0;
            } else {
              const float pz = p.oz + (float)za * p.vox;
              int vy;
              act = lt::voxel_row(pz, sqrtf(pxy + pz * pz), p.H, p.fov_up,
                                  p.fov_down, p.fov_down_abs, p.fov, &vy);
            }
          }
          // voxel j * 32 + l of the chunk belongs to lane (j * 32 + l) / kVec
          const unsigned int m = __ballot_sync(kFull, act);
          const int pos = lane * kVec - j * 32;  // the lane's first bit in m
          if (pos >= 0 && pos < 32)
            act_bits = (m >> pos) & ((1u << kVec) - 1u);
          za += 32;
          while (za >= p.Z) {
            za -= p.Z;
            ++ca;
          }
        }
        if (have_vec && act_bits) {
          global_to_tile<F, kVec>(g_t + i0, s_t, lane);
          global_to_tile<F, kVec>(g_w + i0, s_w, lane);
          global_to_tile<F, kVec>(g_r + i0, s_r, lane);
          global_to_tile<L, kVec>(g_l + i0, s_l, lane);
        }
        __syncwarp();
      }
    }

    // ---- fold: lane l on voxel j * 32 + l, a warp on 32 neighbours along
    // z, so that it leaves the cheap path only near a surface
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int t_i = j * 32 + lane;  // in the tile
      const int i = i0 + t_i;
      const int cc = min(c, kCols - 1);
      const int ux = __shfl_sync(kFull, my_ux, cc);
      const float pxy = __shfl_sync(kFull, my_pxy, cc);
      bool base_active = i < n && ux >= 0 && z < p.az;
      int vy = 0;
      float depth = 0.0f;
      if (base_active) {
        const float pz = p.oz + (float)z * p.vox;
        if (kTable) {
          vy = kTile ? (int)s_rows[t_i] : (int)(signed char)rows_now;
          base_active = vy >= 0;
          if (base_active) depth = sqrtf(pxy + pz * pz);
        } else {
          depth = sqrtf(pxy + pz * pz);
          base_active = lt::voxel_row(pz, depth, p.H, p.fov_up, p.fov_down,
                                      p.fov_down_abs, p.fov, &vy);
        }
      }
      // reset: the init constants; carried: the stored state (in the tile
      // or, one voxel a lane, in device memory)
      float t = 1.0f, w = 0.0f, r = 0.0f;
      int l = 0;
      bool changed = false;
      if (base_active) {
        if (!p.reset) {
          t = to_float(kTile ? s_t[t_i] : g_t[i]);
          w = to_float(kTile ? s_w[t_i] : g_w[i]);
          r = to_float(kTile ? s_r[t_i] : g_r[i]);
          l = (int)(kTile ? s_l[t_i] : g_l[i]);
        }
        const float* const pixel = packed + (long long)ux * chunk + vy;
        float ahead[kS > 0 ? kS : 1];  // every image's depth, loaded at once
        if constexpr (kS > 0) {
#pragma unroll
          for (int s = 0; s < kS; ++s) ahead[s] = __ldg(pixel + s * 3 * p.H);
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float* const q = pixel + s * 3 * p.H;
          const float dval = kS > 0 ? ahead[s] : __ldg(q);
          const float diff = dval - depth;
          if (!(dval > 0.0f && diff >= neg_trunc)) continue;
          const int nl = __float_as_int(__ldg(q + p.H));
          // min(diff / trunc, 1): 1 wherever diff >= trunc
          const float dist = diff >= p.trunc ? 1.0f : diff / p.trunc;
          if (l == nl) {
            const float nr = __ldg(q + 2 * p.H);
            const float w_new = w + p.obs_weight;
            t = (t * w + dist) / w_new;
            r = (r * w + nr) / w_new;
            w = w_new;
            changed = true;
          } else if (dist < w) {
            t = dist;
            l = nl;
            r = __ldg(q + 2 * p.H);
            changed = true;
          }
        }
      }
      if constexpr (!kTile) {
        // reset: an untouched voxel still holds the init constants
        if (i < n && (changed || p.reset)) {
          __stcs(g_t + i, from_float<F>(t));
          __stcs(g_l + i, (L)l);
          __stcs(g_r + i, from_float<F>(r));
          if (p.write_weight) __stcs(g_w + i, from_float<F>(w));
        }
      } else if (changed) {
        s_t[t_i] = from_float<F>(t);
        s_w[t_i] = from_float<F>(w);
        s_r[t_i] = from_float<F>(r);
        s_l[t_i] = (L)l;
      } else if (p.reset) {
        s_t[t_i] = from_float<F>(1.0f);
        s_w[t_i] = (F)0;
        s_r[t_i] = (F)0;
        s_l[t_i] = (L)0;
      }
      if (kTile && !p.reset) {
        const unsigned int m = __ballot_sync(kFull, changed);
        const int pos = lane * kVec - j * 32;
        if (pos >= 0 && pos < 32)
          changed_bits = (m >> pos) & ((1u << kVec) - 1u);
      }
      z += 32;
      while (z >= p.Z) {
        z -= p.Z;
        ++c;
      }
    }
    if constexpr (kTile) {
      __syncwarp();
      // ---- the tile to device memory, 16 bytes a lane and array; carried:
      // only a vector with a changed voxel (its others get their bits back)
      if (have_vec && (p.reset || changed_bits)) {
        tile_to_global<F, kVec>(s_t, g_t + i0, lane);
        tile_to_global<L, kVec>(s_l, g_l + i0, lane);
        tile_to_global<F, kVec>(s_r, g_r + i0, lane);
        if (p.write_weight) tile_to_global<F, kVec>(s_w, g_w + i0, lane);
      }
      __syncwarp();
    }
  }
}

template <typename F, typename L, int kVec>
cudaError_t launch_typed(dim3 grid, cudaStream_t st, F* tsdf, F* weight,
                         L* label, F* rem, const float* packed,
                         const signed char* v_tab, const Params& p) {
#define LT_LAUNCH(TABLE, S)                                              \
  tsdf_integrate_kernel<F, L, kVec, TABLE, S><<<grid, kWarps * 32, 0, st>>>( \
      tsdf, weight, label, rem, packed, v_tab, p)
  // the window sizes in use get a kernel of their own (kVec > 1 only: the
  // scalar kernels are the rare fallback)
#define LT_BY_S(TABLE)                                      \
  switch (kVec > 1 || p.S == 1 ? p.S : 0) {                 \
    case 1: LT_LAUNCH(TABLE, 1); break;                     \
    case 2: if constexpr (kVec > 1) LT_LAUNCH(TABLE, 2); break; \
    case 3: if constexpr (kVec > 1) LT_LAUNCH(TABLE, 3); break; \
    case 4: if constexpr (kVec > 1) LT_LAUNCH(TABLE, 4); break; \
    default: LT_LAUNCH(TABLE, 0);                           \
  }
  if (v_tab != nullptr) {
    LT_BY_S(true)
  } else {
    LT_BY_S(false)
  }
#undef LT_BY_S
#undef LT_LAUNCH
  return cudaGetLastError();
}

bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) & 15) ==
         0;
}

int launch(void* tsdf, void* weight, void* label, void* rem,
           const float* packed, const signed char* v_tab, int compact,
           const Params& p, void* stream) {
  const long long cols = (long long)p.X * p.Y;
  if (cols <= 0 || p.Z <= 0) return (int)cudaSuccess;
  const long long per_block = (long long)kWarps * kCols;
  const dim3 grid((unsigned int)((cols + per_block - 1) / per_block));
  const cudaStream_t st = (cudaStream_t)stream;
  // kWide voxels an access where every vector of every warp's run is whole
  // and aligned: a run starts at a multiple of kCols * Z voxels, and only
  // the last, short run of a column count that kCols does not divide can end
  // inside a vector
  static_assert(kCols % kWide == 0, "a run must start on a vector");
  const bool wide = (p.Z % kWide == 0 || cols % kCols == 0) &&
                    aligned16(tsdf, weight, label, rem) &&
                    ((uintptr_t)v_tab & (kWide - 1)) == 0;
  typedef unsigned short B;  // bf16 bits
  if (compact) {
    return (int)(wide ? launch_typed<B, short, kWide>(grid, st, (B*)tsdf,
                                                  (B*)weight, (short*)label,
                                                  (B*)rem, packed, v_tab, p)
                      : launch_typed<B, short, 1>(grid, st, (B*)tsdf,
                                                  (B*)weight, (short*)label,
                                                  (B*)rem, packed, v_tab, p));
  }
  return (int)(wide ? launch_typed<float, int, kWide>(grid, st, (float*)tsdf,
                                                  (float*)weight, (int*)label,
                                                  (float*)rem, packed, v_tab,
                                                  p)
                    : launch_typed<float, int, 1>(grid, st, (float*)tsdf,
                                                  (float*)weight, (int*)label,
                                                  (float*)rem, packed, v_tab,
                                                  p));
}

}  // namespace

// Updates the (X, Y, Z) state arrays in place from one image. packed is the
// (W, 1, 3, H) float32 column-major image record (depth, label bits,
// remission). compact selects bf16/bf16/int16/bf16
// storage (else f32/f32/i32/f32); v_tab is the (X, Y, Z) int8 row table or
// null; x_offset is the slab's first global x index; origin, fov and trunc
// are the float32 values the plain version uses. Returns the cudaError_t.
extern "C" int lt_tsdf_integrate(
    void* tsdf, void* weight, void* label, void* rem, const float* packed,
    const signed char* v_tab, int compact, int H, int W, int X, int Y, int Z,
    int x_offset, float ox, float oy, float oz, float vox, float fov_up,
    float fov_down, float fov_down_abs, float fov, float pi, float trunc,
    float obs_weight, int ax, int ay, int az, int reset, int write_weight,
    void* stream) {
  const Params p{1,      H,        W,            X,   Y,     Z,
                 x_offset, ox,     oy,           oz,  vox,   fov_up,
                 fov_down, fov_down_abs, fov,    pi,  trunc, obs_weight,
                 ax,     ay,       az,           reset, write_weight};
  return launch(tsdf, weight, label, rem, packed, v_tab, compact, p, stream);
}

// The S-scan chain: packed is (W, S, 3, H); the first image is applied onto
// the init constants, the state written once. Other arguments as above.
extern "C" int lt_tsdf_integrate_chain(
    void* tsdf, void* weight, void* label, void* rem, const float* packed,
    const signed char* v_tab, int compact, int S, int H, int W, int X, int Y,
    int Z, int x_offset, float ox, float oy, float oz, float vox,
    float fov_up, float fov_down, float fov_down_abs, float fov, float pi,
    float trunc, float obs_weight, int ax, int ay, int az, int write_weight,
    void* stream) {
  const Params p{S,      H,        W,            X,   Y,     Z,
                 x_offset, ox,     oy,           oz,  vox,   fov_up,
                 fov_down, fov_down_abs, fov,    pi,  trunc, obs_weight,
                 ax,     ay,       az,           1,   write_weight};
  return launch(tsdf, weight, label, rem, packed, v_tab, compact, p, stream);
}
