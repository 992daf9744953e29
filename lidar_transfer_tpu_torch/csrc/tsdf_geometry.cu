// Kernel D: the geometry table of a fixed volume placement.
//
// Replaces: lidar_transfer_tpu/ops/tsdf_pallas.py::_precompute_geometry_impl
// (body _geom_kernel). Writes each voxel's image row as int8, -1 where its
// pitch lies outside the vertical FOV. The integrate kernel
// (tsdf_integrate.cu) reads the table instead of computing asinf per
// voxel. The table holds, at every voxel, exactly what lt::voxel_row
// (tsdf_common.cuh) gives, the expression the integrate kernel evaluates
// in place (an exact asinf, not the Pallas atan polynomial), so an
// integrate with the table equals one without it bit for bit.
//
// Two modes of one entry.
//
// Exact mode (exact != 0): one warp per (x, y) column walks z, a voxel and
// a byte store a lane and step, and every voxel evaluates lt::voxel_row: a
// sqrtf, an IEEE division, an asinf, a second division, the floor and the
// clamps, about 100 instructions a voxel. It is bound by those
// instructions (2.95 ms at 2048x2048x208 where the 872 MB of stores take
// 0.26). It is what the fast mode is held against byte for byte, and it is
// selected only by the caller's flag: nothing falls back to it.
//
// Fast mode (the default). For a fixed (fov, H) the table's value is a step
// function of the pitch with at most H - 1 row edges and the two FOV
// limits, and the pitch is a monotone function of tan(pitch) = pz / r_xy.
// The host (ops/tsdf.py::geometry_edges, float64) sorts those edges in tan
// space and hands the kernel, by value in its parameters, the intervals
// between them: for interval i the open range (lo[i], hi[i]) of tan values
// that are safely inside it, and its value val[i]. A voxel's estimate is
// t = pz * rsqrtf(pxy), pxy and the reciprocal root once a lane:
//  - a lane owns 16 consecutive bytes of the table (16 voxels along z, the
//    contiguous axis) and writes them with one 16-byte store, so a warp's
//    store is 512 contiguous bytes. (A lane that walked a whole column, its
//    setup paid once for Z voxels, stored 16 bytes every Z and took 2.74 ms
//    where this takes 0.59.)
//  - the walk starts at the interval a 1024-bin table of the edges' range
//    gives for the lane's first estimate, two steps at most from the right
//    one; along z the estimate only rises, so each later voxel steps at
//    most one interval up (t >= hi[i]) and only then reads lo, hi and val
//    of the next interval from shared memory, one 16-byte load. (With a
//    binary search a lane, two loads a step and pz rounded twice, 0.88 ms,
//    whether the loads ran at every voxel or only on a step; with the
//    table, the one load and pz as one fused multiply-add 0.66; the fused
//    pz did not stay, see the next point.)
//  - pz is taken as the exact expression takes it, oz + z * vox in two
//    roundings: where oz and z * vox cancel (pz near 0 at |oz| of metres) a
//    fused multiply-add differs from it by half an ulp of z * vox, a
//    hundred ulps of pz, which next to the sensor is more in tan space than
//    a band is wide.
//  - where the column lies far enough from the sensor (dt = vox / r_xy at
//    most the least distance of two edges) a lane's 16 estimates are
//    t0 + j * dt, one instruction each (each from its own pz: 0.63 ms);
//    there the roundings of the exact pz are errors of the estimate, at
//    most 2 ulp of the largest height times 1 / r_xy <= gap / vox, and the
//    band has a term for them.
//    Next to the sensor one voxel up can cross several edges: each
//    estimate is computed from its own pz and the walk takes up to 8 steps
//    a voxel (one step a voxel everywhere left 2e-3 of the reference
//    volume's voxels and 0.12 of a 256x256x208 volume's to the exact
//    expression, that volume slower than the exact mode; two steps a voxel
//    everywhere took 0.84 ms, a loop of steps 1.15).
//  - the voxel is decided by the estimate only if lo[i] < t < hi[i]. The
//    intervals' safe ranges are disjoint, so whatever i the stepping
//    reached, a voxel that passes this test lies in interval i: a voxel the
//    stepping lost (more edges crossed in one step than it takes, a NaN
//    estimate in a column through the sensor) fails it. Every voxel that
//    fails is evaluated by lt::voxel_row exactly, after the lane's 16
//    estimates, so the loop itself does not branch.
//  - Z not a multiple of 16, or a table off 16-byte alignment: the same
//    kernel over the flat array from its first aligned byte on, a lane's
//    voxels running into the next column, the flat index divided in 64
//    bits (1.6 to 1.75 ms).
// What bounds it: instructions, about 10 a voxel in the walk and 60 a
// lane to start it, where the exact mode runs about 100 a voxel; 4 to 8
// blocks an SM measured within 6 % of each other.
//
// The guard band (geometry_edges) around an edge at pitch p, T = tan p:
//   in pitch, delta = 2.4e-7 * fov   the float32 roundings of the row
//                                    expression (sum, division, 1 - x, * H),
//                   + 4.8e-7         asinf, 4 ulp at |pitch| <= pi / 2,
//                   + 2.4e-7 * |T|   the exact ratio pz / depth, 2 ulp,
//                   + 4.8e-7 * |T|   the estimate: rsqrtf 2 ulp, the
//                                    product and the rounding of the
//                                    stored edge, stated as 4 ulp relative,
//   in tan space step = 1.53e-5 * g  where a lane takes its 16 estimates as
//                                    t0 + j * dt (above), 8 ulp of at most
//                                    16 * dt, dt <= g, the least distance
//                                    of two edges,
//                + 2 ulp(M) * g / vox   the same lanes: the roundings of pz
//                                    at the lane's first voxel and at this
//                                    one, M the largest |height| of the
//                                    volume (|oz|, |oz + Z * vox|, Z * vox),
//   band = 2 * (delta * (1 + T * T) + step), twice what the sum asks,
// and lo and hi are rounded away from the edge. Pitches beyond +-1.55 rad
// have no safe interval. At the reference point 3e-4 of the voxels in the
// FOV lie in a band.
//
// Bound on the card: 1 B a voxel written. Measured on an H100 at
// 2048x2048x208; PERF.md has the table.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tsdf_common.cuh"

namespace {

constexpr int kVec = 16;        // voxels (bytes) a lane owns
constexpr int kMaxIntervals = 152;  // 127 row edges, 2 limits, 2 caps: 132
                                    // intervals, and 18 steps of padding
constexpr int kMinBlocks = 6;   // blocks an SM; 4 to 8 within 6 %

struct GeomParams {
  int H, X, Y, Z;
  float ox, oy, oz, vox;
  float fov_up, fov_down, fov_down_abs, fov;
};

struct Intervals {
  int n;  // intervals before the padding
  float lo[kMaxIntervals];
  float hi[kMaxIntervals];
  signed char val[kMaxIntervals];
};

// n / d for 0 <= n < 2^31 as a product and a shift.
struct FastDiv {
  unsigned int d, mul, shr;
  __device__ __forceinline__ unsigned int div(unsigned int n) const {
    return d == 1 ? n : __umulhi(n, mul) >> shr;
  }
};

FastDiv make_fastdiv(unsigned int d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    unsigned int log2 = 0;
    while ((1ull << log2) < d) ++log2;
    const unsigned int p = 31 + log2;
    f.mul = (unsigned int)(((1ull << p) + d - 1) / d);
    f.shr = p - 32;
  }
  return f;
}

__device__ __forceinline__ signed char exact_row(const GeomParams& p,
                                                 float pxy, int z) {
  const float pz = p.oz + (float)z * p.vox;
  const float depth = sqrtf(pxy + pz * pz);
  int row;
  const bool in_fov = lt::voxel_row(pz, depth, p.H, p.fov_up, p.fov_down,
                                    p.fov_down_abs, p.fov, &row);
  return (signed char)(in_fov ? row : -1);
}

__device__ __forceinline__ float column_pxy(const GeomParams& p, int x,
                                            int y) {
  const float px = p.ox + (float)x * p.vox;
  const float py = p.oy + (float)y * p.vox;
  return px * px + py * py;
}

// ---- exact mode ----
__global__ void tsdf_geometry_exact_kernel(signed char* __restrict__ v_tab,
                                           const GeomParams p) {
  const long long col =
      (long long)blockIdx.x * lt::kColumnsPerBlock + (threadIdx.x >> 5);
  if (col >= (long long)p.X * p.Y) return;
  const float pxy = column_pxy(p, (int)(col / p.Y), (int)(col % p.Y));
  const long long base = col * (long long)p.Z;
  for (int z = threadIdx.x & 31; z < p.Z; z += 32)
    v_tab[base + z] = exact_row(p, pxy, z);
}

// ---- fast mode ----
constexpr int kBins = 1024;   // bins of the table that starts a lane's walk

// One block's shared copy of the intervals, {lo, hi, value bits, unused}
// an interval, and for each of kBins equal bins of the edges' tan range the
// interval its lower end lies in.
struct SharedIntervals {
  float4 iv[kMaxIntervals];
  unsigned char start[kBins];
};

// smallest i in [0, n) with t < hi[i] (hi[n - 1] is +inf)
__device__ __forceinline__ int find_interval(const float4* iv, int n,
                                             float t) {
  int a = 0, b = n - 1;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (t >= iv[mid].y) a = mid + 1; else b = mid;
  }
  return a;
}

__device__ __forceinline__ void load_intervals(SharedIntervals& s,
                                               const Intervals& e,
                                               float t_min, float bins_per_t) {
#pragma unroll 8
  for (int k = 0; k < kMaxIntervals; ++k)   // uniform index: constant bank
    if ((int)threadIdx.x == k)
      s.iv[k] = make_float4(e.lo[k], e.hi[k],
                            __int_as_float((int)(unsigned char)e.val[k]),
                            0.0f);
  __syncthreads();
  // bin 0 also takes every estimate below the range: it starts at 0
  for (int k = threadIdx.x; k < kBins; k += blockDim.x)
    s.start[k] = k == 0 || bins_per_t <= 0.0f
                     ? 0
                     : (unsigned char)find_interval(
                           s.iv, e.n, t_min + (float)k / bins_per_t);
  __syncthreads();
}

// A lane's walk up one column: rinv = 1 / r_xy, the byte offset of the
// interval its last voxel lay in, and that interval.
struct Walk {
  float rinv;
  unsigned int at;
  float4 iv;
};

__device__ __forceinline__ void step_up(const SharedIntervals& s, Walk& k,
                                        float t) {
  if (t >= k.iv.y) {                        // one interval up
    k.at += sizeof(float4);
    k.iv = *reinterpret_cast<const float4*>(
        reinterpret_cast<const char*>(s.iv) + k.at);
  }
}

// The estimate of tan(pitch) at height index fz, from the pz of the exact
// expression (two roundings; -fmad=false keeps them apart).
__device__ __forceinline__ float estimate(const GeomParams& p, float rinv,
                                          float fz) {
  return (p.oz + fz * p.vox) * rinv;
}

__device__ __forceinline__ Walk start_walk(const SharedIntervals& s,
                                           const GeomParams& p, float t_min,
                                           float bins_per_t, float pxy,
                                           float fz) {
  Walk k;
  // a column through the sensor: a NaN estimate is safe nowhere
  k.rinv = pxy > 0.0f ? rsqrtf(pxy) : __int_as_float(0x7fc00000);
  const float t = estimate(p, k.rinv, fz);
  const float bin = fminf(fmaxf((t - t_min) * bins_per_t, 0.0f),
                          (float)(kBins - 1));
  k.at = (unsigned int)s.start[(int)bin] * (unsigned int)sizeof(float4);
  k.iv = *reinterpret_cast<const float4*>(
      reinterpret_cast<const char*>(s.iv) + k.at);
  step_up(s, k, t);     // the bin's lower end may lie two edges below t;
  step_up(s, k, t);     // further off, the voxels fail the test below
  return k;
}

// Byte j & 3 of a word: selector of __byte_perm(word, value, selector).
__device__ __forceinline__ unsigned int put_byte(unsigned int w,
                                                 unsigned int v, int k) {
  return k == 0 ? v
                : __byte_perm(w, v, k == 1 ? 0x3240 : k == 2 ? 0x3410
                                                             : 0x4210);
}

// kAligned: Z is a multiple of 16 and the table 16-byte aligned, so a
// lane's 16 voxels lie in one column and vector v is column v / (Z / 16).
// Otherwise the vectors start at the first aligned byte (head voxels
// before it, a tail after the last vector: block 0 evaluates those
// exactly), a lane's voxels may run into the next column, and the flat
// index is divided in 64 bits.
template <bool kAligned>
__global__ void __launch_bounds__(lt::kThreads, kMinBlocks)
tsdf_geometry_fast_kernel(signed char* __restrict__ v_tab,
                          const GeomParams p, const Intervals e,
                          const float t_min, const float bins_per_t,
                          const float min_gap, const FastDiv by_vpc, const FastDiv by_y,
                          const long long head, const long long n_vec,
                          unsigned long long* __restrict__ n_exact) {
  __shared__ SharedIntervals s;
  load_intervals(s, e, t_min, bins_per_t);
  if (!kAligned && blockIdx.x == 0 && threadIdx.x < 2 * kVec) {
    const long long total = (long long)p.X * p.Y * p.Z;
    const long long tail0 = head + n_vec * kVec;
    const long long f = (int)threadIdx.x < kVec
                            ? (long long)threadIdx.x
                            : tail0 + ((int)threadIdx.x - kVec);
    const bool mine = (int)threadIdx.x < kVec ? f < head : f < total;
    if (mine) {
      const long long col = f / p.Z;
      v_tab[f] = exact_row(p, column_pxy(p, (int)(col / p.Y),
                                         (int)(col % p.Y)),
                           (int)(f % p.Z));
    }
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    const long long f0 = head + v * kVec;
    int x, y, z;
    if (kAligned) {
      const unsigned int col = by_vpc.div((unsigned int)v);
      z = (int)((unsigned int)v - col * by_vpc.d) * kVec;
      x = (int)by_y.div(col);
      y = (int)(col - (unsigned int)x * by_y.d);
    } else {
      const long long col = f0 / p.Z;
      z = (int)(f0 - col * p.Z);
      x = (int)(col / p.Y);
      y = (int)(col - (long long)x * p.Y);
    }
    float pxy = column_pxy(p, x, y);
    float fz = (float)z;
    Walk k = start_walk(s, p, t_min, bins_per_t, pxy, fz);
    unsigned int w[4] = {0u, 0u, 0u, 0u};
    unsigned int flags = 0u;
    int zz = z;
    const float dt = p.vox * k.rinv;
    const float t0 = estimate(p, k.rinv, fz);
    // near: next to the sensor one voxel up can cross several edges, and a
    // walk of one step a voxel falls behind for good: up to 8 steps there
    auto walk = [&](auto near) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (!kAligned && zz == p.Z) {       // into the next column
          zz = 0;
          fz = 0.0f;
          if (++y == p.Y) { y = 0; ++x; }
          pxy = column_pxy(p, x, y);
          k = start_walk(s, p, t_min, bins_per_t, pxy, 0.0f);
        }
        // away from the sensor, in one column: the estimate from the
        // lane's first voxel and the step a voxel, one instruction
        const float t = kAligned && !decltype(near)::value
                            ? __fmaf_rn((float)j, dt, t0)
                            : estimate(p, k.rinv, fz);
        step_up(s, k, t);
        if (decltype(near)::value)
          for (int r = 0; r < 7 && t >= k.iv.y; ++r) step_up(s, k, t);
        flags |= (t > k.iv.x && t < k.iv.y) ? 0u : (1u << j);
        w[j >> 2] = put_byte(w[j >> 2], __float_as_uint(k.iv.z), j & 3);
        fz += 1.0f;
        if (!kAligned) ++zz;
      }
    };
    if (dt > min_gap) walk(std::true_type{});
    else walk(std::false_type{});
    if (flags) {
      if (n_exact) atomicAdd(n_exact, (unsigned long long)__popc(flags));
      do {
        const int j = __ffs(flags) - 1;
        flags &= flags - 1;
        int zj = z + j;
        float pj = pxy;
        if (!kAligned) {
          const long long cj = (f0 + j) / p.Z;
          zj = (int)(f0 + j - cj * p.Z);
          pj = column_pxy(p, (int)(cj / p.Y), (int)(cj % p.Y));
        }
        const unsigned int b = (unsigned char)exact_row(p, pj, zj);
        const int sh = 8 * (j & 3);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if ((j >> 2) == q) w[q] = (w[q] & ~(0xffu << sh)) | (b << sh);
      } while (flags);
    }
    __stcs(reinterpret_cast<uint4*>(v_tab + f0),
           make_uint4(w[0], w[1], w[2], w[3]));
  }
}

}  // namespace

// Fills the (X, Y, Z) int8 table v_tab; origin and fov are the float32
// values of the plain version. H <= 128. exact != 0 selects the exact mode;
// else lo, hi and val are host arrays of n_intervals entries
// (ops/tsdf.py::geometry_edges), n_intervals + 18 <= 152. n_exact, if not
// null, is a device counter that the fast mode adds the voxels it evaluated
// exactly to. Returns the cudaError_t.
extern "C" int lt_tsdf_geometry(signed char* v_tab, int H, int X, int Y,
                                int Z, float ox, float oy, float oz,
                                float vox, float fov_up, float fov_down,
                                float fov_down_abs, float fov, int exact,
                                const float* lo, const float* hi,
                                const signed char* val, int n_intervals,
                                unsigned long long* n_exact, void* stream) {
  const long long cols = (long long)X * Y;
  if (cols <= 0 || Z <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const GeomParams p{H,  X,   Y,      Z,        ox,           oy,
                     oz, vox, fov_up, fov_down, fov_down_abs, fov};
  if (exact) {
    const long long blocks =
        (cols + lt::kColumnsPerBlock - 1) / lt::kColumnsPerBlock;
    tsdf_geometry_exact_kernel<<<(unsigned int)blocks, lt::kThreads, 0, s>>>(
        v_tab, p);
    return (int)cudaGetLastError();
  }
  if (!lo || !hi || !val || n_intervals < 1 ||
      n_intervals + kVec + 2 > kMaxIntervals)
    return (int)cudaErrorInvalidValue;
  Intervals e;
  e.n = n_intervals;
  for (int k = 0; k < kMaxIntervals; ++k) {
    const bool real = k < n_intervals;
    e.lo[k] = real ? lo[k] : INFINITY;     // the padding is never safe
    e.hi[k] = real ? hi[k] : INFINITY;
    e.val[k] = real ? val[k] : (signed char)-1;
  }
  const long long total = cols * Z;
  const long long head_max = (kVec - ((uintptr_t)v_tab & (kVec - 1))) &
                             (kVec - 1);
  const long long head = head_max < total ? head_max : total;
  const long long n_vec = (total - head) / kVec;
  const bool aligned = head == 0 && Z % kVec == 0 && n_vec < (1ll << 31) &&
                       cols < (1ll << 31);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // the intervals are copied to shared memory once a block: as many blocks
  // as are resident, each looping over its share
  long long blocks = (n_vec + lt::kThreads - 1) / lt::kThreads;
  const long long resident = (long long)sms * kMinBlocks;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  // the bins of the walk's starting table span the edges between the caps
  const float t_min = n_intervals >= 4 ? hi[1] : 0.0f;
  const float t_max = n_intervals >= 4 ? hi[n_intervals - 3] : 0.0f;
  const float bins_per_t = t_max > t_min ? kBins / (t_max - t_min) : 0.0f;
  // the least distance of two edges in tan space: a column whose voxels
  // lie further apart than that walks several steps a voxel
  // (with fewer than two edges, every column; geometry_edges' band counts
  // on a column that walks one step a voxel lying no further apart)
  float min_gap = INFINITY;
  for (int k = 1; k + 3 < n_intervals; ++k)
    if (hi[k + 1] - hi[k] < min_gap) min_gap = hi[k + 1] - hi[k];
  if (!(min_gap < INFINITY)) min_gap = 0.0f;
  const FastDiv by_vpc = make_fastdiv((unsigned int)(Z / kVec > 0 ? Z / kVec
                                                                  : 1));
  const FastDiv by_y = make_fastdiv((unsigned int)Y);
  if (aligned)
    tsdf_geometry_fast_kernel<true><<<(unsigned int)blocks, lt::kThreads, 0,
                                      s>>>(v_tab, p, e, t_min, bins_per_t,
                                           min_gap, by_vpc, by_y, head, n_vec,
                                           n_exact);
  else
    tsdf_geometry_fast_kernel<false><<<(unsigned int)blocks, lt::kThreads, 0,
                                       s>>>(v_tab, p, e, t_min, bins_per_t,
                                            min_gap, by_vpc, by_y, head, n_vec,
                                            n_exact);
  return (int)cudaGetLastError();
}
