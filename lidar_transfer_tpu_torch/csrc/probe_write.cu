// Probe kernel: output-write bandwidth. Output i (of 1 to 3) gets the
// constant i + 1 in its own dtype everywhere.
//
// Replaces: scripts/probe_pallas_write.py::probe (the pl.pallas_call at :49;
// body make_write_kernel :24) and probe2d (:123), and
// scripts/probe_alias.py::probe (:56; body kernel :24). The script's grid
// step writes a (BX, BY, Z) block of an (X, Y, Z) array, which is BX
// contiguous runs of BY * Z elements, Y * Z apart; or, for probe2d, BR flat
// rows of Z (one run of BR * Z). The host passes a block as rows_per_block
// runs of span elements at row_stride, and the script's grid as (grid_x,
// grid_y), the y block being one more span along the run. With read_first
// each thread loads the 16 bytes it then overwrites, which stands in for
// probe_alias's VMEM-blocked (read) inputs. The aliasing modes of
// probe_alias are arrangements of the caller's tensors on the host
// (probes/write.py).
//
// Bound on the card: the bytes written (and read, with read_first);
// nothing else. Dtype codes: 0 bf16, 1 float32, 2 int32, 3 int8, 4 int16.
//
// Design. The CTA is not the script's grid step: one CTA a block gave 128
// CTAs of 8 warps at BX8 BY1024 (4 of 132 SMs idle, too few stores in
// flight on the rest) and 3.88 CTAs an SM for the alias rows. Every run is
// cut into tiles of kTileWords 16-byte words (16 KB); the tiles of all
// outputs, output by output and run by run, are one list, and CTA t writes
// tile t: each thread kUnroll 16-byte words, neighbouring threads on
// neighbouring words; read_first is a template argument. The CTAs start in
// order, so the card writes one compact window that moves through the
// outputs, as PyTorch's fill does. A tile's run and block come from three
// divisions by a multiply and a shift (constants from the host), so that a
// CTA's stores start early; the parameters are never indexed at run time,
// which would copy them to every thread's stack. (A persistent grid sized
// from the SM count, 2 to 16 CTAs an SM walking the tiles in turn or in
// ranges, and one CTA per 4 KB tile, were slower than the fill in every
// form measured, and so were TMA bulk stores of a constant tile in shared
// memory.) probes/write.py::write_plan
// computes the same partition on the host and builds the launch from it;
// the CPU tests walk it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTileWords = kThreads * kUnroll;  // 16-byte words (16 KB)

// n / d for n < 2^31 as (umulhi(n, m) + n) >> s, m and s from the host
struct Div {
  unsigned int d, m, s;
};

Div make_div(unsigned int d) {
  unsigned int s = 0;
  while (s < 32 && (1u << s) < d) ++s;
  const unsigned long long one = 1;
  return {d, (unsigned int)(((one << 32) * ((one << s) - d)) / d + 1), s};
}

__device__ __forceinline__ unsigned int divide(unsigned int n, const Div& v) {
  return (__umulhi(n, v.m) + n) >> v.s;
}

struct WriteParams {
  long long row_stride, span;  // elements
  int code[3];
  long long n16[3];            // 16-byte words of a run of output i
  unsigned int tiles_end[3];   // tiles of outputs 0..i
  Div per[3];                  // tiles a run of output i
  Div rows, grid_y;            // runs a block; blocks along y
  unsigned int zero;           // 0, which the compiler cannot know
};

__host__ __device__ __forceinline__ int elem_size(int code) {
  return code == 3 ? 1 : (code == 0 || code == 4) ? 2 : 4;
}

// The constant value (i + 1) of dtype `code` repeated over 32 bits.
__device__ __forceinline__ unsigned int fill_word(int code, int value) {
  switch (code) {
    case 0: {
      const unsigned int h =
          __bfloat16_as_ushort(__float2bfloat16_rn((float)value));
      return h | (h << 16);
    }
    case 1:
      return __float_as_uint((float)value);
    case 3: {
      const unsigned int h = (unsigned int)(unsigned char)value;
      return h | (h << 8) | (h << 16) | (h << 24);
    }
    case 4: {
      const unsigned int h = (unsigned int)(unsigned short)value;
      return h | (h << 16);
    }
    default:
      return (unsigned int)value;
  }
}

// read_first: the words read are folded into a sink that the stores
// depend on, masked by p.zero (0). A load whose value only an empty asm statement
// took was dropped by ptxas (it emits no instruction that reads the
// registers), and a volatile load is a system-scope one, several times
// slower.
__device__ __forceinline__ unsigned int fold(const uint4 v) {
  return v.x ^ v.y ^ v.z ^ v.w;
}
// a[i] for i in 0..2 by selects (see the design note on the stack)
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[3], int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}

// Tile t of the list -> output i, the run's first element, and the tile's
// 16-byte words [w0, w1) in the run.
struct Tile {
  int i;
  long long first, w0, w1;
};
__device__ __forceinline__ Tile tile_of(const WriteParams& p,
                                        unsigned int t) {
  Tile a;
  a.i = t < p.tiles_end[0] ? 0 : (t < p.tiles_end[1] ? 1 : 2);
  const unsigned int tl =
      t - (a.i == 0 ? 0u : (a.i == 1 ? p.tiles_end[0] : p.tiles_end[1]));
  const Div per = pick(p.per, a.i);
  const unsigned int q = divide(tl, per);  // run q of output i
  const unsigned int k = tl - q * per.d;   // tile k of the run
  // run q -> row r of block b = (bx, by) of the script's grid
  const unsigned int b = divide(q, p.rows);
  const unsigned int r = q - b * p.rows.d;
  const unsigned int bx = divide(b, p.grid_y);
  a.first = ((long long)bx * p.rows.d + r) * p.row_stride +
            (long long)(b - bx * p.grid_y.d) * p.span;
  a.w0 = (long long)k * kTileWords;
  a.w1 = min(a.w0 + kTileWords, pick(p.n16, a.i));
  return a;
}

__device__ __forceinline__ uint4* run_of(char* out0, char* out1, char* out2,
                                         const WriteParams& p, const Tile& a) {
  char* const out = a.i == 0 ? out0 : (a.i == 1 ? out1 : out2);
  return reinterpret_cast<uint4*>(out +
                                  a.first * elem_size(pick(p.code, a.i)));
}

// read_first: a thread issues its kUnroll loads, then its stores, whose
// value carries the words read (folded, masked by p.zero), so that no store
// leaves before every load of the thread has returned: 1.08 ms for
// alias_vmem at 1024x1024x256 on an H100 (700 W), as PyTorch's in-place
// add_ of the same tensors (1.07). With the stores free to leave, loads
// and stores of one address in flight together took 3.14, and a load, its
// wait and a store word by word 1.75 (PERF.md).
template <bool kRead>
__global__ void __launch_bounds__(kThreads)
    probe_write_kernel(char* out0, char* out1, char* out2,
                       const WriteParams p) {
  const Tile a = tile_of(p, blockIdx.x);
  uint4* const run = run_of(out0, out1, out2, p, a);
  const long long w0 = a.w0 + threadIdx.x;
  unsigned int f = fill_word(pick(p.code, a.i), a.i + 1);
  if (kRead) {
    uint4 old[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (w0 + u * kThreads < a.w1) old[u] = run[w0 + u * kThreads];
    unsigned int sink = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (w0 + u * kThreads < a.w1) sink ^= fold(old[u]);
    f ^= sink & p.zero;
  }
  const uint4 val = make_uint4(f, f, f, f);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (w0 + u * kThreads < a.w1) run[w0 + u * kThreads] = val;
}

}  // namespace

// Fills n_out (1..3) outputs, of dtype codes code0..code2, with 1, 2, 3.
// The script's grid is (grid_x, grid_y) blocks; block (bx, by) is
// rows_per_block runs of span elements, run r starting at element
// (bx * rows_per_block + r) * row_stride + by * span. span * element size
// is a multiple of 16 bytes and every output 16-byte aligned (the wrapper
// checks both). tiles0..2 are each output's tiles a run and grid the CTAs,
// one a tile, from the host's partition (probes/write.py::write_plan); the
// entry refuses a partition that does not cut every run into kTileWords
// words, or of 2^31 tiles or more. Returns the cudaError_t.
extern "C" int lt_probe_write(void* out0, void* out1, void* out2, int code0,
                              int code1, int code2, int n_out,
                              long long grid_x, long long grid_y,
                              long long rows_per_block, long long row_stride,
                              long long span, int tiles0, int tiles1,
                              int tiles2, long long grid, int read_first,
                              void* stream) {
  if (grid_x <= 0 || grid_y <= 0 || span <= 0) return (int)cudaSuccess;
  const long long runs = grid_x * grid_y * rows_per_block;
  const int codes[3] = {code0, code1, code2};
  const int per[3] = {tiles0, tiles1, tiles2};
  WriteParams p{};
  p.zero = 0;
  p.row_stride = row_stride;
  p.span = span;
  long long tiles = 0;
  for (int i = 0; i < 3; ++i) {
    p.code[i] = codes[i];
    if (i < n_out) {
      p.n16[i] = span * elem_size(codes[i]) / 16;
      if (per[i] != (p.n16[i] + kTileWords - 1) / kTileWords)
        return (int)cudaErrorInvalidValue;
      tiles += runs * per[i];
    }
    if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    p.per[i] = make_div(i < n_out ? (unsigned int)per[i] : 1u);
    p.tiles_end[i] = (unsigned int)tiles;
  }
  if (grid != tiles) return (int)cudaErrorInvalidValue;
  p.rows = make_div((unsigned int)rows_per_block);
  p.grid_y = make_div((unsigned int)grid_y);
  const cudaStream_t st = (cudaStream_t)stream;
  if (read_first) {
    probe_write_kernel<true><<<(unsigned int)grid, kThreads, 0, st>>>(
        (char*)out0, (char*)out1, (char*)out2, p);
  } else {
    probe_write_kernel<false><<<(unsigned int)grid, kThreads, 0, st>>>(
        (char*)out0, (char*)out1, (char*)out2, p);
  }
  return (int)cudaGetLastError();
}
