// Probe kernel: output-write bandwidth. Output i (of 1 to 3) gets the
// constant i + 1 in its own dtype everywhere.
//
// Replaces: scripts/probe_pallas_write.py::probe (the pl.pallas_call at :49;
// body make_write_kernel :24) and probe2d (:123), and
// scripts/probe_alias.py::probe (:56; body kernel :24). A CTA writes what one
// of the script's grid steps writes: a (BX, BY, Z) block of an (X, Y, Z)
// array, which is BX contiguous runs of BY * Z elements, Y * Z apart; or, for
// probe2d, BR flat rows of Z (one run of BR * Z). The host passes the block
// as rows_per_block runs of span elements at row_stride, the grid as
// (grid_x, grid_y), the y block being one more span along the run. With
// read_first each thread loads the 16 bytes it then overwrites, which stands
// in for probe_alias's VMEM-blocked (read) inputs. The aliasing modes of
// probe_alias are arrangements of the caller's tensors on the host
// (probes/write.py).
//
// Design: 16-byte vector stores (uint4), neighbouring threads on
// neighbouring addresses; 256 threads walk each run. Dtype codes: 0 bf16,
// 1 float32, 2 int32, 3 int8, 4 int16. Bound on the card: the bytes written
// (and read, with read_first); nothing else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWriteThreads = 256;

struct WriteParams {
  long long rows_per_block, row_stride, span;
  int n_out, read_first;
  int code[3];
};

__device__ __forceinline__ int elem_size(int code) {
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

__global__ void __launch_bounds__(kWriteThreads)
    probe_write_kernel(char* out0, char* out1, char* out2,
                       const WriteParams p) {
  for (int i = 0; i < p.n_out; ++i) {
    char* out = i == 0 ? out0 : (i == 1 ? out1 : out2);
    const int code = p.code[i];
    const long long esize = elem_size(code);
    const unsigned int w = fill_word(code, i + 1);
    const uint4 v = make_uint4(w, w, w, w);
    const long long n16 = p.span * esize / 16;
    for (long long r = 0; r < p.rows_per_block; ++r) {
      const long long first =
          ((long long)blockIdx.x * p.rows_per_block + r) * p.row_stride +
          (long long)blockIdx.y * p.span;
      uint4* run = reinterpret_cast<uint4*>(out + first * esize);
      for (long long k = threadIdx.x; k < n16; k += kWriteThreads) {
        if (p.read_first) {
          const uint4 old = run[k];
          asm volatile("" ::"r"(old.x), "r"(old.y), "r"(old.z), "r"(old.w));
        }
        run[k] = v;
      }
    }
  }
}

}  // namespace

// Fills n_out (1..3) outputs, of dtype codes code0..code2, with 1, 2, 3.
// The grid is (grid_x, grid_y) CTAs; CTA (bx, by) writes rows_per_block runs
// of span elements, run r starting at element
// (bx * rows_per_block + r) * row_stride + by * span. span * element size
// is a multiple of 16 bytes and every output 16-byte aligned (the wrapper
// checks both). Returns the cudaError_t.
extern "C" int lt_probe_write(void* out0, void* out1, void* out2, int code0,
                              int code1, int code2, int n_out,
                              long long grid_x, long long grid_y,
                              long long rows_per_block, long long row_stride,
                              long long span, int read_first, void* stream) {
  if (grid_x <= 0 || grid_y <= 0 || span <= 0) return (int)cudaSuccess;
  const WriteParams p{rows_per_block, row_stride, span, n_out, read_first,
                      {code0, code1, code2}};
  const dim3 grid((unsigned int)grid_x, (unsigned int)grid_y);
  probe_write_kernel<<<grid, kWriteThreads, 0, (cudaStream_t)stream>>>(
      (char*)out0, (char*)out1, (char*)out2, p);
  return (int)cudaGetLastError();
}
