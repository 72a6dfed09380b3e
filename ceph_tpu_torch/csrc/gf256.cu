// GF(2^8) coding-matrix product on Hopper: out[i] = XOR_j mat[i][j] * x[j].
//
// Replaces the Pallas kernel ceph_tpu/ops/gf256_pallas.py:81 (_make_kernel),
// which ceph_tpu/ops/gf256_swar.py:157 (gf_matmul_bytes) reaches for every
// encode and every degraded-read decode.
//
// Arithmetic: bytes stay packed four to a uint32 word (SWAR).  Doubling a
// word multiplies each of its bytes by x in GF(2^8), poly 0x11d:
//   ((v & 0x7f7f7f7f) << 1) ^ (((v >> 7) & 0x01010101) * 0x1d)
// and column j is doubled only up to bit_length(OR of its coefficients),
// as in the Pallas kernel.  A uint32 seed is XOR'd into every loaded word
// (0 on the product path).
//
// Design: the Pallas kernel unrolled the matrix at trace time, one compiled
// program per matrix.  Here the matrix is a runtime operand: the R x k
// coefficients and the per-column doubling depth ride in a __grid_constant__
// kernel-argument struct, so one build serves the encode matrix and every
// per-signature recovery matrix.  Each thread owns one word column: it
// reads the k input words of its column, doubles and XOR-accumulates them
// into R accumulators held in registers (templated on a row bucket 4/8/16/32
// so the accumulator array stays in registers), and only then writes its R
// output words.  Because a thread reads all of its column before it writes,
// the output may alias the input when R == k (donation).
//
// Bound on an H100: the product reads k*n and writes R*n bytes once and does
// ~120 integer ops per input byte at isa k=8 m=4, so at 3.35 TB/s HBM it is
// memory-bound; this first version issues one 4-byte load per thread per row
// and leaves vector loads, cp.async/TMA and occupancy tuning to later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 32;  // isa allows k <= 32; a decode matrix is k x k

struct GfMatrix {
  uint8_t coef[kMaxDim][kMaxDim];  // [row i][column j]; rows >= R are zero
  uint8_t max_bit[kMaxDim];        // doublings column j needs (>= 1)
};

__device__ __forceinline__ uint32_t gf_double(uint32_t v) {
  const uint32_t carry = (v >> 7) & 0x01010101u;  // logical shift: uint32_t
  return ((v & 0x7F7F7F7Fu) << 1) ^ (carry * 0x1Du);
}

template <int RB>
__global__ void __launch_bounds__(256)
gf256_matmul_kernel(const uint8_t* x, int64_t x_row_bytes, uint8_t* out,
                    int64_t out_row_bytes, int64_t words, int k, int R,
                    uint32_t seed, const __grid_constant__ GfMatrix m) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       w < words; w += step) {
    uint32_t acc[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i] = 0u;
    for (int j = 0; j < k; ++j) {
      uint32_t p =
          reinterpret_cast<const uint32_t*>(x + j * x_row_bytes)[w] ^ seed;
      uint32_t c[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) c[i] = m.coef[i][j];
      const int nb = m.max_bit[j];
      for (int b = 0; b < nb; ++b) {
        if (b > 0) p = gf_double(p);
#pragma unroll
        for (int i = 0; i < RB; ++i)
          if ((c[i] >> b) & 1u) acc[i] ^= p;
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i)
      if (i < R) reinterpret_cast<uint32_t*>(out + i * out_row_bytes)[w] = acc[i];
  }
}

template <int RB>
void launch(const uint8_t* x, int64_t xs, uint8_t* out, int64_t os,
            int64_t words, int k, int R, uint32_t seed, const GfMatrix& m,
            cudaStream_t stream) {
  constexpr int kThreads = 256;
  int64_t blocks = (words + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  gf256_matmul_kernel<RB><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(x, xs, out, os, words, k, R, seed, m);
}

}  // namespace

extern "C" {

// x: k rows of `words` uint32 words, row pitch x_row_bytes (4-byte aligned);
// out: R rows, pitch out_row_bytes; coef: host pointer to R*k bytes,
// row-major.  Returns cudaGetLastError() after the launch.
int gf256_matmul_launch(const void* x, int64_t x_row_bytes, void* out,
                        int64_t out_row_bytes, int64_t words, int k, int R,
                        uint32_t seed, const void* coef, void* stream) {
  if (k < 1 || k > kMaxDim || R < 1 || R > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  if (words <= 0) return static_cast<int>(cudaSuccess);
  GfMatrix m = {};
  const uint8_t* c = static_cast<const uint8_t*>(coef);
  for (int j = 0; j < k; ++j) {
    unsigned need = 0;
    for (int i = 0; i < R; ++i) {
      m.coef[i][j] = c[i * k + j];
      need |= c[i * k + j];
    }
    int bits = 0;
    while (need) {
      ++bits;
      need >>= 1;
    }
    m.max_bit[j] = static_cast<uint8_t>(bits > 0 ? bits : 1);
  }
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  uint8_t* ob = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 4)
    launch<4>(xb, x_row_bytes, ob, out_row_bytes, words, k, R, seed, m, s);
  else if (R <= 8)
    launch<8>(xb, x_row_bytes, ob, out_row_bytes, words, k, R, seed, m, s);
  else if (R <= 16)
    launch<16>(xb, x_row_bytes, ob, out_row_bytes, words, k, R, seed, m, s);
  else
    launch<32>(xb, x_row_bytes, ob, out_row_bytes, words, k, R, seed, m, s);
  return static_cast<int>(cudaGetLastError());
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
