// GF(2^8) coding-matrix product on Hopper: out[i] = XOR_j mat[i][j] * x[j].
//
// Two kernels, one network:
//
// - gf256_matmul_kernel (K1) replaces the Pallas kernel
//   ceph_tpu/ops/gf256_pallas.py:81 (_make_kernel), which
//   ceph_tpu/ops/gf256_swar.py:157 (gf_matmul_bytes) reaches for every
//   encode and every degraded-read decode.  Planar layout: k input rows
//   of `words` uint32 words at a row pitch, R output rows likewise.
// - gf256_interleaved_kernel (K2) replaces the Pallas kernel
//   ceph_tpu/ops/gf256_pallas.py:192 (_make_kernel_interleaved), the
//   engine bench's interleaved layout: input u32 [T, k, 128] (row t holds
//   its k lanes of 128 words contiguously, k*512 bytes), output u32
//   [T, R, 128].
//
// Arithmetic: bytes stay packed four to a uint32 word (SWAR).  Doubling a
// word multiplies each of its bytes by x in GF(2^8), poly 0x11d:
//   ((v & 0x7f7f7f7f) << 1) ^ (((v >> 7) & 0x01010101) * 0x1d)
// or, with mul_shift, the multiply by 0x1d as the shift-XOR chain
// carry ^ carry<<2 ^ carry<<3 ^ carry<<4 (gf256_pallas.py:74-77); both give
// the same bytes, so the flag is a tuning knob only.  Column j is doubled
// only up to bit_length(OR of its coefficients), as in the Pallas kernels.
// A uint32 seed is XOR'd into every loaded word (0 on the product path;
// the engine bench passes the iteration index).
//
// Design: the Pallas kernels unrolled the matrix at trace time, one
// compiled program per matrix.  Here the matrix is a runtime operand: the
// R x k coefficients and the per-column doubling depth ride in a
// __grid_constant__ kernel-argument struct, so one build serves the encode
// matrix and every per-signature recovery matrix.  Each thread owns one
// word column: it reads the k input words of its column, doubles and
// XOR-accumulates them into R accumulators held in registers (templated on
// a row bucket 4/8/16/32 so the accumulator array stays in registers), and
// only then writes its R output words.  Because a K1 thread reads all of
// its column before it writes, K1's output may alias its input when R == k
// (donation); K2 has no donation, as the Pallas K2 has none.
//
// K2's mapping: a block covers `tile` consecutive T-rows (the Pallas grid
// step); threadIdx.x is the lane (128), threadIdx.y walks the tile's rows.
// A warp thus covers 32 lanes of one row j, so each load and each store is
// one coalesced 128-byte line.  The bytes do not depend on `tile`.
//
// Bound on an H100: the product reads k*n and writes R*n bytes once and
// does ~15 integer ops per input byte at isa k=8 m=4 (about 490 per word
// column of 8 input words), so its bound at 3.35 TB/s HBM is the bytes.
// These first versions issue one 4-byte load per thread per row and leave
// vector loads, cp.async/TMA and occupancy tuning to later work.  Measured
// on an H100 SXM at 700 W, both are limited by instruction issue well
// before the bytes: the shift-XOR doubling costs them 15-19 %.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 32;  // isa allows k <= 32; a decode matrix is k x k
constexpr int kLanes = 128;  // words per row of the planes layouts

struct GfMatrix {
  uint8_t coef[kMaxDim][kMaxDim];  // [row i][column j]; rows >= R are zero
  uint8_t max_bit[kMaxDim];        // doublings column j needs (>= 1)
};

template <bool kShift>
__device__ __forceinline__ uint32_t gf_double(uint32_t v) {
  const uint32_t carry = (v >> 7) & 0x01010101u;  // logical shift: uint32_t
  const uint32_t red =
      kShift ? carry ^ (carry << 2) ^ (carry << 3) ^ (carry << 4)
             : carry * 0x1Du;
  return ((v & 0x7F7F7F7Fu) << 1) ^ red;
}

// XOR mat[i][j] * p into acc[i] for every row i: the doubling network of
// one input column.
template <int RB, bool kShift>
__device__ __forceinline__ void gf_column(uint32_t p, int j,
                                          const GfMatrix& m,
                                          uint32_t (&acc)[RB]) {
  uint32_t c[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) c[i] = m.coef[i][j];
  const int nb = m.max_bit[j];
  for (int b = 0; b < nb; ++b) {
    if (b > 0) p = gf_double<kShift>(p);
#pragma unroll
    for (int i = 0; i < RB; ++i)
      if ((c[i] >> b) & 1u) acc[i] ^= p;
  }
}

template <int RB, bool kShift>
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
    for (int j = 0; j < k; ++j)
      gf_column<RB, kShift>(
          reinterpret_cast<const uint32_t*>(x + j * x_row_bytes)[w] ^ seed,
          j, m, acc);
#pragma unroll
    for (int i = 0; i < RB; ++i)
      if (i < R) reinterpret_cast<uint32_t*>(out + i * out_row_bytes)[w] = acc[i];
  }
}

// Rows per block step: 8 (1024 threads) for the small row buckets, 2 (256
// threads) for RB = 32, whose accumulators and coefficients need more
// registers than 1024 threads of a block can have.
__host__ __device__ constexpr int max_rows_per_step(int rb) {
  return rb <= 16 ? 8 : 2;
}

template <int RB, bool kShift>
__global__ void __launch_bounds__(kLanes * max_rows_per_step(RB))
gf256_interleaved_kernel(const uint32_t* __restrict__ x,
                         uint32_t* __restrict__ out, int k, int R, int tile,
                         uint32_t seed, const __grid_constant__ GfMatrix m) {
  const int lane = threadIdx.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile;
  for (int r = threadIdx.y; r < tile; r += blockDim.y) {
    const int64_t t = t0 + r;
    const uint32_t* xr = x + t * k * kLanes + lane;
    uint32_t acc[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i] = 0u;
    for (int j = 0; j < k; ++j)
      gf_column<RB, kShift>(xr[j * kLanes] ^ seed, j, m, acc);
    uint32_t* orow = out + t * R * kLanes + lane;
#pragma unroll
    for (int i = 0; i < RB; ++i)
      if (i < R) orow[i * kLanes] = acc[i];
  }
}

template <int RB, bool kShift>
void launch_planar(const uint8_t* x, int64_t xs, uint8_t* out, int64_t os,
                   int64_t words, int k, int R, uint32_t seed,
                   const GfMatrix& m, cudaStream_t stream) {
  constexpr int kThreads = 256;
  int64_t blocks = (words + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  gf256_matmul_kernel<RB, kShift>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          x, xs, out, os, words, k, R, seed, m);
}

template <int RB, bool kShift>
void launch_interleaved(const uint32_t* x, uint32_t* out, int64_t blocks,
                        int k, int R, int tile, uint32_t seed,
                        const GfMatrix& m, cudaStream_t stream) {
  int rows = 1;  // the largest power of two <= the cap that divides tile
  while (rows * 2 <= max_rows_per_step(RB) && tile % (rows * 2) == 0)
    rows *= 2;
  gf256_interleaved_kernel<RB, kShift>
      <<<static_cast<unsigned>(blocks), dim3(kLanes, rows), 0, stream>>>(
          x, out, k, R, tile, seed, m);
}

// The operand of both kernels from a host R x k row-major matrix.
GfMatrix make_matrix(const uint8_t* c, int k, int R) {
  GfMatrix m = {};
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
  return m;
}

// Instantiate F<RB, kShift> for R's row bucket and the doubling variant.
#define GF256_DISPATCH(F, R, SHIFT, ...)                        \
  do {                                                          \
    if (SHIFT) {                                                \
      if ((R) <= 4) F<4, true>(__VA_ARGS__);                    \
      else if ((R) <= 8) F<8, true>(__VA_ARGS__);               \
      else if ((R) <= 16) F<16, true>(__VA_ARGS__);             \
      else F<32, true>(__VA_ARGS__);                            \
    } else {                                                    \
      if ((R) <= 4) F<4, false>(__VA_ARGS__);                   \
      else if ((R) <= 8) F<8, false>(__VA_ARGS__);              \
      else if ((R) <= 16) F<16, false>(__VA_ARGS__);            \
      else F<32, false>(__VA_ARGS__);                           \
    }                                                           \
  } while (0)

}  // namespace

extern "C" {

// K1.  x: k rows of `words` uint32 words, row pitch x_row_bytes (4-byte
// aligned); out: R rows, pitch out_row_bytes; coef: host pointer to R*k
// bytes, row-major; mul_shift selects the shift-XOR doubling.  Returns
// cudaGetLastError() after the launch.
int gf256_matmul_launch(const void* x, int64_t x_row_bytes, void* out,
                        int64_t out_row_bytes, int64_t words, int k, int R,
                        uint32_t seed, const void* coef, int mul_shift,
                        void* stream) {
  if (k < 1 || k > kMaxDim || R < 1 || R > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  if (words <= 0) return static_cast<int>(cudaSuccess);
  const GfMatrix m = make_matrix(static_cast<const uint8_t*>(coef), k, R);
  GF256_DISPATCH(launch_planar, R, mul_shift,
                 static_cast<const uint8_t*>(x), x_row_bytes,
                 static_cast<uint8_t*>(out), out_row_bytes, words, k, R,
                 seed, m, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K2.  x: u32 [T, k, 128] contiguous; out: u32 [T, R, 128] contiguous,
// not overlapping x; T % tile == 0; coef as for K1.  Returns
// cudaGetLastError() after the launch.
int gf256_interleaved_launch(const void* x, void* out, int64_t T, int k,
                             int R, uint32_t seed, const void* coef,
                             int tile, int mul_shift, void* stream) {
  if (k < 1 || k > kMaxDim || R < 1 || R > kMaxDim || tile < 1 || T < 0 ||
      T % tile != 0 || T / tile > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const GfMatrix m = make_matrix(static_cast<const uint8_t*>(coef), k, R);
  GF256_DISPATCH(launch_interleaved, R, mul_shift,
                 static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
                 T / tile, k, R, tile, seed, m,
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
