// GF(2^8) coding-matrix product on Hopper: out[i] = XOR_j mat[i][j] * x[j].
//
// Two kernels:
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
// the same bytes, so the flag is a tuning knob only.  A uint32 seed is
// XOR'd into every loaded word (0 on the product path; the engine bench
// passes the iteration index).  The matrix is a runtime operand in both
// kernels: one build serves the encode matrix and every per-signature
// recovery matrix.
//
// K1 (redesigned for the H100).  Its yardstick is the bytes, k*n read
// and R*n written once, at 3.35 TB/s (chip_smoke.py's bound_ms); what
// bounds it in fact is the network's instruction issue (the SASS counts
// below).  Design:
//
// - Horner over the coefficient bits, one output row at a time:
//     t = 0; for s in 0..7: t = double(t) (s > 0);
//                           t ^= XOR_j (x[j] & mask[i][s][j])
//   where mask[i][s][j] is ~0 when bit 7-s of mat[i][j] is set, else 0.
//   The wrapper expands the matrix into these masks once per matrix
//   (ops/gf256.py k1_operand, cached by the matrix's bytes) and they ride
//   in a __grid_constant__ parameter sized to the (row, column) bucket,
//   every index a compile-time constant after unrolling: each (i, s, j)
//   is one LOP3, t ^ (x & mask), with no test and no branch (the masks
//   reach it through uniform registers, one ULDC.64 per two masks, on the
//   uniform datapath), and each output row costs 7 doublings (R*7 per
//   word column, not k*7: fewer for every encode, where R = m < k).  A
//   runtime matrix cannot skip its zero bits: R*k*8 LOP3 and R*7
//   doublings per word column, whatever the coefficients.
// - Every load in flight: a thread owns one word column and loads it
//   from all k rows before any of the network runs.  One word per thread
//   (32 registers) beat 8- and 16-byte vector loads of 2 and 4 words,
//   which took 40-64 registers, kept fewer warps in flight and ran 7-25 %
//   slower at the main shapes (PERF.md).  Rows are unrolled up to the
//   8-row bucket and looped above it, so the largest instantiations stay
//   a few hundred instructions.
// - Alignment: a word is 4-byte aligned, which the wrapper guarantees
//   (it runs other widths and row slices on a word-padded copy); any
//   4-byte-aligned base and pitch, a row slice of a batch included,
//   takes the same body.
// - Donation: a thread loads all of its words of all k rows before it
//   stores any, and writes only the columns it read, so out may be x
//   when R == k.  No pointer is __restrict__ and no load takes the
//   read-only path, which is undefined for memory the kernel writes.
// - Parameter space: the masks are 32*RB*KB bytes; CUDA 12.1+ takes up to
//   32,764 bytes of parameters on sm_70 and up, so every bucket but
//   32 x 32 fits.  A matrix with more than 16 rows and more than 16
//   columns runs as row blocks of 16, one launch each (the wrapper
//   splits, counts each launch, and stages a donated output through a
//   scratch buffer, since the second block reads rows the first wrote).
//
// SASS of the main buckets (chip_smoke.py reads it from the built
// library with cuobjdump: sm_90a; 32 registers, no stack or local
// memory): the 4 x 8 encode is 665 instructions per word column, 393 of
// them on the INT32 pipe (320 LOP3: 256 accumulations, the rest
// doublings and the seed); the 8 x 8 decode 1217, 743 on the INT32 pipe
// (632 LOP3).  At the main batch (262,144 word columns) and the H100's
// 1980 MHz the issue floor, instructions x words / (132 SMs x 64 INT32
// lanes x clock), is 0.0104 ms (encode) and 0.0191 ms (decode) counting
// every instruction, 0.0062 and 0.0116 ms counting the INT32 pipe's
// alone; the kernel ran 0.0093-0.0097 and 0.0151-0.0158 ms from a CUDA
// graph (NVIDIA H100 80GB HBM3, 700 W), about the first floor since
// IMAD and the uniform loads issue to other pipes.  The network, not
// the bytes (0.0038 and 0.0050 ms), is what bounds it on this card.
//
// K2 keeps its first column network (gf_column below): each thread owns one
// word column of one T-row, doubles each input column up to
// bit_length(OR of its coefficients) and XORs it into R accumulators.  A
// block covers `tile` consecutive T-rows (the Pallas grid step);
// threadIdx.x is the lane (128), threadIdx.y walks the tile's rows, so
// each warp load and store is one coalesced 128-byte line.

#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 32;  // isa allows k <= 32; a decode matrix is k x k
constexpr int kLanes = 128;  // words per row of the planes layouts

template <bool kShift>
__device__ __forceinline__ uint32_t gf_double(uint32_t v) {
  const uint32_t carry = (v >> 7) & 0x01010101u;  // logical shift: uint32_t
  const uint32_t red =
      kShift ? carry ^ (carry << 2) ^ (carry << 3) ^ (carry << 4)
             : carry * 0x1Du;
  return ((v & 0x7F7F7F7Fu) << 1) ^ red;
}

// ---- K1 -------------------------------------------------------------------

constexpr int kK1Threads = 256;
constexpr int kK1RowBlock = 16;  // rows per launch when R > 16 and k > 16

__host__ __device__ constexpr int k1_bucket(int n) {
  return n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;
}

template <int RB, int KB>
struct K1Operand {
  uint32_t mask[RB][8][KB];  // [row i][step s][column j]: ~0 or 0
};

// One output row's Horner network over the thread's input words: each
// (step, column) one AND-XOR with a mask from the parameter bank.
template <int KB, bool kShift>
__device__ __forceinline__ uint32_t
row_network(const uint32_t (&in)[KB], const uint32_t (&mask)[8][KB]) {
  uint32_t t = 0u;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (s > 0) t = gf_double<kShift>(t);
#pragma unroll
    for (int j = 0; j < KB; ++j) t ^= in[j] & mask[s][j];
  }
  return t;
}

template <int RB, int KB, bool kShift>
__global__ void __launch_bounds__(kK1Threads)
gf256_matmul_kernel(const uint8_t* x, int64_t x_row_bytes, uint8_t* out,
                    int64_t out_row_bytes, int64_t words, int k, int R,
                    uint32_t seed,
                    const __grid_constant__ K1Operand<RB, KB> op) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       w < words; w += step) {
    uint32_t in[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j)
      in[j] = (j < k ? reinterpret_cast<const uint32_t*>(
                           x + j * x_row_bytes)[w]
                     : 0u) ^ seed;
    auto emit = [&](int i) {
      reinterpret_cast<uint32_t*>(out + i * out_row_bytes)[w] =
          row_network<KB, kShift>(in, op.mask[i]);
    };
    if constexpr (RB <= 8) {
#pragma unroll
      for (int i = 0; i < RB; ++i)
        if (i < R) emit(i);
    } else {
      // past 8 rows the rows loop (the code stays small); a runtime
      // row's masks come through indexed constant loads
#pragma unroll 1
      for (int i = 0; i < R; ++i) emit(i);
    }
  }
}

template <int RB, int KB, bool kShift>
int launch_k1(const uint8_t* x, int64_t xs, uint8_t* out, int64_t os,
              int64_t words, int k, int R, uint32_t seed, const void* masks,
              int64_t masks_bytes, cudaStream_t stream) {
  if constexpr (RB * KB > kK1RowBlock * kMaxDim) {
    return static_cast<int>(cudaErrorInvalidValue);  // 32 x 32: split rows
  } else {
    if (masks_bytes != static_cast<int64_t>(sizeof(K1Operand<RB, KB>)))
      return static_cast<int>(cudaErrorInvalidValue);
    K1Operand<RB, KB> op;
    std::memcpy(&op, masks, sizeof(op));
    int64_t blocks = (words + kK1Threads - 1) / kK1Threads;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
    gf256_matmul_kernel<RB, KB, kShift>
        <<<static_cast<unsigned>(blocks), kK1Threads, 0, stream>>>(
            x, xs, out, os, words, k, R, seed, op);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int RB, bool kShift>
int launch_k1_rows(const uint8_t* x, int64_t xs, uint8_t* out, int64_t os,
                   int64_t words, int k, int R, uint32_t seed,
                   const void* masks, int64_t masks_bytes,
                   cudaStream_t stream) {
  switch (k1_bucket(k)) {
    case 4:
      return launch_k1<RB, 4, kShift>(x, xs, out, os, words, k, R, seed,
                                      masks, masks_bytes, stream);
    case 8:
      return launch_k1<RB, 8, kShift>(x, xs, out, os, words, k, R, seed,
                                      masks, masks_bytes, stream);
    case 16:
      return launch_k1<RB, 16, kShift>(x, xs, out, os, words, k, R, seed,
                                       masks, masks_bytes, stream);
    default:
      return launch_k1<RB, 32, kShift>(x, xs, out, os, words, k, R, seed,
                                       masks, masks_bytes, stream);
  }
}

// ---- K2 -------------------------------------------------------------------

struct GfMatrix {
  uint8_t coef[kMaxDim][kMaxDim];  // [row i][column j]; rows >= R are zero
  uint8_t max_bit[kMaxDim];        // doublings column j needs (>= 1)
};

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

// K2's operand from a host R x k row-major matrix.
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
#define GF256_DISPATCH(RET, F, R, SHIFT, ...)                   \
  do {                                                          \
    if (SHIFT) {                                                \
      if ((R) <= 4) RET F<4, true>(__VA_ARGS__);                \
      else if ((R) <= 8) RET F<8, true>(__VA_ARGS__);           \
      else if ((R) <= 16) RET F<16, true>(__VA_ARGS__);         \
      else RET F<32, true>(__VA_ARGS__);                        \
    } else {                                                    \
      if ((R) <= 4) RET F<4, false>(__VA_ARGS__);               \
      else if ((R) <= 8) RET F<8, false>(__VA_ARGS__);          \
      else if ((R) <= 16) RET F<16, false>(__VA_ARGS__);        \
      else RET F<32, false>(__VA_ARGS__);                       \
    }                                                           \
  } while (0)

}  // namespace

extern "C" {

// K1.  x: k rows of `words` uint32 words, row pitch x_row_bytes (4-byte
// aligned); out: R rows, pitch out_row_bytes, may be x itself when R == k;
// masks: host pointer to the expanded operand of these R rows, u32
// [bucket(R)][8][bucket(k)] (ops/gf256.py k1_operand), masks_bytes its
// size; R > 16 with k > 16 is refused (the wrapper splits such a matrix
// into row blocks).  mul_shift selects the shift-XOR doubling.  Returns
// cudaGetLastError() after the launch.
int gf256_matmul_launch(const void* x, int64_t x_row_bytes, void* out,
                        int64_t out_row_bytes, int64_t words, int k, int R,
                        uint32_t seed, const void* masks, int64_t masks_bytes,
                        int mul_shift, void* stream) {
  if (k < 1 || k > kMaxDim || R < 1 || R > kMaxDim ||
      (R > kK1RowBlock && k > kK1RowBlock) || x_row_bytes % 4 != 0 ||
      out_row_bytes % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (words <= 0) return static_cast<int>(cudaSuccess);
  GF256_DISPATCH(return, launch_k1_rows, R, mul_shift,
                 static_cast<const uint8_t*>(x), x_row_bytes,
                 static_cast<uint8_t*>(out), out_row_bytes, words, k, R,
                 seed, masks, masks_bytes,
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaErrorInvalidValue);  // not reached
}

// K2.  x: u32 [T, k, 128] contiguous; out: u32 [T, R, 128] contiguous,
// not overlapping x; T % tile == 0; coef: host pointer to R*k bytes,
// row-major.  Returns cudaGetLastError() after the launch.
int gf256_interleaved_launch(const void* x, void* out, int64_t T, int k,
                             int R, uint32_t seed, const void* coef,
                             int tile, int mul_shift, void* stream) {
  if (k < 1 || k > kMaxDim || R < 1 || R > kMaxDim || tile < 1 || T < 0 ||
      T % tile != 0 || T / tile > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const GfMatrix m = make_matrix(static_cast<const uint8_t*>(coef), k, R);
  GF256_DISPATCH(, launch_interleaved, R, mul_shift,
                 static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
                 T / tile, k, R, tile, seed, m,
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
