// GF(2^8) coding-matrix product on Hopper: out[i] = XOR_j mat[i][j] * x[j].
//
// One kernel, gf256_matmul_kernel, over two layouts of the same product:
//
// - planar (K1) replaces the Pallas kernel ceph_tpu/ops/gf256_pallas.py:81
//   (_make_kernel), which ceph_tpu/ops/gf256_swar.py:157
//   (gf_matmul_bytes) reaches for every encode and every degraded-read
//   decode: k input rows of `words` uint32 words at a row pitch, R output
//   rows likewise;
// - interleaved (K2) replaces the Pallas kernel
//   ceph_tpu/ops/gf256_pallas.py:192 (_make_kernel_interleaved), the
//   engine bench's layout: input u32 [T, k, 128] (T-row t holds its k
//   rows of 128 words contiguously, k*512 bytes), output u32 [T, R, 128].
//   It is the planar body with another address: word w of the flat
//   [0, T*128) range is lane w % 128 of T-row w / 128, input row j of
//   that T-row starts at word (t*k + j)*128 and output row i at
//   (t*R + i)*128.  A warp's 32 consecutive words lie in one T-row, so
//   each row load and store is one coalesced 128-byte line.  The Pallas
//   grid step (`tile` T-rows, a TPU VMEM block) means nothing here: the
//   grid covers the T*128 words whatever the tile, which the wrapper
//   still checks divides T, as the JAX entry does.
//
// Arithmetic: bytes stay packed four to a uint32 word (SWAR).  Doubling a
// word multiplies each of its bytes by x in GF(2^8), poly 0x11d:
//   ((v & 0x7f7f7f7f) << 1) ^ (((v >> 7) & 0x01010101) * 0x1d)
// or, with mul_shift, the multiply by 0x1d as the shift-XOR chain
// carry ^ carry<<2 ^ carry<<3 ^ carry<<4 (gf256_pallas.py:74-77); both give
// the same bytes, so the flag is a tuning knob only.  A uint32 seed is
// XOR'd into every loaded word (0 on the product path; the engine bench
// passes the iteration index).  The matrix is a runtime operand: one
// build serves the encode matrix and every per-signature recovery matrix.
//
// Its yardstick is the bytes, k*n read and R*n written once, at 3.35 TB/s
// (chip_smoke.py's bound_ms); what bounds it in fact is the network's
// instruction issue (the SASS counts below).  Design:
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
// - Donation (planar only): a thread loads all of its words of all k
//   rows before it stores any, and writes only the columns it read, so
//   out may be x when R == k.  No pointer is __restrict__ and no load
//   takes the read-only path, which is undefined for memory the kernel
//   writes.  The interleaved output must not overlap its input.
// - Parameter space: the masks are 32*RB*KB bytes; CUDA 12.1+ takes up to
//   32,764 bytes of parameters on sm_70 and up, so every bucket but
//   32 x 32 fits.  A matrix with more than 16 rows and more than 16
//   columns runs as row blocks of 16, one launch each (the wrapper
//   splits and counts each launch; a planar donated output goes through
//   a scratch buffer, since the second block reads rows the first wrote;
//   an interleaved launch writes its block's rows of every T-row).
//
// SASS of the main planar buckets (chip_smoke.py reads it from the built
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

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 32;  // isa allows k <= 32; a decode matrix is k x k
constexpr int kLanes = 128;  // words per row of a T-row (interleaved)
constexpr int kThreads = 256;
constexpr int kRowBlock = 16;  // rows per launch when R > 16 and k > 16

template <bool kShift>
__device__ __forceinline__ uint32_t gf_double(uint32_t v) {
  const uint32_t carry = (v >> 7) & 0x01010101u;  // logical shift: uint32_t
  const uint32_t red =
      kShift ? carry ^ (carry << 2) ^ (carry << 3) ^ (carry << 4)
             : carry * 0x1Du;
  return ((v & 0x7F7F7F7Fu) << 1) ^ red;
}

__host__ __device__ constexpr int bucket(int n) {
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

// Planar: row j is x + j * x_pitch and the thread's word is word w of
// it.  Interleaved (kInter): x_pitch and out_pitch are the T-row pitches
// (k*512 and R_total*512 bytes, out already at the launch's first row),
// T-row w / 128 holds the thread's rows 512 bytes apart, and its word is
// lane w % 128 of each.
template <int RB, int KB, bool kShift, bool kInter>
__global__ void __launch_bounds__(kThreads)
gf256_matmul_kernel(const uint8_t* x, int64_t x_pitch, uint8_t* out,
                    int64_t out_pitch, int64_t words, int k, int R,
                    uint32_t seed,
                    const __grid_constant__ K1Operand<RB, KB> op) {
  static_assert(kLanes == 128, "w >> 7 and w & 127 below");
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       w < words; w += step) {
    const uint8_t* xw = x;
    uint8_t* ow = out;
    int64_t x_row = x_pitch, out_row = out_pitch, col = w;
    if constexpr (kInter) {
      const int64_t t = w >> 7;
      xw += t * x_pitch;
      ow += t * out_pitch;
      x_row = out_row = kLanes * 4;
      col = w & 127;
    }
    uint32_t in[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j)
      in[j] = (j < k ? reinterpret_cast<const uint32_t*>(
                           xw + j * x_row)[col]
                     : 0u) ^ seed;
    auto emit = [&](int i) {
      reinterpret_cast<uint32_t*>(ow + i * out_row)[col] =
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

struct Launch {
  const uint8_t* x;
  int64_t x_pitch;
  uint8_t* out;
  int64_t out_pitch;
  int64_t words;
  int k, R;  // R: the rows of this launch
  uint32_t seed;
  const void* masks;
  int64_t masks_bytes;
  cudaStream_t stream;
};

template <int RB, int KB, bool kShift, bool kInter>
int launch(const Launch& a) {
  if constexpr (RB * KB > kRowBlock * kMaxDim) {
    return static_cast<int>(cudaErrorInvalidValue);  // 32 x 32: split rows
  } else {
    if (a.masks_bytes != static_cast<int64_t>(sizeof(K1Operand<RB, KB>)))
      return static_cast<int>(cudaErrorInvalidValue);
    K1Operand<RB, KB> op;
    std::memcpy(&op, a.masks, sizeof(op));
    int64_t blocks = (a.words + kThreads - 1) / kThreads;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
    gf256_matmul_kernel<RB, KB, kShift, kInter>
        <<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(
            a.x, a.x_pitch, a.out, a.out_pitch, a.words, a.k, a.R, a.seed,
            op);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int RB, bool kShift, bool kInter>
int launch_rows(const Launch& a) {
  switch (bucket(a.k)) {
    case 4: return launch<RB, 4, kShift, kInter>(a);
    case 8: return launch<RB, 8, kShift, kInter>(a);
    case 16: return launch<RB, 16, kShift, kInter>(a);
    default: return launch<RB, 32, kShift, kInter>(a);
  }
}

template <bool kShift, bool kInter>
int launch_bucket(const Launch& a) {
  switch (bucket(a.R)) {
    case 4: return launch_rows<4, kShift, kInter>(a);
    case 8: return launch_rows<8, kShift, kInter>(a);
    case 16: return launch_rows<16, kShift, kInter>(a);
    default: return launch_rows<32, kShift, kInter>(a);
  }
}

template <bool kInter>
int dispatch(const Launch& a, int mul_shift) {
  if (a.k < 1 || a.k > kMaxDim || a.R < 1 || a.R > kMaxDim ||
      (a.R > kRowBlock && a.k > kRowBlock))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.words <= 0) return static_cast<int>(cudaSuccess);
  return mul_shift ? launch_bucket<true, kInter>(a)
                   : launch_bucket<false, kInter>(a);
}

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
  if (x_row_bytes % 4 != 0 || out_row_bytes % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false>(
      {static_cast<const uint8_t*>(x), x_row_bytes,
       static_cast<uint8_t*>(out), out_row_bytes, words, k, R, seed, masks,
       masks_bytes, static_cast<cudaStream_t>(stream)},
      mul_shift);
}

// K2.  x: u32 [T, k, 128] contiguous; out: u32 [T, R, 128] contiguous,
// not overlapping x.  One launch writes rows r0 .. r0 + rows - 1 of every
// T-row; masks: the expanded operand of those rows, as for K1.  Returns
// cudaGetLastError() after the launch.
int gf256_interleaved_launch(const void* x, void* out, int64_t T, int k,
                             int R, int r0, int rows, uint32_t seed,
                             const void* masks, int64_t masks_bytes,
                             int mul_shift, void* stream) {
  if (T < 0 || T > INT64_MAX / kLanes || R < 1 || R > kMaxDim || r0 < 0 ||
      rows < 1 || r0 + rows > R)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int64_t row = kLanes * 4;
  return dispatch<true>(
      {static_cast<const uint8_t*>(x), k * row,
       static_cast<uint8_t*>(out) + r0 * row, R * row, T * kLanes, k, rows,
       seed, masks, masks_bytes, static_cast<cudaStream_t>(stream)},
      mul_shift);
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
