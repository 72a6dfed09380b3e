// Batched row CRC-32C on Hopper: the per-(job, shard) digests of a
// coalesced stripe batch.
//
// Replaces the XLA row program ceph_tpu/ops/crc32c_device.py:75
// (_rows_kernel), which ceph_tpu/tpu/queue.py:477-503 runs after every
// coalesced encode.  Function: CRC-32C (reflected poly 0x82F63B78, init and
// xorout 0xFFFFFFFF) of each row's bytes, chained from a per-row init value.
//
// Rows are read straight out of the [S, P] batch: row r = (job j, shard s)
// starts at base + s*row_stride + offs[j] and is lens[j] bytes long, chained
// from inits[j].  crc32c_lanes uses the same kernels with S = 1 and
// offs[j] = j*C.
//
// Bound: bytes, one read of the batch (24 rows x 512 KiB: 12.6 MB, 0.0038
// ms at 3.35 TB/s).  A CRC is a dependent chain, so the design cuts each
// row into independent pieces and joins them with the CRC combine.  Write
// s for the running value (s0 = init ^ ~0, result s_end ^ ~0).  s is
// affine in the data: S(s, A||B) = Z_|B|(S(s, A)) ^ S(0, B), where Z_n,
// "advance through n zero bytes", is multiplication by x^(8n) mod P in the
// reflected domain (zlib's crc32_combine).  The plain spec of all this is
// crc32c_rows_segmented_plain in ops/crc32c_device.py.
//
// Layout.  Let h = (row start) mod 16 and VE = floor16(h + len): the row's
// bytes up to the last 16-byte boundary, seen from the aligned address
// A = start - h, span [h, VE).  Leading zeros do not change a value that
// starts at 0 (S(0, 0^k || D) = S(0, D)), so the bytes of [0, h) are read
// as zeros and the span [0, VE) is cut into q = ceil(VE / kSeg) segments
// aligned to its END: segment i is [VE - (q-i)*kSeg, VE - (q-i-1)*kSeg),
// the first one reaching below 0 into more zeros.  Every segment and every
// piece then has its full size, so one set of constants serves them all.
//
// Pass 1 (crc32c_segments_kernel), grid (segment groups, rows): a warp
// takes one segment; lane l takes its l-th kPiece-byte piece, reads it as
// aligned 16-byte vectors (__ldg) and runs two slicing-by-8 steps per
// vector from state 0, with the eight 256-entry tables in shared memory.
// The lane weights its value by Z_{kPiece*(31-l)} (one carry-less multiply
// by a constant from the host) and the warp XORs the 32 values with
// __shfl_xor_sync: S(0, segment i), stored in the scratch partial[row][i].
//
// Pass 2 (crc32c_finish_kernel), a warp per row: lane l folds a run of
// c = pow2ceil(q/32) partials by Horner with Z_kSeg, weights the run by
// Z_{kSeg*c*l} (one multiply per set bit of l), and the warp XORs the
// runs.  Lane l also holds x^(8 * (bit l of len_main) * 2^l); a product
// tree over the warp gives x^(8*len_main), which times s0 is Z_len_main(s0)
// (len_main = VE - h, the bytes the segments cover).  The 0..15 bytes
// after VE go bit by bit from that value; rows shorter than 16 - h bytes
// have no segment and go bit by bit from s0.
//
// Cost: the table lookups (one per byte, 12.6 M at the main shape) are
// the likely limit, about 6 us of shared-memory throughput on 132 SMs;
// the 24 x 64 warps of the main shape are all resident at once.  Each
// multiply by a constant is a 32-step carry-less loop: one per lane in
// pass 1, about a dozen in pass 2's dependent chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;
constexpr uint32_t kOne = 0x80000000u;  // x^0, reflected
constexpr int kSegLog = 13;
constexpr int64_t kSeg = int64_t{1} << kSegLog;  // bytes per warp
constexpr int64_t kPiece = kSeg / 32;             // bytes per lane
constexpr int kWarps = 4;                          // warps per block, pass 1
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGridY = 65535;

struct Consts {
  uint32_t x2n[64];   // x^(8 * 2^i) mod P: Z_{2^i} as a multiplier
  uint32_t lane[32];  // x^(8 * kPiece * (31 - l)) mod P
};

__host__ __device__ inline uint32_t mulmod(uint32_t a, uint32_t b) {
  uint32_t p = 0;
  for (int i = 31; i >= 0; --i) {
    p ^= b & (0u - ((a >> i) & 1u));
    b = (b >> 1) ^ (kPoly & (0u - (b & 1u)));
  }
  return p;
}

struct RowInfo {
  const uint8_t* aligned;  // A = row start - h, 16-byte aligned
  int64_t h, len, ve, q;
  uint32_t init;
};

__device__ __forceinline__ RowInfo row_info(const uint8_t* base,
                                            int64_t row_stride, int S,
                                            const int64_t* meta, int64_t J,
                                            int64_t row) {
  const int64_t j = row / S;
  const int64_t s = row % S;
  const uint8_t* p = base + s * row_stride + meta[j];
  RowInfo r;
  r.h = static_cast<int64_t>(reinterpret_cast<uintptr_t>(p) & 15u);
  r.aligned = p - r.h;
  r.len = meta[J + j];
  r.ve = (r.h + r.len) & ~int64_t{15};
  r.q = (r.ve + kSeg - 1) / kSeg;
  r.init = static_cast<uint32_t>(meta[2 * J + j]);
  return r;
}

// Zero the bytes of word `word` (bytes 4*word .. 4*word+3 of a vector) that
// lie below byte h of the vector.
__device__ __forceinline__ uint32_t keep_from(uint32_t v, int word,
                                              int64_t h) {
  const int64_t drop = h - 4 * word;
  if (drop <= 0) return v;
  if (drop >= 4) return 0u;
  return v & (0xFFFFFFFFu << (8 * drop));
}

__global__ void __launch_bounds__(kThreads)
crc32c_segments_kernel(const uint8_t* base, int64_t row_stride, int S,
                       const int64_t* meta, int64_t J, uint32_t* partial,
                       int64_t max_q, const __grid_constant__ Consts k) {
  __shared__ uint32_t T[8][256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    uint32_t c = static_cast<uint32_t>(t);
    for (int i = 0; i < 8; ++i) c = (c & 1u) ? (c >> 1) ^ kPoly : (c >> 1);
    T[0][t] = c;
  }
  __syncthreads();
  for (int s = 1; s < 8; ++s) {
    for (int t = threadIdx.x; t < 256; t += blockDim.x) {
      const uint32_t prev = T[s - 1][t];
      T[s][t] = T[0][prev & 0xFFu] ^ (prev >> 8);
    }
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  const int64_t rows = J * S;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const RowInfo r = row_info(base, row_stride, S, meta, J, row);
    if (seg >= r.q) continue;  // uniform across the warp
    const int64_t u0 = r.ve - (r.q - seg) * kSeg + lane * kPiece;
    uint32_t c = 0;
#pragma unroll 4
    for (int64_t u = u0; u < u0 + kPiece; u += 16) {
      if (u + 16 <= r.h) continue;  // before the row: zeros, c stays 0
      uint4 v = __ldg(reinterpret_cast<const uint4*>(r.aligned + u));
      if (u < r.h) {  // u == 0: the vector holding the row's first byte
        v.x = keep_from(v.x, 0, r.h);
        v.y = keep_from(v.y, 1, r.h);
        v.z = keep_from(v.z, 2, r.h);
        v.w = keep_from(v.w, 3, r.h);
      }
      uint32_t lo = c ^ v.x;
      c = T[7][lo & 0xFFu] ^ T[6][(lo >> 8) & 0xFFu] ^
          T[5][(lo >> 16) & 0xFFu] ^ T[4][lo >> 24] ^ T[3][v.y & 0xFFu] ^
          T[2][(v.y >> 8) & 0xFFu] ^ T[1][(v.y >> 16) & 0xFFu] ^
          T[0][v.y >> 24];
      lo = c ^ v.z;
      c = T[7][lo & 0xFFu] ^ T[6][(lo >> 8) & 0xFFu] ^
          T[5][(lo >> 16) & 0xFFu] ^ T[4][lo >> 24] ^ T[3][v.w & 0xFFu] ^
          T[2][(v.w >> 8) & 0xFFu] ^ T[1][(v.w >> 16) & 0xFFu] ^
          T[0][v.w >> 24];
    }
    c = mulmod(c, k.lane[lane]);
#pragma unroll
    for (int t = 16; t >= 1; t >>= 1) c ^= __shfl_xor_sync(0xFFFFFFFFu, c, t);
    if (lane == 0) partial[row * max_q + seg] = c;
  }
}

__global__ void __launch_bounds__(kThreads)
crc32c_finish_kernel(const uint8_t* base, int64_t row_stride, int S,
                     const int64_t* meta, int64_t J, const uint32_t* partial,
                     int64_t max_q, uint32_t* out,
                     const __grid_constant__ Consts k) {
  const int lane = threadIdx.x & 31;
  const int64_t rows = J * S;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       row < rows; row += stride) {
    const RowInfo r = row_info(base, row_stride, S, meta, J, row);
    const int64_t len_main = r.q ? r.ve - r.h : 0;
    const uint32_t s0 = r.init ^ 0xFFFFFFFFu;

    // lane l: partials with reversed index rr = q-1-i in [l*c, (l+1)*c)
    int lc = 0;
    while ((int64_t{32} << lc) < r.q) ++lc;
    const int64_t c = int64_t{1} << lc;
    uint32_t acc = 0;
    for (int64_t t = c - 1; t >= 0; --t) {
      const int64_t rr = lane * c + t;
      acc = mulmod(acc, k.x2n[kSegLog]);
      if (rr < r.q) acc ^= partial[row * max_q + (r.q - 1 - rr)];
    }
    for (int b = 0; b < 5; ++b)
      if ((lane >> b) & 1) acc = mulmod(acc, k.x2n[kSegLog + lc + b]);
#pragma unroll
    for (int t = 16; t >= 1; t >>= 1)
      acc ^= __shfl_xor_sync(0xFFFFFFFFu, acc, t);

    // x^(8 * len_main): bits 0..31 over the lanes, bits 32..63 after
    uint32_t f = ((len_main >> lane) & 1) ? k.x2n[lane] : kOne;
#pragma unroll
    for (int t = 16; t >= 1; t >>= 1)
      f = mulmod(f, __shfl_xor_sync(0xFFFFFFFFu, f, t));
    if (lane == 0) {
      for (int b = 32; b < 64; ++b)
        if ((len_main >> b) & 1) f = mulmod(f, k.x2n[b]);
      uint32_t s = acc ^ mulmod(f, s0);
      const uint8_t* p = r.aligned + r.h;
      for (int64_t i = len_main; i < r.len; ++i) {
        s ^= p[i];
        for (int b = 0; b < 8; ++b) s = (s >> 1) ^ (kPoly & (0u - (s & 1u)));
      }
      out[row] = s ^ 0xFFFFFFFFu;
    }
  }
}

const Consts& consts() {
  static const Consts k = [] {
    Consts c{};
    c.x2n[0] = 1u << 23;  // x^8
    for (int i = 1; i < 64; ++i) c.x2n[i] = mulmod(c.x2n[i - 1], c.x2n[i - 1]);
    for (int l = 0; l < 32; ++l) {
      uint32_t p = kOne;
      const uint64_t n = static_cast<uint64_t>(kPiece) * (31 - l);
      for (int i = 0; i < 64; ++i)
        if ((n >> i) & 1) p = mulmod(p, c.x2n[i]);
      c.lane[l] = p;
    }
    return c;
  }();
  return k;
}

}  // namespace

extern "C" {

// Segments of a row of `len` bytes: the size of pass 1's scratch per row.
int64_t crc32c_max_segments(int64_t max_len) {
  return (max_len + 15 + kSeg - 1) / kSeg;
}

// meta: device int64 [3, J] = (column offset, length, init) per job.
// partial: device uint32 scratch [J * S, max_q], max_q =
// crc32c_max_segments(longest row).  out: device uint32 [J * S], row
// r = j*S + s.  Two launches on `stream`; returns cudaGetLastError().
int crc32c_rows_launch(const void* base, int64_t row_stride, int S,
                       const void* meta, int64_t J, void* partial,
                       int64_t max_q, void* out, void* stream) {
  if (S < 1 || J < 0 || max_q < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = J * S;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const Consts& k = consts();
  const uint8_t* b = static_cast<const uint8_t*>(base);
  const int64_t* m = static_cast<const int64_t*>(meta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (max_q > 0) {
    const dim3 grid(static_cast<unsigned>((max_q + kWarps - 1) / kWarps),
                    static_cast<unsigned>(rows < kMaxGridY ? rows
                                                           : kMaxGridY));
    crc32c_segments_kernel<<<grid, kThreads, 0, st>>>(
        b, row_stride, S, m, J, static_cast<uint32_t*>(partial), max_q, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;
  crc32c_finish_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      b, row_stride, S, m, J, static_cast<const uint32_t*>(partial), max_q,
      static_cast<uint32_t*>(out), k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
