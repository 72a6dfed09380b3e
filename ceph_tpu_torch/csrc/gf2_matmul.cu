// GF(2) bit-matrix product on Hopper: the erasure-code engine of the
// bit-matrix techniques (jerasure cauchy_*, liberation, blaum_roth,
// liber8tion) and of the shec decode.
//
// Replaces the Pallas kernel ceph_tpu/ops/gf2_matmul.py:87 (_gf2_kernel),
// reached through gf2_matmul_bytes (:141).  It computes, for an int8 0/1
// matrix mbits [8R, 8K] and byte rows x [K, n]:
//   expand x to bit-planes [8K, n] (plane 8j+b = bit b of row j),
//   multiply by mbits accumulating in int32, keep the low bit, and pack
//   each group of 8 planes back into a byte row: out [R, n].
// Each output bit is therefore the parity of (row of mbits) AND (the 8K
// bits of one column: the low bit of popc(mask row & column bits).
//
// Batched packet entry.  A bit-matrix codec splits each chunk row of a
// job into w packets of width/w bytes and applies the matrix to the
// k*w packet rows.  Jobs of a coalesced batch lie side by side in one
// [rows, P] buffer, each at its own column offset.  Logical input row
// L = c*w + p of job j is x[c, off_j + p*ps_j + t] and logical output row
// i*w + q goes to out[i, off_j + q*ps_j + t], ps_j = width_j / w, for
// t in [0, ps_j).  With w = 1 and one job over all n columns this is the
// plain [K, n] -> [R, n] product.  The job table rides in a
// __grid_constant__ argument (up to 240 jobs per launch); blockIdx.y is
// the job.
//
// Two kernels, and the host picks one by the operand's structure alone:
// gf2_xor_packets_kernel (below) for 0/1 packet matrices, every jerasure
// bit-matrix encode and decode; gf2_matmul_kernel, the popcount form, for
// every other operand (shec's decode).
//
// Popcount design: the binary tensor-core product.  Each output bit is
// the parity of popc(mask row & column bits), which is what
// mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc computes for a
// 16 x 8 tile at once over 256 k-bits (BMMA.168256.AND.POPC in SASS,
// issued at the rate of the int8 IMMA.16832 on an H100, so 8x its bit
// products).  Roles: the data is A, one fragment row per byte column (M =
// 16 columns a tile); the matrix is B, its 8 columns the 8 bits of one
// output byte row (N = 8); k runs over the 8K bit-planes, 256 a step
// (K <= 32, 64, 128 input rows take 1, 2, 4 steps).  With K <= 16 (both
// of shec's read operands) only the first 128 k-bits carry data, and the
// kernel takes the m16n8k128 form over a0, a1 and b0 (BMMA.168128: 16
// cycles of dependent latency against 25).  The matrix is a runtime
// operand, not a compile-time constant: one build serves the encode
// matrix and every survivor-signature recovery matrix.
//
// Operands.  Word q of a column's k-bits holds input rows 4q..4q+3, bit
// 8r+b = bit b of row 4q+r; word q of mask row 8i+b holds mbits columns
// 32q..32q+31 of that row.  Lane (g = lane>>2, t = lane&3) of an mma owns
// k-words t and t+4 of A rows g and g+8 and of B column g, and the sums
// of rows {g, g+8} x columns {2t, 2t+1}.  The host lays the mask words out
// in exactly that order (ops/gf2_matmul.py mma_fragments: per output row
// and step, one uint2 a lane), and each lane reads its own from device
// memory (every warp reads the same few hundred bytes, which stay in L1).
// For A, lane (g, t) loads input rows 4t..4t+3 and 16+4t..19+4t of the
// step at its own 4*CW-byte column chunk (CW = 4 / STEPS words; 16, 8
// or 4 bytes), one vector load per row, every load of the tile in flight
// before the first mma, lanes past K loading nothing.  The 4x4
// __byte_perm transpose turns each loaded word into k-word t of four
// neighbouring columns, and those four are A rows g and g+8 of two M
// tiles: tile m stands for columns 2m (row g) and 2m+1 (row g+8) of
// every group's chunk.  So a warp tile covers 32*CW columns in 2*CW M
// tiles, holds its A fragments for all steps in 32 registers, and runs,
// per output row, 2*CW*STEPS mma against that row's B fragments.
//
// Epilogue.  A lane's sums are bits 2t and 2t+1 of the output bytes of
// columns 2m and 2m+1.  It takes their low bits into CW words (byte c of
// word w = column 4w+c of its group's chunk), the quad exchanges them
// with two __shfl_xor_sync steps so that lane t holds word t (or, for CW
// < 4, the word it stores), and each lane stores one 4-byte word: a warp
// writes 32*CW contiguous bytes of an output row.  Output does not touch
// shared memory.  A warp reads every input row of its columns before it
// writes any, and no other warp touches them, so the output may alias
// the input when R == K.  A tile wholly inside an aligned job loads and
// stores without per-row checks; ragged widths and unaligned rows take
// load4 / store4's byte-wise edge.
//
// Bound on an H100: bytes.  The shec read's [24, 64] operand on [8, 512
// Ki] moves 5.8 MB (1.7 us at 3.35 TB/s).  What sets its time instead is
// issue: per output row a warp tile issues 8 BMMA and about 60 other
// instructions (the parity gather, the quad exchange, the store), so each
// row of R costs about as much as the bytes of the whole tile (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxJobs = 240;  // keeps the argument block under 4 KiB
constexpr int kMaxBlocksX = 2048;
constexpr int kMaxSmem = 232448;  // 227 KiB: an H100 block's opt-in limit
constexpr int kDefaultSmem = 49152;  // without the opt-in
constexpr unsigned kFull = 0xffffffffu;

struct Jobs {
  int64_t off[kMaxJobs];    // first column of job j in the batch
  int64_t width[kMaxJobs];  // its columns (a multiple of w)
};

// Four bytes p[0..3] (those below `avail`) as one little-endian word.
__device__ __forceinline__ uint32_t load4(const uint8_t* p, int64_t avail) {
  if (avail >= 4 && (reinterpret_cast<uintptr_t>(p) & 3u) == 0)
    return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < avail) v |= static_cast<uint32_t>(p[c]) << (8 * c);
  return v;
}

__device__ __forceinline__ void store4(uint8_t* p, int64_t avail,
                                       uint32_t v) {
  if (avail >= 4 && (reinterpret_cast<uintptr_t>(p) & 3u) == 0) {
    *reinterpret_cast<uint32_t*>(p) = v;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < avail) p[c] = static_cast<uint8_t>(v >> (8 * c));
}

// CW little-endian words at p: one vector load when the chunk is whole
// and aligned (kWhole), else word by word, bytes below `avail` only.
template <int CW, bool kWhole>
__device__ __forceinline__ void load_words(const uint8_t* p, int64_t avail,
                                           uint32_t (&v)[CW]) {
  if constexpr (kWhole) {
    if constexpr (CW == 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else if constexpr (CW == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      v[0] = u.x, v[1] = u.y;
    } else {
      v[0] = *reinterpret_cast<const uint32_t*>(p);
    }
  } else {
#pragma unroll
    for (int c = 0; c < CW; ++c) v[c] = load4(p + 4 * c, avail - 4 * c);
  }
}

// A lane's input rows 32s + 16h + 4t + r of one warp tile at its column
// chunk c0, zero past K (a half-step wholly past K is skipped, a branch
// the warp takes together).
template <int STEPS, int CW, bool kWhole>
__device__ __forceinline__ void load_rows(uint32_t (&v)[STEPS][2][4][CW],
                                          const uint8_t* x,
                                          const int64_t* in_row, int64_t c0,
                                          int64_t avail, int K, int t) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int L = 32 * s + 16 * h + 4 * t + r;
        if (32 * s + 16 * h < K && L < K) {
          load_words<CW, kWhole>(x + in_row[L] + c0, avail, v[s][h][r]);
        } else {
#pragma unroll
          for (int c = 0; c < CW; ++c) v[s][h][r][c] = 0u;
        }
      }
    }
  }
}

// d += popc(A & B) over 128 k-bits (a0, a1, b0 of the layout above): the
// first half of a step, all there is when K <= 16.
__device__ __forceinline__ void bmma_half(uint32_t (&d)[4],
                                          const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b.x));
}

// d += popc(A & B) over 256 k-bits for a 16 x 8 tile (see the layout above).
__device__ __forceinline__ void bmma(uint32_t (&d)[4], const uint32_t (&a)[4],
                                     uint2 b) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The low bits of two tiles' sums as one output word of the lane's quad:
// byte c is column 4w+c (tile lo: columns 4w, 4w+1; tile hi: 4w+2, 4w+3),
// bits 2t and 2t+1 set from this lane's output bits.
__device__ __forceinline__ uint32_t parity_word(const uint32_t (&lo)[4],
                                                const uint32_t (&hi)[4],
                                                int t) {
  const uint32_t e = __byte_perm(__byte_perm(lo[0], lo[2], 0x40),
                                 __byte_perm(hi[0], hi[2], 0x40), 0x5410);
  const uint32_t o = __byte_perm(__byte_perm(lo[1], lo[3], 0x40),
                                 __byte_perm(hi[1], hi[3], 0x40), 0x5410);
  return ((e & 0x01010101u) | ((o & 0x01010101u) << 1)) << (2 * t);
}

template <int STEPS, bool kHalf>
__global__ void __launch_bounds__(kThreads, 8)
gf2_matmul_kernel(const uint8_t* x, int64_t x_row_bytes, uint8_t* out,
                  int64_t out_row_bytes, int w, int K, int R,
                  const uint2* __restrict__ frags,
                  const __grid_constant__ Jobs jobs) {
  constexpr int CW = 4 / STEPS;  // 4-column words a lane loads per row
  constexpr int TILES = 2 * CW;  // M tiles of a warp
  constexpr int WARP_COLS = 32 * CW;
  extern __shared__ int64_t rows[];
  int64_t* in_row = rows;        // [K]
  int64_t* out_row = rows + K;   // [R]
  const int j = blockIdx.y;
  const int64_t off = jobs.off[j];
  const int64_t ps = w == 1 ? jobs.width[j] : jobs.width[j] / w;
  for (int L = threadIdx.x; L < K; L += blockDim.x)
    in_row[L] = (L / w) * x_row_bytes + off + (L % w) * ps;
  for (int L = threadIdx.x; L < R; L += blockDim.x)
    out_row[L] = (L / w) * out_row_bytes + off + (L % w) * ps;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  // every chunk a lane loads or stores starts 4*CW-aligned, so a warp
  // tile inside the job takes no per-row edge checks
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
        static_cast<uint64_t>(x_row_bytes | out_row_bytes | off |
                              (w > 1 ? ps : 0))) &
       (4u * CW - 1)) == 0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps * WARP_COLS;
  // the warp's first column; lane group g = lane>>2 takes 4*CW from there
  for (int64_t tw = (static_cast<int64_t>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5)) * WARP_COLS;
       tw < ps; tw += step) {
    const int64_t c0 = tw + 4 * CW * (lane >> 2);
    const int64_t avail = ps - c0;
    const bool whole = aligned && tw + WARP_COLS <= ps;
    uint32_t v[STEPS][2][4][CW];
    if (whole)
      load_rows<STEPS, CW, true>(v, x, in_row, c0, avail, K, t);
    else
      load_rows<STEPS, CW, false>(v, x, in_row, c0, avail, K, t);
    // 4x4 byte transposes: word c of rows 4t..4t+3 becomes k-word t of
    // columns 4c..4c+3, A rows g and g+8 of tiles 2c and 2c+1
    uint32_t a[STEPS][TILES][4];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const uint32_t(&q)[4][CW] = v[s][h];
          const uint32_t lo01 = __byte_perm(q[0][c], q[1][c], 0x5140);
          const uint32_t hi01 = __byte_perm(q[0][c], q[1][c], 0x7362);
          const uint32_t lo23 = __byte_perm(q[2][c], q[3][c], 0x5140);
          const uint32_t hi23 = __byte_perm(q[2][c], q[3][c], 0x7362);
          a[s][2 * c][2 * h] = __byte_perm(lo01, lo23, 0x5410);
          a[s][2 * c][2 * h + 1] = __byte_perm(lo01, lo23, 0x7632);
          a[s][2 * c + 1][2 * h] = __byte_perm(hi01, hi23, 0x5410);
          a[s][2 * c + 1][2 * h + 1] = __byte_perm(hi01, hi23, 0x7632);
        }
      }
    }
    uint8_t* const ob = out + c0 + 4 * t;
    for (int i = 0; i < R; ++i) {
      uint2 b[STEPS];
#pragma unroll
      for (int s = 0; s < STEPS; ++s) b[s] = frags[(i * STEPS + s) * 32 + lane];
      uint32_t word[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        uint32_t d0[4] = {0u, 0u, 0u, 0u}, d1[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
          if constexpr (kHalf) {  // K <= 16: a2, a3 and b1 are zero
            bmma_half(d0, a[s][2 * c], b[s]);
            bmma_half(d1, a[s][2 * c + 1], b[s]);
          } else if (32 * s < K) {  // uniform: steps past K hold no rows
            bmma(d0, a[s][2 * c], b[s]);
            bmma(d1, a[s][2 * c + 1], b[s]);
          }
        }
        word[c] = parity_word(d0, d1, t);
      }
      // OR the quad's bits together so that lane t holds word t
      uint32_t mine;
      if constexpr (CW == 4) {
        const bool hi = t & 2;
        const uint32_t k0 = (hi ? word[2] : word[0]) |
                            __shfl_xor_sync(kFull, hi ? word[0] : word[2], 2);
        const uint32_t k1 = (hi ? word[3] : word[1]) |
                            __shfl_xor_sync(kFull, hi ? word[1] : word[3], 2);
        mine = (t & 1 ? k1 : k0) | __shfl_xor_sync(kFull, t & 1 ? k0 : k1, 1);
      } else if constexpr (CW == 2) {
        mine = (t & 1 ? word[1] : word[0]) |
               __shfl_xor_sync(kFull, t & 1 ? word[0] : word[1], 1);
        mine |= __shfl_xor_sync(kFull, mine, 2);
      } else {
        mine = word[0] | __shfl_xor_sync(kFull, word[0], 1);
        mine |= __shfl_xor_sync(kFull, mine, 2);
      }
      uint8_t* const p = ob + out_row[i];
      if (whole) {
        if (t < CW) *reinterpret_cast<uint32_t*>(p) = mine;
      } else if (t < CW && avail > 4 * t) {
        store4(p, avail - 4 * t, mine);
      }
    }
  }
}

// Opt a kernel in to an H100 block's full shared memory.  Skipped while
// the stream is being captured into a CUDA graph (a timing loop): the
// attribute was set by an earlier, uncaptured launch on the card.
template <typename Kernel>
cudaError_t allow_full_smem(Kernel kernel, cudaStream_t stream) {
  cudaStreamCaptureStatus cap = cudaStreamCaptureStatusNone;
  const cudaError_t err = cudaStreamIsCapturing(stream, &cap);
  if (err != cudaSuccess) return err;
  if (cap != cudaStreamCaptureStatusNone) return cudaSuccess;
  // the same value from every caller: safe across host threads
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

template <int STEPS, bool kHalf = false>
int launch(const uint8_t* x, int64_t xs, uint8_t* out, int64_t os, int w,
           int K, int R, const uint2* frags, const Jobs& jobs, int J,
           int64_t max_ps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K + R) * 8;  // the row offsets
  if (smem > static_cast<size_t>(kDefaultSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  // a warp tile of 128 / STEPS columns: a 512 KiB job is 1024 blocks at
  // K <= 32, all resident at once on 132 SMs
  const int64_t block_cols = kWarps * 128LL / STEPS;
  int64_t blocks = (max_ps + block_cols - 1) / block_cols;
  if (blocks > kMaxBlocksX) blocks = kMaxBlocksX;  // grid-stride beyond
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(J));
  gf2_matmul_kernel<STEPS, kHalf><<<grid, kThreads, smem, stream>>>(
      x, xs, out, os, w, K, R, frags, jobs);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// Packet-XOR path.  Every operand a jerasure bit-matrix codec builds is a
// 0/1 packet matrix with each entry expanded to a zero or identity 8x8
// block, so output packet row i is the XOR of the input packet rows its
// CSR list names (jerasure's own schedule).  The host finds that
// structure once per operand (ops/gf2_matmul.py BitOperand) and sends the
// lists; this kernel then moves bytes instead of evaluating 8R*8K bit
// products: cauchy_good k=8 m=4 encode XORs 691 packet rows per packet
// column where the popcount kernel evaluates all 256 x 512 bit products
// of every column.  Bound: bytes (each input packet row read
// once, each output row written once; 0.0038 ms for the 2-job write
// batch at 3.35 TB/s), the XORs are nnz * cols / 16 uint4 ops.
//
// A block takes job blockIdx.y and walks its column tiles of kXorTile
// bytes (grid-stride over blockIdx.x).  It stages the tile of all K input
// packet rows into shared memory with 16-byte cp.async copies, the next
// tile's copies in flight while it works on this one (two buffers), so
// each input byte is read from device memory once and re-read about
// nnz/K times from shared memory.  Thread (chunk c, group g) then XORs,
// for output rows g, g + kXorGroups, ..., the listed rows' 16 bytes at
// column 16c of the tile and writes 16-byte vectors.  Rows whose packet
// start is not 16-byte aligned (odd job offsets, packet widths that are
// not multiples of 16), and the ragged tile at a packet's end, take a
// byte-wise edge in the copy and in the store.  A block stages every
// input row of a tile before it writes the tile's columns and no other
// block touches them, so out may be x itself (R == K, the same rows).
// ---------------------------------------------------------------------------

constexpr int kXorTile = 256;                        // columns per tile
constexpr int kXorChunks = kXorTile / 16;            // 16-byte chunks a row
constexpr int kXorGroups = kThreads / kXorChunks;    // output-row groups

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Copy the tile at column t0 of every input packet row into buf [K][tile].
__device__ __forceinline__ void stage_tile(uint8_t* buf, const uint8_t* x,
                                           const int64_t* in_row, int K,
                                           int64_t ps, int64_t t0) {
  for (int i = threadIdx.x; i < K * kXorChunks; i += blockDim.x) {
    const int L = i / kXorChunks;
    const int64_t col = t0 + 16 * (i % kXorChunks);
    const int64_t avail = ps - col;
    if (avail <= 0) continue;
    const uint8_t* src = x + in_row[L] + col;
    uint8_t* dst = buf + L * kXorTile + (col - t0);
    if (avail >= 16 && aligned16(src)) {
      cp_async16(dst, src);
    } else {
      const int n = avail < 16 ? static_cast<int>(avail) : 16;
      for (int b = 0; b < n; ++b) dst[b] = src[b];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gf2_xor_packets_kernel(const uint8_t* x, int64_t x_row_bytes, uint8_t* out,
                       int64_t out_row_bytes, int w, int K, int R,
                       const int32_t* __restrict__ rowptr,
                       const uint8_t* __restrict__ idx,
                       const __grid_constant__ Jobs jobs) {
  extern __shared__ __align__(16) uint8_t xsm[];
  uint8_t* tiles = xsm;  // [2][K][kXorTile]
  int64_t* in_row =
      reinterpret_cast<int64_t*>(xsm + 2 * static_cast<size_t>(K) * kXorTile);
  int64_t* out_row = in_row + K;
  const int j = blockIdx.y;
  const int64_t off = jobs.off[j];
  const int64_t ps = jobs.width[j] / w;
  for (int L = threadIdx.x; L < K; L += blockDim.x)
    in_row[L] = (L / w) * x_row_bytes + off + (L % w) * ps;
  for (int L = threadIdx.x; L < R; L += blockDim.x)
    out_row[L] = (L / w) * out_row_bytes + off + (L % w) * ps;
  __syncthreads();

  const int64_t ntiles = (ps + kXorTile - 1) / kXorTile;
  int64_t tile = blockIdx.x;
  if (tile >= ntiles) return;  // the whole block
  const int chunk = threadIdx.x % kXorChunks;
  const int group = threadIdx.x / kXorChunks;
  int b = 0;
  stage_tile(tiles, x, in_row, K, ps, tile * kXorTile);
  cp_async_commit();
  for (; tile < ntiles; tile += gridDim.x) {
    const int64_t next = tile + gridDim.x;
    if (next < ntiles) {
      stage_tile(tiles + (b ^ 1) * K * kXorTile, x, in_row, K, ps,
                 next * kXorTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int64_t col = tile * kXorTile + 16 * chunk;
    const int64_t avail = ps - col;
    if (avail > 0) {
      const uint8_t* buf = tiles + b * K * kXorTile + 16 * chunk;
      for (int i = group; i < R; i += kXorGroups) {
        uint4 acc = make_uint4(0u, 0u, 0u, 0u);
        for (int e = rowptr[i]; e < rowptr[i + 1]; ++e) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(buf + idx[e] * kXorTile);
          acc.x ^= v.x;
          acc.y ^= v.y;
          acc.z ^= v.z;
          acc.w ^= v.w;
        }
        uint8_t* dst = out + out_row[i] + col;
        if (avail >= 16 && aligned16(dst)) {
          *reinterpret_cast<uint4*>(dst) = acc;
        } else {
          const uint32_t words[4] = {acc.x, acc.y, acc.z, acc.w};
          const int n = avail < 16 ? static_cast<int>(avail) : 16;
          for (int c = 0; c < n; ++c)
            dst[c] = static_cast<uint8_t>(words[c >> 2] >> (8 * (c & 3)));
        }
      }
    }
    __syncthreads();  // this buffer is staged again two tiles on
    b ^= 1;
  }
}

}  // namespace

extern "C" {

// x: input rows (row pitch x_row_bytes), out: output rows (pitch
// out_row_bytes), both with unit column stride; offs/widths: host arrays
// of J job extents (J <= 240, widths multiples of w); K, R: logical input
// and output rows (K <= 4*kw); frags: device mask words in mma fragment
// order, [R][kw/8][32 lanes][2]; kw in {8, 16, 32}.  Returns
// cudaGetLastError() after the launch.
int gf2_matmul_launch(const void* x, int64_t x_row_bytes, void* out,
                      int64_t out_row_bytes, const int64_t* offs,
                      const int64_t* widths, int J, int w, int K, int R,
                      const void* frags, int kw, void* stream) {
  if (J < 1 || J > kMaxJobs || w < 1 || K < 1 || R < 1 || K > 4 * kw)
    return static_cast<int>(cudaErrorInvalidValue);
  Jobs jobs = {};
  int64_t max_ps = 0;
  for (int j = 0; j < J; ++j) {
    if (offs[j] < 0 || widths[j] < 0 || widths[j] % w != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    jobs.off[j] = offs[j];
    jobs.width[j] = widths[j];
    if (widths[j] / w > max_ps) max_ps = widths[j] / w;
  }
  if (max_ps == 0) return static_cast<int>(cudaSuccess);
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  uint8_t* ob = static_cast<uint8_t*>(out);
  const uint2* fr = static_cast<const uint2*>(frags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 8:
      if (K <= 16)
        return launch<1, true>(xb, x_row_bytes, ob, out_row_bytes, w, K, R,
                               fr, jobs, J, max_ps, s);
      return launch<1>(xb, x_row_bytes, ob, out_row_bytes, w, K, R, fr, jobs,
                       J, max_ps, s);
    case 16:
      return launch<2>(xb, x_row_bytes, ob, out_row_bytes, w, K, R, fr, jobs,
                       J, max_ps, s);
    case 32:
      return launch<4>(xb, x_row_bytes, ob, out_row_bytes, w, K, R, fr, jobs,
                       J, max_ps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The packet-XOR path: the same x, out, job table and packet addressing as
// gf2_matmul_launch; rowptr: device int32 [R+1] and idx: device uint8
// [nnz], output packet row i = XOR of input packet rows
// idx[rowptr[i]..rowptr[i+1]).  K <= 256.  Returns cudaGetLastError().
int gf2_xor_packets_launch(const void* x, int64_t x_row_bytes, void* out,
                           int64_t out_row_bytes, const int64_t* offs,
                           const int64_t* widths, int J, int w, int K, int R,
                           const void* rowptr, const void* idx,
                           void* stream) {
  if (J < 1 || J > kMaxJobs || w < 1 || K < 1 || R < 1 || K > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Jobs jobs = {};
  int64_t max_ps = 0;
  for (int j = 0; j < J; ++j) {
    if (offs[j] < 0 || widths[j] < 0 || widths[j] % w != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    jobs.off[j] = offs[j];
    jobs.width[j] = widths[j];
    if (widths[j] / w > max_ps) max_ps = widths[j] / w;
  }
  if (max_ps == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = 2 * static_cast<size_t>(K) * kXorTile +
                      static_cast<size_t>(K + R) * 8;
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = allow_full_smem(gf2_xor_packets_kernel, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (max_ps + kXorTile - 1) / kXorTile;
  if (blocks > kMaxBlocksX) blocks = kMaxBlocksX;  // grid-stride beyond
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(J));
  gf2_xor_packets_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(x), x_row_bytes,
      static_cast<uint8_t*>(out), out_row_bytes, w, K, R,
      static_cast<const int32_t*>(rowptr), static_cast<const uint8_t*>(idx),
      jobs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
