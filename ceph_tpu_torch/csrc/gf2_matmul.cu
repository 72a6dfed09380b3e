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
// bits of one column), which this kernel takes as __popc(mask & col) & 1.
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
// Popcount design.  The matrix is a runtime operand, not a compile-time
// constant: one build serves the encode matrix and every survivor-signature
// recovery matrix.  The host packs each of the 8R rows of mbits into KW
// u32 masks (bit i of word q = column 32q+i); a block copies them into
// shared memory (16 KiB for the cauchy_good k=8 m=4 encode [256, 512],
// 32 KiB for its decode [512, 512]).  A thread owns four neighbouring
// columns: it reads its K input bytes per column (one 4-byte load per
// row where aligned), byte-transposes them with __byte_perm so column c's
// 8K bits sit in KW registers col[c][0..KW), and then for each output bit
// XORs (mask & col) over the KW words and takes the parity.  The mask
// words are read from shared memory as 16-byte broadcasts and each is
// used for four columns.  The bit-planes never touch device memory: the
// kernel reads K bytes and writes R bytes per column, as the Pallas
// kernel did in VMEM.  The kernel is templated on the KW bucket (4, 8,
// 16, 32 words, i.e. K <= 16, 32, 64, 128) so the columns stay in
// registers.  A thread reads all its input before it writes, so the
// output may alias the input when R == K.
//
// Bound on an H100: per column it does 8R * KW AND/XOR pairs and 8R
// popcounts against K + R bytes of traffic (cauchy_good k=8 m=4 encode:
// 4096 logic ops for 96 bytes), so it is bound by integer operations,
// not by HBM.  The Hopper route to its tensor-core bound is the binary
// mma.sync (.b1.and.popc) or an int8 wgmma; this first version is the
// plain popcount form.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxJobs = 240;  // keeps the argument block under 4 KiB
constexpr int kMaxBlocksX = 2048;
constexpr int kMaxSmem = 232448;  // 227 KiB: an H100 block's opt-in limit

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

template <int KW>
__global__ void __launch_bounds__(kThreads)
gf2_matmul_kernel(const uint8_t* x, int64_t x_row_bytes, uint8_t* out,
                  int64_t out_row_bytes, int w, int K, int R,
                  const uint32_t* __restrict__ masks,
                  const __grid_constant__ Jobs jobs) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int R8 = 8 * R;
  uint32_t* sm_mask = smem;                                       // [R8][KW]
  int64_t* in_row = reinterpret_cast<int64_t*>(smem + R8 * KW);  // [K]
  int64_t* out_row = in_row + K;                                  // [R]
  const int j = blockIdx.y;
  const int64_t off = jobs.off[j];
  const int64_t ps = jobs.width[j] / w;
  for (int i = threadIdx.x; i < R8 * KW; i += blockDim.x)
    sm_mask[i] = masks[i];
  for (int L = threadIdx.x; L < K; L += blockDim.x)
    in_row[L] = (L / w) * x_row_bytes + off + (L % w) * ps;
  for (int L = threadIdx.x; L < R; L += blockDim.x)
    out_row[L] = (L / w) * out_row_bytes + off + (L % w) * ps;
  __syncthreads();

  const int64_t step = 4LL * gridDim.x * blockDim.x;
  for (int64_t t = 4LL * (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                          threadIdx.x);
       t < ps; t += step) {
    const int64_t avail = ps - t;
    uint32_t col[4][KW];
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      uint32_t v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int L = 4 * q + r;
        v[r] = L < K ? load4(x + in_row[L] + t, avail) : 0u;
      }
      // 4x4 byte transpose: byte r of col[c][q] = byte c of v[r], i.e.
      // bit 8r+b of word q = bit b of row 4q+r in column t+c
      const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140);
      const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362);
      const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140);
      const uint32_t hi23 = __byte_perm(v[2], v[3], 0x7362);
      col[0][q] = __byte_perm(lo01, lo23, 0x5410);
      col[1][q] = __byte_perm(lo01, lo23, 0x7632);
      col[2][q] = __byte_perm(hi01, hi23, 0x5410);
      col[3][q] = __byte_perm(hi01, hi23, 0x7632);
    }
    for (int i = 0; i < R; ++i) {
      uint32_t word = 0;  // byte c = output byte of column t+c
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const uint4* mrow =
            reinterpret_cast<const uint4*>(sm_mask + (8 * i + b) * KW);
        uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
        for (int q4 = 0; q4 < KW / 4; ++q4) {
          const uint4 mk = mrow[q4];
          const int q = 4 * q4;
          a0 ^= (mk.x & col[0][q]) ^ (mk.y & col[0][q + 1]) ^
                (mk.z & col[0][q + 2]) ^ (mk.w & col[0][q + 3]);
          a1 ^= (mk.x & col[1][q]) ^ (mk.y & col[1][q + 1]) ^
                (mk.z & col[1][q + 2]) ^ (mk.w & col[1][q + 3]);
          a2 ^= (mk.x & col[2][q]) ^ (mk.y & col[2][q + 1]) ^
                (mk.z & col[2][q + 2]) ^ (mk.w & col[2][q + 3]);
          a3 ^= (mk.x & col[3][q]) ^ (mk.y & col[3][q + 1]) ^
                (mk.z & col[3][q + 2]) ^ (mk.w & col[3][q + 3]);
        }
        word |= ((__popc(a0) & 1u) << b) | ((__popc(a1) & 1u) << (8 + b)) |
                ((__popc(a2) & 1u) << (16 + b)) |
                ((__popc(a3) & 1u) << (24 + b));
      }
      store4(out + out_row[i] + t, avail, word);
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

template <int KW>
int launch(const uint8_t* x, int64_t xs, uint8_t* out, int64_t os, int w,
           int K, int R, const uint32_t* masks, const Jobs& jobs, int J,
           int64_t max_ps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(8 * R) * KW * 4 +
                      static_cast<size_t>(K + R) * 8;
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_full_smem(gf2_matmul_kernel<KW>, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (max_ps + 4LL * kThreads - 1) / (4LL * kThreads);
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocksX) blocks = kMaxBlocksX;  // grid-stride beyond
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(J));
  gf2_matmul_kernel<KW><<<grid, kThreads, smem, stream>>>(
      x, xs, out, os, w, K, R, masks, jobs);
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
// column where the popcount kernel spends 8192 logic ops and 256
// popcounts per 4 columns.  Bound: bytes (each input packet row read
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
// and output rows (K <= 4*kw); masks: device u32 [8R, kw]; kw in
// {4, 8, 16, 32}.  Returns cudaGetLastError() after the launch.
int gf2_matmul_launch(const void* x, int64_t x_row_bytes, void* out,
                      int64_t out_row_bytes, const int64_t* offs,
                      const int64_t* widths, int J, int w, int K, int R,
                      const void* masks, int kw, void* stream) {
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
  const uint32_t* mk = static_cast<const uint32_t*>(masks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 4:
      return launch<4>(xb, x_row_bytes, ob, out_row_bytes, w, K, R, mk, jobs,
                       J, max_ps, s);
    case 8:
      return launch<8>(xb, x_row_bytes, ob, out_row_bytes, w, K, R, mk, jobs,
                       J, max_ps, s);
    case 16:
      return launch<16>(xb, x_row_bytes, ob, out_row_bytes, w, K, R, mk,
                        jobs, J, max_ps, s);
    case 32:
      return launch<32>(xb, x_row_bytes, ob, out_row_bytes, w, K, R, mk,
                        jobs, J, max_ps, s);
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
