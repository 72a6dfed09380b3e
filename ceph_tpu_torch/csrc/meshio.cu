// Scrub digest of byte planes on Hopper:
//   D = (sum over every byte b of (b * 2654435761 mod 2^32)) mod 2^32.
//
// Replaces the digest step of the XLA mesh program
// ceph_tpu/tpu/meshio.py:216 (scrub_digest), whose step (:227-232) sums
// p.astype(uint32) * C over each device's column slice and psums the
// partials over the mesh's "stripe" axis.  MeshCompute.scrub_digest
// (ceph_tpu_torch/gpu/meshio.py) launches this kernel once per stripe row
// of its grid, on that row's column slice, and adds the partial digests
// mod 2^32 (the psum).
//
// Arithmetic: the multiply by C distributes over the sum mod 2^32,
//   sum_b (b * C mod 2^32) = C * (sum_b b mod 2^32)   (mod 2^32),
// so the kernel is a byte sum in uint32 that wraps, then one multiply.  A
// wrapping uint32 sum is exact mod 2^32 in any order: block order and
// atomics cannot change the result.
//
// Bound: bytes, rows * n read once ([12, 512 Ki], the mesh phase's
// shards of one object: 6.3 MB, 0.0019 ms at 3.35 TB/s).  Design:
// - a row is an unaligned head (< 16 bytes), 16-byte vectors and a tail
//   (< 16 bytes), so any base address and any row pitch work (a column
//   slice of a batch included); block x 0 of a row takes its head and
//   tail bytes;
// - a thread loads kUnroll 16-byte vectors (ld.global.nc) before it sums
//   any, to keep bytes in flight, and sums each word's four bytes with
//   one __dp4a against 0x01010101;
// - the warp sums by __shfl_xor_sync, the block through shared memory,
//   and the block's sum joins the total with one atomicAdd; the last
//   block to finish (a ticket taken after __threadfence) multiplies the
//   total by C;
// - grid: x along a row (capped so the whole grid is about kMaxBlocks
//   blocks), y over rows (looped past 65535).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kMul = 2654435761u;  // the reference's digest constant
constexpr uint32_t kOnes = 0x01010101u;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kMaxBlocks = 2048;
constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ uint32_t vec_sum(const uint4& q, uint32_t s) {
  s = __dp4a(q.x, kOnes, s);
  s = __dp4a(q.y, kOnes, s);
  s = __dp4a(q.z, kOnes, s);
  return __dp4a(q.w, kOnes, s);
}

__global__ void __launch_bounds__(kThreads)
mesh_digest_kernel(const uint8_t* __restrict__ x, int64_t pitch,
                   int64_t rows, int64_t n, uint32_t* acc,
                   uint32_t* ticket) {
  uint32_t s = 0;
  const int64_t stride = int64_t{gridDim.x} * kThreads;
  const int64_t t0 = int64_t{blockIdx.x} * kThreads + threadIdx.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint8_t* row = x + r * pitch;
    const int64_t lead =
        (16 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(row) & 15)) &
        15;
    const int64_t head = lead < n ? lead : n;
    const int64_t nvec = (n - head) >> 4;
    const uint4* v = reinterpret_cast<const uint4*>(row + head);
    int64_t i = t0;
    for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
      uint4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) q[u] = __ldg(v + i + u * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s = vec_sum(q[u], s);
    }
    for (; i < nvec; i += stride) s = vec_sum(__ldg(v + i), s);
    if (blockIdx.x == 0) {
      const int64_t tail = head + (nvec << 4);
      const int t = threadIdx.x;
      if (t < head) {
        s += row[t];
      } else if (t >= 16 && t < 32 && tail + (t - 16) < n) {
        s += row[tail + (t - 16)];
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp != 0) return;
  s = lane < kThreads / 32 ? warp_sums[lane] : 0u;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane != 0) return;
  atomicAdd(acc, s);
  __threadfence();
  if (atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1) {
    // every other block's atomicAdd happened before its ticket
    *acc = atomicAdd(acc, 0u) * kMul;
  }
}

}  // namespace

extern "C" {

// x: rows of n bytes at row pitch `pitch` (any alignment); out: 16 bytes
// of device memory, zeroed here, then word 0 = the digest (words 0-1 read
// as one int64 give it in [0, 2^32)) and word 2 = the ticket counter.  A
// memset and one launch on `stream`; returns cudaGetLastError().
int mesh_digest_launch(const void* x, int64_t pitch, int64_t rows,
                       int64_t n, void* out, void* stream) {
  if (rows < 0 || n < 0 || (rows > 1 && pitch < n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, 16, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  const int64_t gy = rows < kMaxGridY ? rows : kMaxGridY;
  const int64_t want = ((n >> 4) + kThreads * kUnroll - 1) /
                       (kThreads * kUnroll);
  const int64_t cap = kMaxBlocks / gy > 1 ? kMaxBlocks / gy : 1;
  const int64_t gx = want < 1 ? 1 : (want < cap ? want : cap);
  uint32_t* words = static_cast<uint32_t*>(out);
  mesh_digest_kernel<<<dim3(static_cast<unsigned>(gx),
                            static_cast<unsigned>(gy)),
                       kThreads, 0, st>>>(
      static_cast<const uint8_t*>(x), pitch, rows, n, words, words + 2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
