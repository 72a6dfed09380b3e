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
// from inits[j].  The XLA version first relaid the batch on the host into
// job-major rows (crc32c_device.py:176-187) because a per-lane offset cost
// a gather there; here it is one pointer add.  crc32c_lanes uses the same
// kernel with S = 1 and offs[j] = j*C.
//
// Arithmetic: slicing-by-8, the eight 256-entry uint32 tables built by each
// block into shared memory.  Bytes up to the first 8-byte boundary and the
// tail after the last whole 8-byte word go through the byte table T0
// (c' = T0[(c ^ b) & 0xff] ^ (c >> 8), a logical shift on uint32_t), the
// same update crc32c_device.py:104-111 applies to its tail; the words in
// between take one slicing-by-8 step each.  Both orders give the same CRC.
//
// Bound: one thread per row walks the row sequentially, so a batch with a
// few dozen rows of 512 KiB is latency-bound on one SM, far from the HBM
// bound of reading the batch once.  Splitting rows across threads and
// joining the parts with a CRC combine is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;

__global__ void __launch_bounds__(128)
crc32c_rows_kernel(const uint8_t* base, int64_t row_stride, int S,
                   const int64_t* meta, int64_t J, uint32_t* out) {
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

  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= J * S) return;
  const int64_t j = r / S;
  const int64_t s = r % S;
  const int64_t* offs = meta;
  const int64_t* lens = meta + J;
  const int64_t* inits = meta + 2 * J;
  const uint8_t* p = base + s * row_stride + offs[j];
  int64_t n = lens[j];
  uint32_t c = static_cast<uint32_t>(inits[j]) ^ 0xFFFFFFFFu;

  while (n > 0 && (reinterpret_cast<uintptr_t>(p) & 7u)) {
    c = T[0][(c ^ *p) & 0xFFu] ^ (c >> 8);
    ++p;
    --n;
  }
  const uint2* q = reinterpret_cast<const uint2*>(p);
  for (int64_t w = n >> 3; w > 0; --w) {
    const uint2 v = *q++;
    const uint32_t lo = c ^ v.x;  // bytes 0..3, little-endian
    const uint32_t hi = v.y;      // bytes 4..7
    c = T[7][lo & 0xFFu] ^ T[6][(lo >> 8) & 0xFFu] ^
        T[5][(lo >> 16) & 0xFFu] ^ T[4][lo >> 24] ^ T[3][hi & 0xFFu] ^
        T[2][(hi >> 8) & 0xFFu] ^ T[1][(hi >> 16) & 0xFFu] ^ T[0][hi >> 24];
  }
  p = reinterpret_cast<const uint8_t*>(q);
  for (n &= 7; n > 0; --n, ++p) c = T[0][(c ^ *p) & 0xFFu] ^ (c >> 8);
  out[r] = c ^ 0xFFFFFFFFu;
}

}  // namespace

extern "C" {

// meta: device int64 [3, J] = (column offset, length, init) per job.
// out: device uint32 [J * S], row r = j*S + s.  Returns cudaGetLastError().
int crc32c_rows_launch(const void* base, int64_t row_stride, int S,
                       const void* meta, int64_t J, void* out, void* stream) {
  if (S < 1 || J < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = J * S;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 128;
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  crc32c_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), row_stride, S,
      static_cast<const int64_t*>(meta), J, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
