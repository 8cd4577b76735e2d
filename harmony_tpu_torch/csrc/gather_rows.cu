// K1 gather_rows for Hopper (sm_90a): out[i, :] = table[clamp(idx[i], 0, R-1), :].
//
// Replaces harmony_tpu/ops/sparse.py:71 gather_rows, whose Pallas body is
// _gather_kernel (sparse.py:65) and whose pallas_call is at sparse.py:107. The TPU
// kernel moves one (1, W) row block per grid step through VMEM, with the ids
// scalar-prefetched so that the next row's copy overlaps this one, and runs only for
// W % 128 == 0.
//
// What bounds it here: bytes. The gather does no arithmetic. At the Wide&Deep slice
// shape (R = 102,144 rows of W = 17 f32, N = 67,480 ids) it reads the ids and the
// rows they name and writes N * W elements; the 6.9 MB table stays in the 50 MB L2
// between steps.
//
// Design: one thread per output element, in a grid-stride loop. Neighbouring threads
// write neighbouring output elements, so the output is written fully coalesced, and
// the W threads of one row read one contiguous stretch of the table: at W = 17 a row
// is a few threads, not a 128-lane block, and no shape gate is needed. Negative and
// out-of-range ids clamp inside the kernel (they do not wrap). Elements move as raw
// 4-byte (f32) or 2-byte (bf16) words, so the result is byte-identical to the plain
// version.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 32;  // a few waves on 132 SMs; the loop covers the rest

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                                   T* __restrict__ out, long long R, long long W,
                                   long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long i = e / W;
    const long long w = e - i * W;
    long long r = idx[i];
    r = r < 0 ? 0 : (r >= R ? R - 1 : r);
    out[e] = table[r * W + w];
  }
}

}  // namespace

// table [R, W] and out [N, W] of elem_bytes-wide elements (4: f32, 2: bf16), idx [N]
// int32, all contiguous on the current device; R > 0, N * W > 0 (the wrapper checks).
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int harmony_gather_rows(const void* table, const int* idx, void* out, long long R,
                                   long long W, long long N, int elem_bytes,
                                   cudaStream_t stream) {
  const long long total = N * W;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (elem_bytes == 4) {
    gather_rows_kernel<uint32_t><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(table), idx, static_cast<uint32_t*>(out), R, W, total);
  } else if (elem_bytes == 2) {
    gather_rows_kernel<uint16_t><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(table), idx, static_cast<uint16_t*>(out), R, W, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
