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
// Design: a block owns a run of output rows. It stages their ids once, clamped, in
// shared memory with one coalesced read (negative and out-of-range ids clamp, they do
// not wrap). Rows move as raw words of the widest unit their byte width and both base
// pointers allow: 16 bytes when W * elem_bytes % 16 == 0 and both pointers are
// 16-byte aligned (checked at launch, never assumed), else 8, 4 or 2 bytes. So the
// result is byte-identical to the plain version. Narrow rows (fewer than 32 units)
// are walked as the block's flat output [rows x units], each thread with kPerThread
// independent units in flight and 32-bit index math (a multiply-shift for / units);
// wide rows go a warp per row, lanes over units. TMA is not the tool: a tensor-map copy
// moves boxes of 16-byte multiples, and the slice's rows are 68 bytes at scattered
// addresses.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;                          // units in flight per thread (narrow)
constexpr int kNarrowUnits = kThreads * kPerThread;    // units a narrow block moves: < 2**11
constexpr int kWideRows = 32;                          // rows a wide block moves
constexpr int kWideAhead = 4;                          // units in flight per lane (wide)
constexpr int kShift = 16;                             // e * magic >> kShift == e / units

__device__ __forceinline__ int clamp_row(int r, long long R) {
  return r < 0 ? 0 : (r >= R ? static_cast<int>(R - 1) : r);
}

// units < 32, rows_per_block * units <= kNarrowUnits. magic = ceil(2**16 / units)
// gives floor(e / units) exactly for e < 2**11: e * (magic * units - 2**16) < 2**16.
template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_rows_narrow_kernel(const U* __restrict__ table, const int* __restrict__ idx,
                          U* __restrict__ out, long long R, int units, int magic,
                          int rows_per_block, long long N) {
  __shared__ int s_row[kNarrowUnits];
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(min(static_cast<long long>(rows_per_block), N - row0));
  for (int i = threadIdx.x; i < rows; i += kThreads) s_row[i] = clamp_row(idx[row0 + i], R);
  __syncthreads();
  const int total = rows * units;
  U v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = static_cast<int>(threadIdx.x) + j * kThreads;
    if (e < total) {
      const int i = (e * magic) >> kShift;
      v[j] = table[static_cast<long long>(s_row[i]) * units + (e - i * units)];
    }
  }
  U* dst = out + row0 * units;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = static_cast<int>(threadIdx.x) + j * kThreads;
    if (e < total) dst[e] = v[j];
  }
}

// units >= 32: a warp per row, lanes over its units, kWideAhead units in flight.
template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_rows_wide_kernel(const U* __restrict__ table, const int* __restrict__ idx,
                        U* __restrict__ out, long long R, long long units, long long N) {
  __shared__ int s_row[kWideRows];
  const long long row0 = static_cast<long long>(blockIdx.x) * kWideRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kWideRows), N - row0));
  if (static_cast<int>(threadIdx.x) < rows)
    s_row[threadIdx.x] = clamp_row(idx[row0 + threadIdx.x], R);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x / 32; i < rows; i += kThreads / 32) {
    const U* src = table + static_cast<long long>(s_row[i]) * units;
    U* dst = out + (row0 + i) * units;
    for (long long w = lane; w < units; w += 32 * kWideAhead) {
      U v[kWideAhead];
#pragma unroll
      for (int j = 0; j < kWideAhead; ++j) {
        if (w + j * 32 < units) v[j] = src[w + j * 32];
      }
#pragma unroll
      for (int j = 0; j < kWideAhead; ++j) {
        if (w + j * 32 < units) dst[w + j * 32] = v[j];
      }
    }
  }
}

template <typename U>
int launch_gather(const void* table, const int* idx, void* out, long long R, long long units,
                  long long N, cudaStream_t stream) {
  const U* t = static_cast<const U*>(table);
  U* o = static_cast<U*>(out);
  if (units < 32) {
    const int u = static_cast<int>(units);
    const int rows_per_block = kNarrowUnits / u;
    const int magic = ((1 << kShift) + u - 1) / u;
    const long long blocks = (N + rows_per_block - 1) / rows_per_block;
    gather_rows_narrow_kernel<U><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        t, idx, o, R, u, magic, rows_per_block, N);
  } else {
    const long long blocks = (N + kWideRows - 1) / kWideRows;
    gather_rows_wide_kernel<U><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        t, idx, o, R, units, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [R, W] and out [N, W] of elem_bytes-wide elements (4: f32, 2: bf16), idx [N]
// int32, all contiguous on the current device; R > 0, N * W > 0, N < 2**31 * 32 (the
// wrapper checks). Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int harmony_gather_rows(const void* table, const int* idx, void* out, long long R,
                                   long long W, long long N, int elem_bytes,
                                   cudaStream_t stream) {
  if (R <= 0 || W <= 0 || N <= 0 || (elem_bytes != 4 && elem_bytes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row_bytes = W * elem_bytes;
  const uintptr_t both = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && both % 16 == 0)
    return launch_gather<uint4>(table, idx, out, R, row_bytes / 16, N, stream);
  if (row_bytes % 8 == 0 && both % 8 == 0)
    return launch_gather<uint2>(table, idx, out, R, row_bytes / 8, N, stream);
  if (row_bytes % 4 == 0 && both % 4 == 0)
    return launch_gather<uint32_t>(table, idx, out, R, row_bytes / 4, N, stream);
  return launch_gather<uint16_t>(table, idx, out, R, row_bytes / 2, N, stream);
}
