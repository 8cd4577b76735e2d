// K2 segment_sum_rows and K3 weighted_histogram for Hopper (sm_90a): one keyed fold,
//   out[k, :] = sum over i with idx[i] == k of x[i, :]   ->  [num_rows, W] f32,
// where ids < 0 or >= num_rows add nothing.
//
// Replaces harmony_tpu/ops/sparse.py:146 segment_sum_rows (Pallas body
// _make_fold_kernel, sparse.py:115; pallas_call sparse.py:191), which keeps the whole
// accumulator resident in VMEM and folds the rows in index order, and
// harmony_tpu/ops/histogram.py:94 weighted_histogram (Pallas body _hist_kernel,
// histogram.py:59; pallas_call histogram.py:136), which builds a one-hot tile and
// multiplies it with the weights on the MXU in f32 at Precision.HIGHEST. Two entry
// points share the routine below; each has its own wrapper and launch count.
//
// Determinism: no float atomicAdd. Each block owns a tile of destination rows (and of
// columns, for rows wider than kMaxColTile) and holds its accumulator in shared
// memory; each warp of the block owns a slice of those rows. The block reads the ids
// once, kChunk at a time: each warp compacts, in index order, the ids of its own
// stretch that fall in the block's rows into a list in shared memory. Every warp then
// walks the lists in index order and folds the entries of its own slice. So every
// output element is the left-to-right f32 sum 0 + x[i0] + x[i1] + ... of its rows:
// the TPU fold's sequential order (sparse.py:117-121) and the order of a sequential
// scatter-add. K3's one-hot product multiplies each weight by exactly 1.0, so its f32
// fused multiply-add is this f32 add; nothing runs in TF32.
//
// What bounds it: bytes, at the Wide&Deep slice shape (N = 67,480 rows of W = 17,
// num_rows = 102,144): the function must read N * (W + 1) * 4 bytes and write
// num_rows * W * 4 bytes, about 11.8 MB. The price of this design is that every block
// re-reads all N ids (num_blocks * N * 4 bytes, from L2 after the first block) and
// walks the lists of matches; PERF.md carries its time beside the bound.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIdsPerWarp = 256;                // ids one warp compacts per pass
constexpr int kChunk = kWarps * kIdsPerWarp;    // ids the block takes per pass
constexpr int kPosBits = 11;                    // a position in the chunk: < 2048
constexpr int kAccBytes = 39 * 1024;            // accumulator; with the lists, < 48 KB
constexpr int kMaxColTile = 256;                // columns a block folds at once
static_assert(kChunk <= (1 << kPosBits), "chunk positions must fit kPosBits");

template <typename T>
__global__ void keyed_fold_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                                  float* __restrict__ out, long long N, int W, int num_rows,
                                  int rows_per_block, int col_tile) {
  extern __shared__ int smem[];
  int* lists = smem;                        // per warp: kIdsPerWarp (local row, position)
  int* counts = lists + kChunk;             // per warp: entries in its list
  float* acc = reinterpret_cast<float*>(counts + kWarps);

  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, num_rows - row0);
  const int col0 = blockIdx.y * col_tile;
  const int cols = min(col_tile, W - col0);
  const int rows_per_warp = rows_per_block / kWarps;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned lanes_below = (1u << lane) - 1u;
  // this warp's slice of the block's rows, as local row numbers [lo, hi)
  const int lo = warp * rows_per_warp;
  const int hi = lo + rows_per_warp;
  int* my_list = lists + warp * kIdsPerWarp;

  for (int e = threadIdx.x; e < rows_per_block * cols; e += kThreads) acc[e] = 0.0f;

  for (long long base = 0; base < N; base += kChunk) {
    // 1. compact this warp's stretch of ids, in index order: lanes in increasing order
    //    are ids in increasing order, and the ballot's prefix count is the slot
    int count = 0;
    for (int j = 0; j < kIdsPerWarp; j += 32) {
      const int pos = warp * kIdsPerWarp + j + lane;
      int local = -1;
      if (base + pos < N) {
        const int id = idx[base + pos];
        if (id >= row0 && id - row0 < rows) local = id - row0;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, local >= 0);
      if (local >= 0) my_list[count + __popc(mask & lanes_below)] = (local << kPosBits) | pos;
      count += __popc(mask);
    }
    if (lane == 0) counts[warp] = count;
    __syncthreads();  // every list is complete (and acc zeroed, on the first pass)
    // 2. walk the lists in index order; a warp folds the entries of its own slice. The
    //    branch is uniform across the warp: all lanes read the same entry.
    for (int w = 0; w < kWarps; ++w) {
      const int* list = lists + w * kIdsPerWarp;
      const int n = counts[w];
      for (int k = 0; k < n; ++k) {
        const int entry = list[k];
        const int l = entry >> kPosBits;
        if (l < lo || l >= hi) continue;
        const T* row = x + (base + (entry & ((1 << kPosBits) - 1))) * static_cast<long long>(W)
                       + col0;
        float* a = acc + l * cols;
        for (int c = lane; c < cols; c += 32) a[c] += to_float(row[c]);
      }
    }
    __syncthreads();  // the lists are consumed before the next pass rewrites them
  }
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols;
    out[static_cast<long long>(row0 + r) * W + col0 + (e - r * cols)] = acc[e];
  }
}

template <typename T>
int launch_fold(const T* x, const int* idx, float* out, long long N, long long W,
                long long num_rows, cudaStream_t stream) {
  if (W <= 0 || W > (1LL << 30) || num_rows <= 0 || num_rows > (1LL << 30) || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int col_tile = static_cast<int>(W < kMaxColTile ? W : kMaxColTile);
  int rows_per_block = kAccBytes / (col_tile * 4) / kWarps * kWarps;
  if (rows_per_block < kWarps) rows_per_block = kWarps;
  const dim3 grid(static_cast<unsigned>((num_rows + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned>((W + col_tile - 1) / col_tile));
  const size_t smem = (kChunk + kWarps + static_cast<size_t>(rows_per_block) * col_tile) * 4;
  keyed_fold_kernel<T><<<grid, kThreads, smem, stream>>>(
      x, idx, out, N, static_cast<int>(W), static_cast<int>(num_rows), rows_per_block,
      col_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: deltas [N, W] f32, idx [N] int32 -> out [num_rows, W] f32, all contiguous on the
// current device, N > 0 (the wrapper checks). Launches on `stream`; returns
// cudaGetLastError() as an int.
extern "C" int harmony_segment_sum_rows(const float* deltas, const int* idx, float* out,
                                        long long N, long long W, long long num_rows,
                                        cudaStream_t stream) {
  return launch_fold<float>(deltas, idx, out, N, W, num_rows, stream);
}

// K3: weights [N, W] of dtype_code (0: f32, 1: bf16, 2: f16), ids [N] int32 ->
// out [num_bins, W] f32. Same contract as harmony_segment_sum_rows.
extern "C" int harmony_weighted_histogram(const void* weights, int dtype_code, const int* ids,
                                          float* out, long long N, long long W,
                                          long long num_bins, cudaStream_t stream) {
  switch (dtype_code) {
    case 0:
      return launch_fold(static_cast<const float*>(weights), ids, out, N, W, num_bins, stream);
    case 1:
      return launch_fold(static_cast<const __nv_bfloat16*>(weights), ids, out, N, W, num_bins,
                         stream);
    case 2:
      return launch_fold(static_cast<const __half*>(weights), ids, out, N, W, num_bins, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
