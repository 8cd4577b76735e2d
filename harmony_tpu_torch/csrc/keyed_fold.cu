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
// Contract: every output element is the left-to-right f32 sum 0 + x[i0] + x[i1] + ...
// over the ids that hit its row, in index order: the TPU fold's sequential order
// (sparse.py:117-121) and the order of a sequential scatter-add, so the result is the
// same bits as the CPU's index_add_. No float atomics. K3's one-hot product multiplies
// each weight by exactly 1.0, so its f32 fused multiply-add is this f32 add; nothing
// runs in TF32. bf16 and f16 weights are widened to f32 before the add.
//
// What bounds it: bytes. At the Wide&Deep slice shape (N = 67,480 rows of W = 17,
// num_rows = 102,144) the function reads N * (W + 1) * 4 bytes and writes
// num_rows * W * 4 bytes, about 11.8 MB: 3.5 us at 3.35 TB/s. A one-pass design that
// owns a tile of destination rows per block must find that tile's ids among all N,
// and re-reading all ids in every block (the first version) made the fold a chain of
// short, latency-bound passes. So the ids are bucketed by destination tile first, a
// stable counting sort written here, in two kernels, each named keyed_fold_*:
//   (a) bucket: one warp per chunk of ids sorts its chunk stably by tile: it counts the
//               in-range ids per tile (integer atomics: exact in any order), scans the
//               counts into each tile's segment of the chunk, and walks the ids again
//               in index order, writing (position, local row) at the segment's cursor
//               plus its rank among the warp's 32 ids (__match_any_sync and the ballot
//               prefix);
//   (b) rows:   a block per tile reads the tile's segment of every chunk in chunk
//               order, so its list is in index order, counts it by local row, and one
//               warp places the entries stably by row (__match_any_sync again) while
//               the other warps gather the listed rows of x into shared memory; then
//               every thread owns (row, column) elements of the tile's output, adds its
//               run in order and writes the element, so rows no id hit get 0 and the
//               tile's output is written fully coalesced at any width. A tile whose
//               list or rows of x do not fit shared memory (heavy duplicates, one hot
//               row) reads them from device memory instead, kAhead rows ahead of the
//               dependent adds.
// The library owns the geometry (fold_geometry below): the wrapper asks
// harmony_fold_scratch_ints for the size of the int32 scratch buffer it allocates, and
// the library allocates nothing.
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kTileRows = 512;      // destination rows a tile covers
constexpr int kTileShift = 9;       // log2(kTileRows)
constexpr int kBucketWarps = 4;    // warps of a bucket block (its cursors in shared memory)
constexpr int kIdsAhead = 4;       // batches of 32 ids a bucket warp loads ahead
constexpr int kPlaceAhead = 8;      // batches of 32 entries the placing warp loads ahead
constexpr int kSmemTiles = 8192;    // above this many tiles the bucket's cursors stay global
constexpr int kListCap = 2048;      // a tile list this long or shorter is placed in shared memory
constexpr int kXCap = 12288;        // floats of x a tile stages in shared memory (48 KB)
constexpr int kAhead = 16;          // rows of x a thread loads ahead of its adds (unstaged)
constexpr int kChunkIds = 512;      // ids a chunk takes, unless the count matrix would outgrow:
constexpr long long kMaxCounts = 1LL << 22;  // the [tiles x chunks] int32 count matrix's cap
constexpr long long kMaxWidth = 1LL << 21;  // kTileRows * W must fit an int
constexpr long long kMaxIds = (1LL << 31) - (1LL << 16);  // positions + a batch fit an int
constexpr long long kMaxRows = 1LL << 30;
static_assert(kTileRows == 1 << kTileShift, "kTileShift");

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x % 32)) - 1u;
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// Exclusive scan of one int per thread over a block of kWarps warps; returns the
// thread's exclusive prefix and sets *total. warp_sums holds kWarps ints.
template <int kWarps>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  static_assert(kWarps <= 32, "one warp scans the warp sums");
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int incl = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_sums[lane] : 0;
    const int wincl = warp_inclusive_scan(w);
    __syncwarp();
    if (lane < kWarps) warp_sums[lane] = wincl - w;
    if (lane == 31) warp_sums[kWarps] = wincl;
  }
  __syncthreads();
  const int out = warp_sums[warp] + incl - v;
  *total = warp_sums[kWarps];
  __syncthreads();  // warp_sums may be reused at once
  return out;
}

// (a) a block per chunk of ids: a stable counting sort of the chunk by destination
// tile. The chunk splits into kWarps parts, in order, one a warp. Pass 1: each warp
// counts its part's in-range ids per tile (integer atomics: exact in any order).
// Then, per tile, each warp's cursor starts after the tile's earlier segments of the
// chunk (an exclusive scan over the tiles) and the earlier warps' ids of that tile.
// Pass 2: each warp walks its ids again in index order and writes (position, local
// row) at its cursor plus its rank among the warp's 32 ids (__match_any_sync and the
// ballot prefix). counts[t * C + c] and ends[t * C + c] say where chunk c's segment of
// tile t lies in local[c * chunk_ids ...]. kWarps = 4 keeps the cursors in shared
// memory (num_tiles <= kSmemTiles); kWarps = 1 keeps them in ends' own column, for
// tables too tall for that. Chunk 0 also resets the rows kernel's allocator.
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
keyed_fold_bucket_kernel(const int* __restrict__ idx, int* __restrict__ counts,
                         int* __restrict__ ends, int2* __restrict__ local,
                         unsigned* __restrict__ alloc, int N, int num_rows, int num_tiles,
                         int chunk_ids) {
  extern __shared__ int s_cursor[];  // kWarps > 1: [kWarps][num_tiles]
  __shared__ int warp_sums[kWarps + 1];
  constexpr bool kShared = kWarps > 1;
  const int c = blockIdx.x;
  const int C = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int w = tid / 32;
  int* cursor = kShared ? s_cursor + w * num_tiles : ends + c;  // this warp's, per tile
  const int stride = kShared ? 1 : C;
  if (c == 0 && tid == 0) *alloc = 0u;
  for (int t = lane; t < num_tiles; t += 32) cursor[t * stride] = 0;
  __syncthreads();
  const int part = chunk_ids / kWarps;
  const int begin = c * chunk_ids + w * part;
  const int end = min(N, begin + part);
  for (int base = begin; base < end; base += 32 * kIdsAhead) {  // pass 1: counts
    int ids[kIdsAhead];
#pragma unroll
    for (int j = 0; j < kIdsAhead; ++j) {
      const int i = base + j * 32 + lane;
      ids[j] = i < end ? idx[i] : -1;
    }
#pragma unroll
    for (int j = 0; j < kIdsAhead; ++j) {
      if (ids[j] >= 0 && ids[j] < num_rows) {
        atomicAdd(&cursor[(ids[j] >> kTileShift) * stride], 1);
      }
    }
  }
  __syncthreads();
  int carry = 0;  // per tile: the chunk's total, its segment, each warp's cursor
  for (int t0 = 0; t0 < num_tiles; t0 += kWarps * 32) {
    const int t = t0 + tid;
    int total = 0;
    if (t < num_tiles) {
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        int* slot = (kShared ? s_cursor + k * num_tiles : cursor) + t * stride;
        const int v = *slot;
        *slot = total;
        total += v;
      }
    }
    int round_total;
    const int start = carry + block_exclusive_scan<kWarps>(total, warp_sums, &round_total);
    if (t < num_tiles) {
      counts[t * C + c] = total;
      if (kShared) ends[t * C + c] = start + total;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        (kShared ? s_cursor + k * num_tiles : cursor)[t * stride] += start;
      }
    }
    carry += round_total;
  }
  __syncthreads();
  int2* seg = local + static_cast<long long>(c) * chunk_ids;
  for (int base = begin; base < end; base += 32 * kIdsAhead) {  // pass 2: placement
    int ids[kIdsAhead];
#pragma unroll
    for (int j = 0; j < kIdsAhead; ++j) {
      const int i = base + j * 32 + lane;
      ids[j] = i < end ? idx[i] : -1;
    }
#pragma unroll
    for (int j = 0; j < kIdsAhead; ++j) {
      const int id = ids[j];
      const bool ok = id >= 0 && id < num_rows;
      const int tile = id >> kTileShift;
      const unsigned same = __match_any_sync(0xffffffffu, ok ? tile : -1 - lane);
      const int rank = __popc(same & lanes_below());
      const int at = ok ? cursor[tile * stride] : 0;
      __syncwarp();
      if (ok && rank == 0) cursor[tile * stride] = at + __popc(same);
      __syncwarp();
      if (ok) seg[at + rank] = make_int2(base + j * 32 + lane, id - (tile << kTileShift));
    }
  }
}

// Copies chunk c's segment of the tile (v entries ending at `end` in local) to
// list[at ...] and counts its local rows.
__device__ __forceinline__ void copy_segment(const int2* __restrict__ local, int c,
                                             int chunk_ids, int v, int end, int2* list,
                                             int at, int* row_counts) {
  constexpr int kInFlight = 4;
  const int2* src = local + static_cast<long long>(c) * chunk_ids + end - v;
  for (int k = 0; k < v; k += kInFlight) {
    int2 e[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      if (k + j < v) e[j] = src[k + j];
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      if (k + j < v) {
        list[at + k + j] = e[j];
        atomicAdd(&row_counts[e[j].y], 1);
      }
    }
  }
}

// (b) a block per tile: gather the tile's list from the chunks' segments (in chunk
// order, so in index order), sort it stably by local row, then fold each (row,
// column) element of the tile in index order. A list longer than kListCap goes to
// glist at a region the block takes from the allocator (any region will do: the
// order within it is fixed).
template <typename T>
__global__ void __launch_bounds__(kTileRows)
keyed_fold_rows_kernel(const T* __restrict__ x, const int* __restrict__ counts,
                       const int* __restrict__ ends, const int2* __restrict__ local,
                       int2* __restrict__ glist, int* __restrict__ sorted,
                       unsigned* __restrict__ alloc, float* __restrict__ out, int W,
                       int num_rows, int C, int chunk_ids) {
  __shared__ int s_cursor[kTileRows];     // per local row: its count, then its cursor
  __shared__ int s_start[kTileRows + 1];  // per local row: where its run starts
  __shared__ int2 s_list[kListCap];
  __shared__ int s_sorted[kListCap];
  __shared__ int warp_sums[kTileRows / 32 + 1];
  __shared__ int s_region;
  extern __shared__ float s_x[];          // kXCap: the listed rows of x, in list order
  const int t = blockIdx.x;
  const int row0 = t * kTileRows;
  const int rows = min(kTileRows, num_rows - row0);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int* count_row = counts + static_cast<long long>(t) * C;
  const int* end_row = ends + static_cast<long long>(t) * C;

  s_cursor[tid] = 0;
  // the list's length, and each chunk's place in it (one chunk a thread, or rounds)
  int v = 0, at = 0, n = 0, v_end = 0;
  if (C <= kTileRows) {
    v = tid < C ? count_row[tid] : 0;
    v_end = tid < C ? end_row[tid] : 0;
    at = block_exclusive_scan<kTileRows / 32>(v, warp_sums, &n);
  } else {
    for (int c0 = 0; c0 < C; c0 += kTileRows) {
      int total;
      block_exclusive_scan<kTileRows / 32>(c0 + tid < C ? count_row[c0 + tid] : 0, warp_sums,
                                           &total);
      n += total;
    }
  }
  const bool fits = n <= kListCap;
  const bool staged = fits && W <= kXCap && n * W <= kXCap;
  if (!fits) {
    if (tid == 0) s_region = static_cast<int>(atomicAdd(alloc, static_cast<unsigned>(n)));
    __syncthreads();
  }
  const int region = fits ? 0 : s_region;
  int2* list_w = fits ? s_list : glist + region;
  if (C <= kTileRows) {
    if (tid < C) copy_segment(local, tid, chunk_ids, v, v_end, list_w, at, s_cursor);
  } else {
    int carry = 0;
    for (int c0 = 0; c0 < C; c0 += kTileRows) {
      const int c = c0 + tid;
      const int cv = c < C ? count_row[c] : 0;
      int total;
      const int cat = carry + block_exclusive_scan<kTileRows / 32>(cv, warp_sums, &total);
      if (c < C) copy_segment(local, c, chunk_ids, cv, end_row[c], list_w, cat, s_cursor);
      carry += total;
    }
  }
  __syncthreads();
  {
    const int v = s_cursor[tid];
    int total;
    const int start = block_exclusive_scan<kTileRows / 32>(v, warp_sums, &total);
    s_start[tid] = start;
    s_cursor[tid] = start;
    if (tid == 0) s_start[kTileRows] = total;
  }
  __syncthreads();
  // Each thread owns the elements e = tid + k * kTileRows of the tile's [rows x W]
  // output; (r, col) of the next one follow without a division.
  const int step_r = kTileRows / W;
  const int step_col = kTileRows - step_r * W;
  float* out_tile = out + static_cast<long long>(row0) * W;
  {  // rows no id hit are 0: written now, while the list is placed and x gathered
    int r = tid / W, col = tid - r * W;
    for (int e = tid; e < rows * W; e += kTileRows) {
      if (s_start[r] == s_start[r + 1]) out_tile[e] = 0.0f;
      r += step_r;
      col += step_col;
      if (col >= W) col -= W, ++r;
    }
  }
  const int2* list = list_w;
  int* dst = fits ? s_sorted : sorted + region;
  if (tid < 32) {  // stable placement by local row, 32 entries at a time, in list order
    for (int base = 0; base < n; base += 32 * kPlaceAhead) {
      int2 e[kPlaceAhead];
#pragma unroll
      for (int j = 0; j < kPlaceAhead; ++j) {
        const int k = base + j * 32 + lane;
        e[j] = k < n ? list[k] : make_int2(-1, kTileRows + lane);
      }
#pragma unroll
      for (int j = 0; j < kPlaceAhead; ++j) {
        const bool ok = e[j].x >= 0;
        const unsigned same = __match_any_sync(0xffffffffu, e[j].y);
        const int rank = __popc(same & lanes_below());
        const int at = ok ? s_cursor[e[j].y] : 0;
        __syncwarp();
        if (ok && rank == 0) s_cursor[e[j].y] = at + __popc(same);
        __syncwarp();
        // staged: the entry's index in the list (its row of s_x); else its position
        if (ok) dst[at + rank] = staged ? base + j * 32 + lane : e[j].x;
      }
    }
  } else if (staged) {  // the other warps gather the listed rows of x meanwhile
    constexpr int kGather = kTileRows - 32;
    constexpr int kInFlight = 4;
    for (int f0 = tid - 32; f0 < n * W; f0 += kGather * kInFlight) {
      float v[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int f = f0 + j * kGather;
        if (f < n * W) {
          const int k = f / W;
          v[j] = to_float(x[static_cast<long long>(s_list[k].x) * W + (f - k * W)]);
        }
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        if (f0 + j * kGather < n * W) s_x[f0 + j * kGather] = v[j];
      }
    }
  }
  __syncthreads();
  const int* pos = fits ? s_sorted : sorted + region;
  int r = tid / W, col = tid - r * W;
  for (int e = tid; e < rows * W; e += kTileRows) {
    const int lo = s_start[r];
    const int hi = s_start[r + 1];
    if (lo < hi) {
      float acc = 0.0f;
      if (staged) {
        for (int k = lo; k < hi; ++k) acc += s_x[pos[k] * W + col];
      } else {
        for (int k = lo; k < hi; k += kAhead) {
          float v[kAhead];
#pragma unroll
          for (int j = 0; j < kAhead; ++j) {
            v[j] = k + j < hi ? to_float(x[static_cast<long long>(pos[k + j]) * W + col])
                              : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < kAhead; ++j) {
            if (k + j < hi) acc += v[j];  // in index order; adds no padding
          }
        }
      }
      out_tile[e] = acc;
    }
    r += step_r;
    col += step_col;
    if (col >= W) col -= W, ++r;
  }
}

struct Geometry {
  int tiles;               // destination tiles of kTileRows rows
  int chunk_ids;           // ids of a chunk, a multiple of 32 * kBucketWarps
  int chunks;
  long long scratch_ints;  // 0: a fold the kernels do not take
};

// Chunks of kChunkIds ids, grown in multiples of 32 * kBucketWarps only where tiles x
// chunks would pass kMaxCounts. Scratch (int32): local [chunks x chunk_ids] int2 |
// glist [N] int2 | sorted [N] | counts [tiles x chunks] | ends [tiles x chunks] | alloc.
Geometry fold_geometry(long long N, long long W, long long num_rows) {
  if (N <= 0 || N > kMaxIds || W <= 0 || W > kMaxWidth || num_rows <= 0 ||
      num_rows > kMaxRows)
    return Geometry{0, 0, 0, 0};
  constexpr long long kUnit = 32 * kBucketWarps;
  const long long tiles = (num_rows + kTileRows - 1) / kTileRows;
  const long long max_chunks = kMaxCounts / tiles > 1 ? kMaxCounts / tiles : 1;
  long long chunk_ids = kChunkIds;
  if ((N + chunk_ids - 1) / chunk_ids > max_chunks) {
    chunk_ids = ((N + max_chunks - 1) / max_chunks + kUnit - 1) / kUnit * kUnit;
  }
  const long long chunks = (N + chunk_ids - 1) / chunk_ids;
  const long long ints = 2 * chunks * chunk_ids + 3 * N + 2 * tiles * chunks + 1;
  return Geometry{static_cast<int>(tiles), static_cast<int>(chunk_ids),
                  static_cast<int>(chunks), ints};
}

// A kernel's dynamic shared memory above 48 KB is an attribute of one device: set it on
// the first launch on each device (on every launch past the 64th device).
cudaError_t allow_dynamic_shared(const void* kernel, int bytes,
                                 std::atomic<unsigned long long>& set_on) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (set_on.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) set_on.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T>
int launch_fold(const T* x, const int* idx, float* out, long long N, long long W,
                long long num_rows, int* scratch, cudaStream_t stream) {
  const Geometry g = fold_geometry(N, W, num_rows);
  if (g.scratch_ints == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(g.tiles) * g.chunks;
  int2* local = reinterpret_cast<int2*>(scratch);
  int2* glist = local + static_cast<long long>(g.chunks) * g.chunk_ids;
  int* sorted = reinterpret_cast<int*>(glist + N);
  int* counts = sorted + N;
  int* ends = counts + M;
  unsigned* alloc = reinterpret_cast<unsigned*>(ends + M);
  const int n = static_cast<int>(N), rows = static_cast<int>(num_rows);
  static std::atomic<unsigned long long> rows_set{0}, bucket_set{0};
  cudaError_t err = allow_dynamic_shared(
      reinterpret_cast<const void*>(keyed_fold_rows_kernel<T>), kXCap * 4, rows_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g.tiles <= kSmemTiles) {
    err = allow_dynamic_shared(
        reinterpret_cast<const void*>(keyed_fold_bucket_kernel<kBucketWarps>),
        kBucketWarps * kSmemTiles * 4, bucket_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    keyed_fold_bucket_kernel<kBucketWarps>
        <<<g.chunks, kBucketWarps * 32, static_cast<size_t>(kBucketWarps) * g.tiles * 4,
           stream>>>(idx, counts, ends, local, alloc, n, rows, g.tiles, g.chunk_ids);
  } else {
    keyed_fold_bucket_kernel<1><<<g.chunks, 32, 0, stream>>>(idx, counts, ends, local, alloc,
                                                             n, rows, g.tiles, g.chunk_ids);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  keyed_fold_rows_kernel<T><<<g.tiles, kTileRows, kXCap * 4, stream>>>(
      x, counts, ends, local, glist, sorted, alloc, out, static_cast<int>(W), rows, g.chunks,
      g.chunk_ids);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The int32s of scratch a fold of N ids of width W into num_rows rows takes, into
// *scratch_ints; cudaErrorInvalidValue, as an int, for a fold the kernels do not take
// (N or W or num_rows <= 0, N > 2**31 - 2**16, W > 2**21, num_rows > 2**30).
extern "C" int harmony_fold_scratch_ints(long long N, long long W, long long num_rows,
                                         long long* scratch_ints) {
  *scratch_ints = fold_geometry(N, W, num_rows).scratch_ints;
  return static_cast<int>(*scratch_ints == 0 ? cudaErrorInvalidValue : cudaSuccess);
}

// K2: deltas [N, W] f32, idx [N] int32 -> out [num_rows, W] f32, all contiguous on the
// current device; scratch holds harmony_fold_scratch_ints's count of int32s, 8-byte
// aligned. Launches two kernels on `stream`; returns the first cudaGetLastError() that
// is not cudaSuccess, as an int (cudaErrorInvalidValue for sizes it does not take).
extern "C" int harmony_segment_sum_rows(const float* deltas, const int* idx, float* out,
                                        long long N, long long W, long long num_rows,
                                        int* scratch, cudaStream_t stream) {
  return launch_fold<float>(deltas, idx, out, N, W, num_rows, scratch, stream);
}

// K3: weights [N, W] of dtype_code (0: f32, 1: bf16, 2: f16), ids [N] int32 ->
// out [num_bins, W] f32. Same contract as harmony_segment_sum_rows.
extern "C" int harmony_weighted_histogram(const void* weights, int dtype_code, const int* ids,
                                          float* out, long long N, long long W,
                                          long long num_bins, int* scratch,
                                          cudaStream_t stream) {
  switch (dtype_code) {
    case 0:
      return launch_fold(static_cast<const float*>(weights), ids, out, N, W, num_bins, scratch,
                         stream);
    case 1:
      return launch_fold(static_cast<const __nv_bfloat16*>(weights), ids, out, N, W, num_bins,
                         scratch, stream);
    case 2:
      return launch_fold(static_cast<const __half*>(weights), ids, out, N, W, num_bins,
                         scratch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
