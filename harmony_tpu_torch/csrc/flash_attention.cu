// Flash attention for Hopper (sm_90a): K4 forward, K5a backward dK/dV, K5b backward dQ.
//
// Replaces, in harmony_tpu/ops/attention.py:
//   K4  _flash_forward (attention.py:191), body _fa_kernel, pallas_call at :208;
//   K5a _flash_backward (:310), body _fa_bwd_dkv_kernel, pallas_call at :345;
//   K5b _flash_backward (:310), body _fa_bwd_dq_kernel, pallas_call at :367.
// Layout: q, o, dout, dq [BH, Sq, D] and k, v, dk, dv [BH, Sk, D], row-major, f32 or bf16
// (q, k and v share one type); lse and delta [BH, Sq] f32, stored compact (the TPU's
// lane-replicated copy, attention.py:30, is a TPU tiling detail).
//
// What they compute is the TPU kernels' arithmetic. Scores are f32 sums of the operands'
// products (bf16 products are exact in f32; f32 operands stay f32, never TF32), scaled after
// the product, with the finite -1e30 mask of _apply_causal_mask (row >= col). K4 walks the
// keys in tiles of the caller's block_k and rounds p to v's type at that tile's running
// maximum (attention.py:150-158), so p is rounded exactly where the TPU rounds it; the
// backward kernels recompute p = exp(s - lse) and round p and ds elementwise, which no
// tiling changes. Only the order of f32 additions differs from the plain versions.
//
// Design. On the TPU the kv (or q) axis is a sequential grid dimension that carries the
// softmax state or the gradient accumulator in VMEM from one grid step to the next. Here one
// block of 256 threads owns 64 rows of the output (q rows for K4 and K5b, kv rows for K5a)
// and loops over the other axis itself; its accumulators stay in registers, a 4 x (D/16)
// micro-tile per thread, and each output element is written once (no float atomics). The
// other operand streams through shared memory 64 rows at a time, converted to f32, with an
// odd row stride (D + 1) so the 16 threads that read 16 rows at one column hit 16 banks.
// Products are scalar f32 FMAs. With causal masking K4 and K5b stop at the last kv tile that
// reaches a row of the block and K5a skips q tiles that lie wholly above its keys: those
// tiles contribute exactly zero on the TPU too (p = exp(-1e30 - m) = 0, alpha = 1).
//
// What bounds them here: at the LM's shape (BH = 256, S = 1024, D = 64, bf16) the least time
// is set by the tensor cores' operations and by the bytes about equally (~0.04 ms for K4).
// These kernels use no tensor cores: scalar FMAs from shared memory reach a fraction of the
// 67 TFLOP/s f32 rate, so they are bound by instruction throughput and shared-memory reads, far
// above that bound. They are the simple, right first version; wgmma, TMA and the ring of
// tiles are later work.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // 8 warps: a 16 x 16 grid over one 64 x 64 tile
constexpr int kTile = 64;          // rows a block owns; rows of the other operand staged at a time
constexpr int kTileLd = kTile + 1;  // row stride of a staged 64 x 64 score tile
constexpr float kNegInf = -1e30f;  // the reference's finite "-inf" (attention.py:29)
constexpr size_t kMaxSharedBytes = 232448;  // per block on sm_90

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// Stage rows [0, n) of a row-major [*, D] slab in shared memory as f32 with row stride D + 1;
// rows [n, kTile) become zeros. Neighbouring threads read neighbouring elements.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int n) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r < n ? to_float(src[static_cast<long long>(r) * D + c]) : 0.f;
  }
}

// acc[i][j] = sum over d of A[ty + 16 i][d] * B[tx + 16 j][d]: a 64 x 64 tile of A B^T for
// two staged 64 x D operands, d in order.
template <int D>
__device__ __forceinline__ void dot_nt(float (&acc)[4][4], const float* A, const float* B) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum over c < n of P(ty + 16 i, c) * V[c][tx + 16 j], where P(r, c) is
// P[r * prs + c * pcs] (a score tile, read straight or transposed) and V a staged 64 x D
// operand: a 64 x D tile of P V, c in order.
template <int D>
__device__ __forceinline__ void dot_nn_acc(float (&acc)[4][D / 16], const float* P, int prs,
                                           int pcs, const float* V, int n) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int c = 0; c < n; ++c) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * prs + c * pcs];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float vv = V[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
    }
  }
}

// K4: one block per (batch*head, 64 q rows). For each kv tile of block_k keys: the tile's
// scores (in chunks of 64 keys), the running maximum m, p = exp(s - m) summed unrounded into
// l and rounded to v's type, alpha = exp(m_prev - m), acc = acc * alpha + p V. At the end
// o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)) (attention.py:147-171).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                         int sq, int sk, int block_k, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int ld = D + 1;
  const int lds = block_k + 1;
  float* qs = smem;                 // [kTile][ld]
  float* kvs = qs + kTile * ld;     // [kTile][ld]: a chunk of K, then of V
  float* ss = kvs + kTile * ld;     // [kTile][lds]: scores, then rounded p
  float* m_s = ss + kTile * lds;    // [kTile] running maximum
  float* l_s = m_s + kTile;         // [kTile] running normaliser
  float* a_s = l_s + kTile;         // [kTile] this tile's alpha

  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // the longest causal rows start first
  const int nq = min(kTile, sq - q0);
  const int last_row = q0 + nq - 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;

  load_rows<T, D>(qs, q + (bh * sq + q0) * D, nq);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[4][D / 16] = {};

  for (int t0 = 0; t0 < sk; t0 += block_k) {
    if (causal && t0 > last_row) break;  // every key from here on lies above the diagonal
    for (int c0 = 0; c0 < block_k; c0 += kTile) {
      const int nk = min(kTile, block_k - c0);
      __syncthreads();  // the previous readers of kvs and ss are done
      load_rows<T, D>(kvs, kb + static_cast<long long>(t0 + c0) * D, nk);
      __syncthreads();
      float s[4][4];
      dot_nt<D>(s, qs, kvs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          if (c < nk) {
            float x = s[i][j] * scale;
            if (causal && q0 + r < t0 + c0 + c) x = kNegInf;
            ss[r * lds + c0 + c] = x;
          }
        }
    }
    __syncthreads();
    for (int r = warp; r < kTile; r += kThreads / 32) {
      float* row = ss + r * lds;
      float mx = kNegInf;
      for (int c = lane; c < block_k; c += 32) mx = fmaxf(mx, row[c]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < block_k; c += 32) {
        const float p = expf(row[c] - m_new);
        sum += p;
        row[c] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    for (int c0 = 0; c0 < block_k; c0 += kTile) {
      const int nk = min(kTile, block_k - c0);
      __syncthreads();
      load_rows<T, D>(kvs, vb + static_cast<long long>(t0 + c0) * D, nk);
      __syncthreads();
      dot_nn_acc<D>(acc, ss + c0, lds, 1, kvs, nk);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      const float l = fmaxf(l_s[r], 1e-30f);
      T* out = o + (bh * sq + q0 + r) * D;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) out[tx + 16 * j] = from_float<T>(acc[i][j] / l);
    }
  }
  for (int r = threadIdx.x; r < nq; r += kThreads)
    lse[bh * sq + q0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

// The shared per-tile backward math (_bwd_p_ds, attention.py:234-247) for a 64 x 64 tile of
// q rows r and kv columns c: p = exp(s - lse_r), ds = p * (dO_r . V_c - delta_r), stored
// rounded to the operands' type (the TPU's p.astype(do.dtype), ds.astype(q.dtype)).
template <typename T, int D>
__device__ __forceinline__ void tile_p_ds(float* ps, float* dss, const float* qs,
                                          const float* ks, const float* dos, const float* vs,
                                          const float* lse_s, const float* delta_s, int q0,
                                          int k0, float scale, int causal) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
  dot_nt<D>(s, qs, ks);
  dot_nt<D>(dp, dos, vs);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      float x = s[i][j] * scale;
      if (causal && q0 + r < k0 + c) x = kNegInf;
      const float p = expf(x - lse_s[r]);
      if (ps != nullptr) ps[r * kTileLd + c] = round_to<T>(p);
      dss[r * kTileLd + c] = round_to<T>(p * (dp[i][j] - delta_s[r]));
    }
}

__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta, int n) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    lse_s[r] = r < n ? lse[r] : 0.f;
    delta_s[r] = r < n ? delta[r] : 0.f;
  }
}

// K5a: one block per (batch*head, 64 kv rows); loops over q tiles. dV += p^T dO and
// dK += ds^T Q in registers, dK scaled once at the end (the TPU scales each tile's product).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_backward_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
                              float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int ld = D + 1;
  float* ks = smem;
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* dos = qs + kTile * ld;
  float* ps = dos + kTile * ld;      // [kTile q][kTileLd]
  float* dss = ps + kTile * kTileLd;  // [kTile q][kTileLd]
  float* lse_s = dss + kTile * kTileLd;
  float* delta_s = lse_s + kTile;

  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // the first kv rows have the most causal q rows
  const int nk = min(kTile, sk - k0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows<T, D>(ks, k + (bh * sk + k0) * D, nk);
  load_rows<T, D>(vs, v + (bh * sk + k0) * D, nk);
  float dk_acc[4][D / 16] = {};
  float dv_acc[4][D / 16] = {};

  for (int q0 = 0; q0 < sq; q0 += kTile) {
    const int nq = min(kTile, sq - q0);
    if (causal && q0 + nq - 1 < k0) continue;  // every row lies above these keys: p = 0
    __syncthreads();
    load_rows<T, D>(qs, q + (bh * sq + q0) * D, nq);
    load_rows<T, D>(dos, dout + (bh * sq + q0) * D, nq);
    load_row_stats(lse_s, delta_s, lse + bh * sq + q0, delta + bh * sq + q0, nq);
    __syncthreads();
    tile_p_ds<T, D>(ps, dss, qs, ks, dos, vs, lse_s, delta_s, q0, k0, scale, causal);
    __syncthreads();
    dot_nn_acc<D>(dv_acc, ps, 1, kTileLd, dos, nq);
    dot_nn_acc<D>(dk_acc, dss, 1, kTileLd, qs, nq);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nk) {
      T* dk_row = dk + (bh * sk + k0 + r) * D;
      T* dv_row = dv + (bh * sk + k0 + r) * D;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        dk_row[tx + 16 * j] = from_float<T>(dk_acc[i][j] * scale);
        dv_row[tx + 16 * j] = from_float<T>(dv_acc[i][j]);
      }
    }
  }
}

// K5b: one block per (batch*head, 64 q rows); loops over kv tiles. dQ += ds K in registers,
// scaled once at the end.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_backward_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dq, int sq, int sk, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int ld = D + 1;
  float* qs = smem;
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* dss = vs + kTile * ld;  // [kTile q][kTileLd]
  float* lse_s = dss + kTile * kTileLd;
  float* delta_s = lse_s + kTile;

  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int nq = min(kTile, sq - q0);
  const int last_row = q0 + nq - 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows<T, D>(qs, q + (bh * sq + q0) * D, nq);
  load_rows<T, D>(dos, dout + (bh * sq + q0) * D, nq);
  load_row_stats(lse_s, delta_s, lse + bh * sq + q0, delta + bh * sq + q0, nq);
  float dq_acc[4][D / 16] = {};

  for (int k0 = 0; k0 < sk; k0 += kTile) {
    if (causal && k0 > last_row) break;
    const int nk = min(kTile, sk - k0);
    __syncthreads();
    load_rows<T, D>(ks, k + (bh * sk + k0) * D, nk);
    load_rows<T, D>(vs, v + (bh * sk + k0) * D, nk);
    __syncthreads();
    tile_p_ds<T, D>(nullptr, dss, qs, ks, dos, vs, lse_s, delta_s, q0, k0, scale, causal);
    __syncthreads();
    dot_nn_acc<D>(dq_acc, dss, kTileLd, 1, ks, nk);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      T* dq_row = dq + (bh * sq + q0 + r) * D;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) dq_row[tx + 16 * j] = from_float<T>(dq_acc[i][j] * scale);
    }
  }
}

template <typename T>
struct Type {
  using type = T;
};

// f(Type<T>, integral_constant<int, D>) for dtype_code (0: f32, 1: bf16) and D.
template <typename TT, typename F>
int dispatch_head_dim(TT t, int d, F f) {
  switch (d) {
    case 16: return f(t, std::integral_constant<int, 16>{});
    case 32: return f(t, std::integral_constant<int, 32>{});
    case 64: return f(t, std::integral_constant<int, 64>{});
    case 128: return f(t, std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int dispatch(int dtype_code, int d, F f) {
  if (dtype_code == 0) return dispatch_head_dim(Type<float>{}, d, f);
  if (dtype_code == 1) return dispatch_head_dim(Type<__nv_bfloat16>{}, d, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename K, typename... Args>
int launch(K kernel, long long bh, int s, size_t smem, cudaStream_t stream, Args... args) {
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>((s + kTile - 1) / kTile));
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrappers (harmony_tpu_torch/ops/attention.py) check shapes, types, contiguity and
// block divisibility, and allocate every output. dtype_code 0: f32, 1: bf16; d in
// {16, 32, 64, 128}. Each launches on `stream` and returns cudaGetLastError() as an int.

// K4: o [bh, sq, d] in the operands' type, lse [bh, sq] f32.
extern "C" int harmony_flash_forward(const void* q, const void* k, const void* v, void* o,
                                     float* lse, int dtype_code, long long bh, int sq, int sk,
                                     int d, int block_k, float scale, int causal,
                                     cudaStream_t stream) {
  return dispatch(dtype_code, d, [&](auto t, auto dd) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    const size_t smem =
        sizeof(float) * (2 * kTile * (D + 1) + kTile * (block_k + 1) + 3 * kTile);
    return launch(flash_forward_kernel<T, D>, bh, sq, smem, stream, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse,
                  sq, sk, block_k, scale, causal);
  });
}

// K5a: dk, dv [bh, sk, d] in the operands' type.
extern "C" int harmony_flash_backward_dkv(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse,
                                          const float* delta, void* dk, void* dv,
                                          int dtype_code, long long bh, int sq, int sk, int d,
                                          float scale, int causal, cudaStream_t stream) {
  return dispatch(dtype_code, d, [&](auto t, auto dd) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    const size_t smem = sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kTileLd + 2 * kTile);
    return launch(flash_backward_dkv_kernel<T, D>, bh, sk, smem, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
                  static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, scale, causal);
  });
}

// K5b: dq [bh, sq, d] in the operands' type.
extern "C" int harmony_flash_backward_dq(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse,
                                         const float* delta, void* dq, int dtype_code,
                                         long long bh, int sq, int sk, int d, float scale,
                                         int causal, cudaStream_t stream) {
  return dispatch(dtype_code, d, [&](auto t, auto dd) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    const size_t smem = sizeof(float) * (4 * kTile * (D + 1) + kTile * kTileLd + 2 * kTile);
    return launch(flash_backward_dq_kernel<T, D>, bh, sq, smem, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
                  static_cast<T*>(dq), sq, sk, scale, causal);
  });
}
