// Flash attention on Hopper's tensor cores (sm_90a), bf16 operands: K4 forward, K5a
// backward dK/dV and K5b backward dQ. The f32 route stays in flash_attention.cu.
//
// Replaces, in harmony_tpu/ops/attention.py:
//   K4  _flash_forward (attention.py:191), body _fa_kernel, pallas_call at :208;
//   K5a _flash_backward (:310) dK/dV, body _fa_bwd_dkv_kernel, pallas_call at :345;
//   K5b _flash_backward (:310) dQ, body _fa_bwd_dq_kernel (tile math _bwd_p_ds), pallas_call
//       at :367.
// Layout: q, o, dout, dq [BH, Sq, D] and k, v, dk, dv [BH, Sk, D] bf16, row-major; lse and
// delta [BH, Sq] f32, compact.
//
// What they compute is the scalar kernels' function (flash_attention.cu), which is the TPU
// kernels' arithmetic: scores are f32 sums of exact bf16 products, scaled after the product,
// masked with the finite -1e30 (row >= col). K4 walks the keys in tiles of exactly the
// caller's block_k and rounds p to bf16 at that tile's running maximum (attention.py:150-158);
// l sums the unrounded p. K5a and K5b recompute p = exp(x - lse) from the final LSE and
// ds = p (dp - delta), and round them elementwise, so no rounding depends on a tile: K5a's q
// tiling and K5b's key tiling are their own. Only the order of f32 additions differs.
//
// What bounds them at the LM's shape (q, k, v [32, 8, 1024, 64], causal, H100 SXM): K4 moves
// 135 MB and does 3.44e10 tensor-core operations: 0.040 ms by bytes. K5a moves 203 MB and
// does 6.9e10: 0.070 ms by operations. K5b moves 170 MB and does 5.2e10: 0.052 ms by
// operations. All want the tensor cores fed from shared memory without stalls; none may
// spill its tile state to device memory.
//
// Design. One block of 4 warps owns 64 rows of the output (q rows for K4 and K5b, kv rows for
// K5a), 16 rows a warp, and loops over the other axis; each output element is written once,
// with no atomics, so a result is the same bit for bit from run to run. Every tile product is
// mma.sync.m16n8k16 (bf16 x bf16 -> f32). Operands are staged as bf16 in shared memory with
// rows padded by 16 bytes, so the 8 row addresses of each ldmatrix fall in 8 distinct bank
// groups; the next tile is in flight by cp.async (two stages) while this one computes.
//   K4: Q lives in registers as A fragments for the whole walk; it is staged in the second
//   stage's rows, which it leaves before tile 1 lands there, so at D = 64 and block_k 128 a
//   block takes 72 KB and at most 168 registers a thread, and three blocks (12 warps) share
//   an SM. A 128-row block of 8 warps would halve the K/V staging per row but, at these
//   registers, fit one block an SM: no more warps in flight. A whole tile of block_k keys
//   (16, 32, 64 or 128; the wrapper sends other tiles to the scalar kernel) is one step:
//   S = Q K^T stays in registers; the row maximum is taken in each thread and across its
//   quad by shuffles; p = exp(x - m) is rounded to bf16 and repacked from the C-fragment
//   layout straight into the A fragments of P V, and V is read through ldmatrix.trans.
//   Causal tiles wholly above a warp's rows are skipped (exactly: p = 0, alpha = 1), and the
//   mask is applied only on tiles that cross the diagonal.
//   K5a: a warp's K and V rows are the A operands of S^T = K Q^T and dP^T = V dO^T (held in
//   registers up to D = 64, read by ldmatrix for D = 128). P^T and dS^T, from the unrounded
//   P^T, are rounded into A fragments in registers; dV += P^T dO and dK += dS^T Q read dO and
//   Q through ldmatrix.trans. q tiles wholly above a warp's keys are skipped; dK is scaled
//   once at the end. At D = 64 it takes 218 registers a thread, two blocks an SM; reading K
//   and V by ldmatrix instead, to fit three, spilled and was no faster.
//   K5b: K5a with the roles swapped. A warp's Q and dO rows are the A operands of S = Q K^T
//   and dP = dO V^T (held in registers up to D = 64, read by ldmatrix for D = 128), and each
//   thread keeps its two rows' lse and delta in registers. K and V come in tiles of 64 keys,
//   whatever block_k is; dS, from the unrounded P, is rounded into A fragments in registers,
//   and dQ += dS K reads K through ldmatrix.trans. At D = 128 a warp takes the keys in
//   sub-tiles of 32, so dQ (64 floats a thread) and one sub-tile's S and dP fit the
//   registers; at every D it runs at most 168 registers a thread, three blocks an SM where
//   shared memory allows (D <= 64: 55,296 bytes a block). Key tiles wholly above a warp's rows are skipped and the mask is applied
//   only on tiles that cross the diagonal (or pass Sk); the grid walks the longest causal
//   rows first, as K4's does. dQ is scaled once at the end.
// wgmma and TMA (a warpgroup's asynchronous products, one thread's tile copies) are the
// next step; this is the mma.sync version.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;          // output rows a block owns, 16 a warp
constexpr int kPad = 8;            // bf16 elements of padding per staged row (16 bytes)
constexpr float kNegInf = -1e30f;  // the reference's finite "-inf" (attention.py:29)
constexpr size_t kMaxSharedBytes = 232448;  // per block on sm_90
// K4 blocks an SM: three up to D = 64 (at most 168 registers a thread, and Q's shared
// memory reused), so 12 warps hide each other's latency; one above, where the tile state
// needs the registers.
template <int D>
constexpr int kForwardBlocksPerSM = D <= 64 ? 3 : 1;

// Does K4's Q tile fit in the second stage's K and V rows (it lives there until tile 1)?
__host__ __device__ constexpr bool q_in_stage(int block_k) { return 2 * block_k >= kRows; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Wait until at most one committed group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b for a 16 x 16 A fragment and a 16 x 8 B fragment (b0: k 0-7, b1: k 8-15).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 in one register, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16 x 16 product whose rows are C fragments c_lo (columns 0-7) and
// c_hi (columns 8-15) of a 16 x 16 f32 tile, rounded to bf16: no shared-memory round trip.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c_lo)[4],
                                         const float (&c_hi)[4]) {
  a[0] = pack_bf16(c_lo[0], c_lo[1]);
  a[1] = pack_bf16(c_lo[2], c_lo[3]);
  a[2] = pack_bf16(c_hi[0], c_hi[1]);
  a[3] = pack_bf16(c_hi[2], c_hi[3]);
}

// Fragment addresses within a staged [rows][ld] tile, for this lane of an ldmatrix.x4:
//   a_frag: the A fragment of rows r0..r0+15, columns c0..c0+15;
//   nt_pair: B fragments of two n-tiles (rows n0..n0+7 and n0+8..n0+15 of a row-major
//     [n][k] operand, the "transposed" side of A B^T), columns c0..c0+15;
//   kn_pair (with .trans): B fragments of a row-major [k][n] operand, k rows k0..k0+15,
//     two n-tiles at columns n0 and n0+8.
template <int LD>
__device__ __forceinline__ const bf16* a_frag(const bf16* s, int r0, int c0, int lane) {
  return s + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ const bf16* nt_pair(const bf16* s, int n0, int c0, int lane) {
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 + ((lane >> 3) & 1) * 8;
}
template <int LD>
__device__ __forceinline__ const bf16* kn_pair(const bf16* s, int k0, int n0, int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8;
}

// Copy rows [0, n) of a row-major [*, D] bf16 slab into shared memory with row stride
// D + kPad, 16 bytes a copy in flight by cp.async; rows [n, ROWS) become zeros.
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int n) {
  constexpr int kPieces = D / 8;
  for (int e = threadIdx.x; e < ROWS * kPieces; e += kThreads) {
    const int r = e / kPieces, c = (e % kPieces) * 8;
    bf16* d = dst + r * (D + kPad) + c;
    if (r < n) {
      cp_async16(d, src + static_cast<long long>(r) * D + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Store a 16 x D f32 accumulator (C fragments) of a warp as bf16 rows row0 and row0 + 8 of
// `out` ([*, D]), each multiplied by mul[r] and divided by div[r], rows < limit only.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (&acc)[D / 8][4],
                                           int row0, int limit, const float (&mul)[2],
                                           const float (&div)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= limit) continue;
    bf16* dst = out + static_cast<long long>(row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t v = pack_bf16(acc[j][2 * r] * mul[r] / div[r],
                                   acc[j][2 * r + 1] * mul[r] / div[r]);
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = v;
    }
  }
}

// ---------------------------------------------------------------------------------------
// K4: one block per (batch*head, 64 q rows), grid.y walked longest causal rows first.
// Keys go in tiles of BK = block_k; a step is one tile staged in shared memory: it takes the
// tile's maximum, rescales and accumulates p V.
template <int D, int BK>
__global__ void __launch_bounds__(kThreads, kForwardBlocksPerSM<D>)
    flash_forward_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o,
                             float* __restrict__ lse, int sq, int sk, float scale, int causal) {
  constexpr int ld = D + kPad;
  constexpr int kKeyTiles = BK / 8;  // n-tiles of S
  constexpr int kDTiles = D / 8;     // n-tiles of O
  constexpr int kDSteps = D / 16;    // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 2 x {K [BK][ld], V [BK][ld]}, and Q [kRows][ld] in the second stage while it is free
  bf16* stages = reinterpret_cast<bf16*>(smem_raw) + (q_in_stage(BK) ? 0 : kRows * ld);
  bf16* qs = q_in_stage(BK) ? stages + 2 * BK * ld : reinterpret_cast<bf16*>(smem_raw);

  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int nq = min(kRows, sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_first = q0 + warp * 16;  // this warp's rows: warp_first .. + 15
  const int row0 = warp_first + g;        // this thread's rows: row0 and row0 + 8
  const bf16* kb = k + bh * sk * D;
  const bf16* vb = v + bh * sk * D;

  int ntiles = sk / BK;
  if (causal) ntiles = min(ntiles, (q0 + nq - 1) / BK + 1);

  auto issue = [&](int i) {
    if (i < ntiles) {
      bf16* ks = stages + (i & 1) * 2 * BK * ld;
      stage_rows<D, BK>(ks, kb + static_cast<long long>(i) * BK * D, BK);
      stage_rows<D, BK>(ks + BK * ld, vb + static_cast<long long>(i) * BK * D, BK);
    }
    cp_async_commit();
  };

  stage_rows<D, kRows>(qs, q + (bh * sq + q0) * D, nq);
  issue(0);  // the first group holds Q and tile 0
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[kDSteps][4];
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) ldsm_x4(qf[kk], a_frag<ld>(qs, warp * 16, kk * 16, lane));
  __syncthreads();  // Q is in registers: its shared memory may take tile 1

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running maximum of rows row0, row0 + 8
  float l[2] = {0.f, 0.f};          // this thread's share of the running normaliser

  for (int i = 0; i < ntiles; ++i) {
    issue(i + 1);
    cp_async_wait_one();
    __syncthreads();
    const int key0 = i * BK;
    const bf16* ks = stages + (i & 1) * 2 * BK * ld;
    const bf16* vs = ks + BK * ld;
    float mt[2] = {m[0], m[1]};  // the tile's maximum, as it is taken
    // A tile wholly above this warp's rows contributes exactly nothing (p = 0, alpha = 1).
    const bool active = !causal || key0 <= warp_first + 15;
    float s[kKeyTiles][4];
    if (active) {
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk)
#pragma unroll
        for (int n2 = 0; n2 < kKeyTiles / 2; ++n2) {
          uint32_t b[4];
          ldsm_x4(b, nt_pair<ld>(ks, n2 * 16, kk * 16, lane));
          mma(s[2 * n2], qf[kk], b[0], b[1]);
          mma(s[2 * n2 + 1], qf[kk], b[2], b[3]);
        }
      const bool crosses = causal && key0 + BK - 1 > warp_first;
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (crosses && row0 + 8 * (e >> 1) < key0 + n * 8 + 2 * t + (e & 1)) x = kNegInf;
          s[n][e] = x;
          mt[e >> 1] = fmaxf(mt[e >> 1], x);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = quad_max(mt[r]);
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int d = 0; d < kDTiles; ++d) {
        acc[d][2 * r] *= alpha;
        acc[d][2 * r + 1] *= alpha;
      }
    }
    if (active) {
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[n][e] - m[e >> 1]);
          l[e >> 1] += p;
          s[n][e] = p;
        }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a_from_c(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int d2 = 0; d2 < kDTiles / 2; ++d2) {
          uint32_t b[4];
          ldsm_x4_trans(b, kn_pair<ld>(vs, kk * 16, d2 * 16, lane));
          mma(acc[2 * d2], a, b[0], b[1]);
          mma(acc[2 * d2 + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before tile i + 2 refills it
  }

  float one[2] = {1.f, 1.f}, lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lc[r] = fmaxf(quad_sum(l[r]), 1e-30f);
  store_rows<D>(o + bh * sq * D, acc, row0, q0 + nq, one, lc);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < q0 + nq) lse[bh * sq + row0 + 8 * r] = m[r] + logf(lc[r]);
  }
}

// ---------------------------------------------------------------------------------------
// K5a: one block per (batch*head, 64 kv rows); loops over q tiles of 64 rows, each staged
// with its lse and delta, two stages by cp.async. Within a tile a warp takes the q rows in
// sub-tiles of QN (64 up to D = 64, 32 at D = 128, so the tile state fits the registers).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_backward_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, int sq, int sk, float scale,
                                  int causal) {
  constexpr int ld = D + kPad;
  constexpr int kBQ = 64;                 // q rows a staged tile
  constexpr int kQN = D <= 64 ? 64 : 32;  // q rows a warp takes at a time
  constexpr int kQTiles = kQN / 8;        // n-tiles of S^T and dP^T
  constexpr int kDTiles = D / 8;
  constexpr int kDSteps = D / 16;
  constexpr bool kKVInRegisters = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kRows][ld]
  bf16* vs = ks + kRows * ld;                    // [kRows][ld]
  bf16* stages = vs + kRows * ld;                // 2 x {Q [kBQ][ld], dO [kBQ][ld]}
  float* stats = reinterpret_cast<float*>(stages + 4 * kBQ * ld);  // 2 x {lse, delta} [kBQ]

  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;  // the first kv rows have the most causal q rows
  const int nk = min(kRows, sk - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_first = k0 + warp * 16;  // this warp's kv rows: warp_first .. + 15
  const int row0 = warp_first + g;        // this thread's kv rows: row0 and row0 + 8

  // q tiles wholly above the block's keys (every row < k0) are never staged
  const int q_first = causal ? (k0 / kBQ) * kBQ : 0;
  const int ntiles = q_first < sq ? (sq - q_first + kBQ - 1) / kBQ : 0;

  auto issue = [&](int i) {
    if (i < ntiles) {
      const int q0 = q_first + i * kBQ, n = min(kBQ, sq - q0);
      bf16* qs = stages + (i & 1) * 2 * kBQ * ld;
      float* st = stats + (i & 1) * 2 * kBQ;
      stage_rows<D, kBQ>(qs, q + (bh * sq + q0) * D, n);
      stage_rows<D, kBQ>(qs + kBQ * ld, dout + (bh * sq + q0) * D, n);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        if (r < n) {
          cp_async4(st + r, lse + bh * sq + q0 + r);
          cp_async4(st + kBQ + r, delta + bh * sq + q0 + r);
        } else {  // zero q, dO, lse and delta rows: p = 1, ds = 0, products 0
          st[r] = 0.f;
          st[kBQ + r] = 0.f;
        }
      }
    }
    cp_async_commit();
  };

  stage_rows<D, kRows>(ks, k + (bh * sk + k0) * D, nk);
  stage_rows<D, kRows>(vs, v + (bh * sk + k0) * D, nk);
  issue(0);  // the first group holds K, V and tile 0

  uint32_t kf[kKVInRegisters ? kDSteps : 1][4], vf[kKVInRegisters ? kDSteps : 1][4];
  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    issue(i + 1);
    cp_async_wait_one();
    __syncthreads();
    if constexpr (kKVInRegisters) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < kDSteps; ++kk) {
          ldsm_x4(kf[kk], a_frag<ld>(ks, warp * 16, kk * 16, lane));
          ldsm_x4(vf[kk], a_frag<ld>(vs, warp * 16, kk * 16, lane));
        }
      }
    }
    const int q0 = q_first + i * kBQ;
    const bf16* qs = stages + (i & 1) * 2 * kBQ * ld;
    const bf16* dos = qs + kBQ * ld;
    const float* lse_s = stats + (i & 1) * 2 * kBQ;
    const float* delta_s = lse_s + kBQ;
#pragma unroll
    for (int c0 = 0; c0 < kBQ; c0 += kQN) {
      // q rows wholly above this warp's keys contribute exactly nothing (p = 0)
      if (causal && q0 + c0 + kQN - 1 < warp_first) continue;
      float s[kQTiles][4], dp[kQTiles][4];
#pragma unroll
      for (int n = 0; n < kQTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        // the A fragments of this warp's K and V rows, columns kk*16 .. +15
        uint32_t ka[4], va[4];
        if constexpr (kKVInRegisters) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kk][e];
            va[e] = vf[kk][e];
          }
        } else {
          ldsm_x4(ka, a_frag<ld>(ks, warp * 16, kk * 16, lane));
          ldsm_x4(va, a_frag<ld>(vs, warp * 16, kk * 16, lane));
        }
#pragma unroll
        for (int n2 = 0; n2 < kQTiles / 2; ++n2) {
          uint32_t b[4];
          ldsm_x4(b, nt_pair<ld>(qs, c0 + n2 * 16, kk * 16, lane));
          mma(s[2 * n2], ka, b[0], b[1]);
          mma(s[2 * n2 + 1], ka, b[2], b[3]);
          ldsm_x4(b, nt_pair<ld>(dos, c0 + n2 * 16, kk * 16, lane));
          mma(dp[2 * n2], va, b[0], b[1]);
          mma(dp[2 * n2 + 1], va, b[2], b[3]);
        }
      }
      const bool crosses = causal && q0 + c0 < warp_first + 15;
#pragma unroll
      for (int n = 0; n < kQTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + n * 8 + 2 * t + (e & 1);  // q row within the tile
          float x = s[n][e] * scale;
          if (crosses && q0 + c < row0 + 8 * (e >> 1)) x = kNegInf;
          const float p = expf(x - lse_s[c]);
          dp[n][e] = p * (dp[n][e] - delta_s[c]);
          s[n][e] = p;
        }
#pragma unroll
      for (int kk = 0; kk < kQN / 16; ++kk) {
        uint32_t pa[4], dsa[4];
        a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
        a_from_c(dsa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int d2 = 0; d2 < kDTiles / 2; ++d2) {
          uint32_t b[4];
          ldsm_x4_trans(b, kn_pair<ld>(dos, c0 + kk * 16, d2 * 16, lane));
          mma(dv_acc[2 * d2], pa, b[0], b[1]);
          mma(dv_acc[2 * d2 + 1], pa, b[2], b[3]);
          ldsm_x4_trans(b, kn_pair<ld>(qs, c0 + kk * 16, d2 * 16, lane));
          mma(dk_acc[2 * d2], dsa, b[0], b[1]);
          mma(dk_acc[2 * d2 + 1], dsa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before tile i + 2 refills it
  }

  const float one[2] = {1.f, 1.f}, scales[2] = {scale, scale};
  store_rows<D>(dk + bh * sk * D, dk_acc, row0, k0 + nk, scales, one);
  store_rows<D>(dv + bh * sk * D, dv_acc, row0, k0 + nk, one, one);
}

// ---------------------------------------------------------------------------------------
// K5b: one block per (batch*head, 64 q rows), grid.y walked longest causal rows first; loops
// over kv tiles of 64 keys, K and V staged in two stages by cp.async. Within a tile a
// warp takes the keys in sub-tiles of KN (64 up to D = 64, 32 at D = 128, so the tile state
// fits the registers). Three blocks an SM cap it at 168 registers a thread; left uncapped,
// ptxas took 168 at D = 64 all the same and spilled 16 bytes.
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
    flash_backward_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta, bf16* __restrict__ dq,
                                 int sq, int sk, float scale, int causal) {
  constexpr int ld = D + kPad;
  constexpr int kBK = 64;                 // keys a staged tile
  constexpr int kKN = D <= 64 ? 64 : 32;  // keys a warp takes at a time
  constexpr int kKeyTiles = kKN / 8;      // n-tiles of S and dP
  constexpr int kDTiles = D / 8;
  constexpr int kDSteps = D / 16;
  constexpr bool kQInRegisters = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][ld]
  bf16* dos = qs + kRows * ld;                   // [kRows][ld]
  bf16* stages = dos + kRows * ld;               // 2 x {K [kBK][ld], V [kBK][ld]}

  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int nq = min(kRows, sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_first = q0 + warp * 16;  // this warp's q rows: warp_first .. + 15
  const int row0 = warp_first + g;        // this thread's q rows: row0 and row0 + 8
  const bf16* kb = k + bh * sk * D;
  const bf16* vb = v + bh * sk * D;

  // this thread's rows' lse and delta; rows past Sq (zero q and dO) take 0: p = 1, ds = 0
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < sq ? lse[bh * sq + row] : 0.f;
    delta_r[r] = row < sq ? delta[bh * sq + row] : 0.f;
  }

  int ntiles = (sk + kBK - 1) / kBK;
  if (causal) ntiles = min(ntiles, (q0 + nq - 1) / kBK + 1);

  auto issue = [&](int i) {
    if (i < ntiles) {
      const int key0 = i * kBK, n = min(kBK, sk - key0);
      bf16* ks = stages + (i & 1) * 2 * kBK * ld;
      stage_rows<D, kBK>(ks, kb + static_cast<long long>(key0) * D, n);
      stage_rows<D, kBK>(ks + kBK * ld, vb + static_cast<long long>(key0) * D, n);
    }
    cp_async_commit();
  };

  stage_rows<D, kRows>(qs, q + (bh * sq + q0) * D, nq);
  stage_rows<D, kRows>(dos, dout + (bh * sq + q0) * D, nq);
  issue(0);  // the first group holds Q, dO and tile 0

  uint32_t qf[kQInRegisters ? kDSteps : 1][4], dof[kQInRegisters ? kDSteps : 1][4];
  float dq_acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    issue(i + 1);
    cp_async_wait_one();
    __syncthreads();
    if constexpr (kQInRegisters) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < kDSteps; ++kk) {
          ldsm_x4(qf[kk], a_frag<ld>(qs, warp * 16, kk * 16, lane));
          ldsm_x4(dof[kk], a_frag<ld>(dos, warp * 16, kk * 16, lane));
        }
      }
    }
    const int key0 = i * kBK;
    const bf16* ks = stages + (i & 1) * 2 * kBK * ld;
    const bf16* vs = ks + kBK * ld;
    const bool ragged = key0 + kBK > sk;  // the zero rows past Sk must get p = 0
#pragma unroll
    for (int c0 = 0; c0 < kBK; c0 += kKN) {
      // keys wholly above this warp's rows contribute exactly nothing (p = 0)
      if (causal && key0 + c0 > warp_first + 15) continue;
      float s[kKeyTiles][4], dp[kKeyTiles][4];
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        // the A fragments of this warp's Q and dO rows, columns kk*16 .. +15
        uint32_t qa[4], da[4];
        if constexpr (kQInRegisters) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qa[e] = qf[kk][e];
            da[e] = dof[kk][e];
          }
        } else {
          ldsm_x4(qa, a_frag<ld>(qs, warp * 16, kk * 16, lane));
          ldsm_x4(da, a_frag<ld>(dos, warp * 16, kk * 16, lane));
        }
#pragma unroll
        for (int n2 = 0; n2 < kKeyTiles / 2; ++n2) {
          uint32_t b[4];
          ldsm_x4(b, nt_pair<ld>(ks, c0 + n2 * 16, kk * 16, lane));
          mma(s[2 * n2], qa, b[0], b[1]);
          mma(s[2 * n2 + 1], qa, b[2], b[3]);
          ldsm_x4(b, nt_pair<ld>(vs, c0 + n2 * 16, kk * 16, lane));
          mma(dp[2 * n2], da, b[0], b[1]);
          mma(dp[2 * n2 + 1], da, b[2], b[3]);
        }
      }
      const bool masked = ragged || (causal && key0 + c0 + kKN - 1 > warp_first);
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = key0 + c0 + n * 8 + 2 * t + (e & 1);
          float x = s[n][e] * scale;
          if (masked && (col >= sk || (causal && row0 + 8 * (e >> 1) < col))) x = kNegInf;
          const float p = expf(x - lse_r[e >> 1]);
          dp[n][e] = p * (dp[n][e] - delta_r[e >> 1]);
        }
#pragma unroll
      for (int kk = 0; kk < kKN / 16; ++kk) {
        uint32_t dsa[4];
        a_from_c(dsa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int d2 = 0; d2 < kDTiles / 2; ++d2) {
          uint32_t b[4];
          ldsm_x4_trans(b, kn_pair<ld>(ks, c0 + kk * 16, d2 * 16, lane));
          mma(dq_acc[2 * d2], dsa, b[0], b[1]);
          mma(dq_acc[2 * d2 + 1], dsa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before tile i + 2 refills it
  }

  const float one[2] = {1.f, 1.f}, scales[2] = {scale, scale};
  store_rows<D>(dq + bh * sq * D, dq_acc, row0, q0 + nq, scales, one);
}

size_t forward_shared_bytes(int d, int block_k) {
  return sizeof(bf16) * static_cast<size_t>((q_in_stage(block_k) ? 0 : kRows) + 4 * block_k) *
         (d + kPad);
}

size_t dkv_shared_bytes(int d) {
  return sizeof(bf16) * static_cast<size_t>(6 * kRows) * (d + kPad) +
         sizeof(float) * 4 * kRows;
}

size_t dq_shared_bytes(int d) {
  return sizeof(bf16) * static_cast<size_t>(6 * kRows) * (d + kPad);
}

// f(integral_constant<int, n>) for a head dim or a key tile n in {16, 32, 64, 128}.
template <typename F>
int dispatch_width(int n, F f) {
  switch (n) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename K, typename... Args>
int launch(K kernel, long long bh, int rows, size_t smem, cudaStream_t stream, Args... args) {
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>((rows + kRows - 1) / kRows));
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrappers (harmony_tpu_torch/ops/attention.py, flash_route) check shapes, type (bf16),
// contiguity, 16-byte alignment and block divisibility, and allocate every output. d and
// K4's block_k in {16, 32, 64, 128}. Each launches on `stream` and returns
// cudaGetLastError() as an int.

// K4: o [bh, sq, d] bf16, lse [bh, sq] f32.
extern "C" int harmony_flash_forward_mma(const void* q, const void* k, const void* v, void* o,
                                         float* lse, long long bh, int sq, int sk, int d,
                                         int block_k, float scale, int causal,
                                         cudaStream_t stream) {
  return dispatch_width(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    return dispatch_width(block_k, [&](auto bk) {
      constexpr int BK = decltype(bk)::value;
      return launch(flash_forward_mma_kernel<D, BK>, bh, sq, forward_shared_bytes(D, BK),
                    stream, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, sq, sk, scale,
                    causal);
    });
  });
}

// K5a: dk, dv [bh, sk, d] bf16.
extern "C" int harmony_flash_backward_dkv_mma(const void* q, const void* k, const void* v,
                                              const void* dout, const float* lse,
                                              const float* delta, void* dk, void* dv,
                                              long long bh, int sq, int sk, int d, float scale,
                                              int causal, cudaStream_t stream) {
  return dispatch_width(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    return launch(flash_backward_dkv_mma_kernel<D>, bh, sk, dkv_shared_bytes(D), stream,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, scale, causal);
  });
}

// K5b: dq [bh, sq, d] bf16.
extern "C" int harmony_flash_backward_dq_mma(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* delta, void* dq, long long bh,
                                             int sq, int sk, int d, float scale, int causal,
                                             cudaStream_t stream) {
  return dispatch_width(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    return launch(flash_backward_dq_mma_kernel<D>, bh, sq, dq_shared_bytes(D), stream,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
                  static_cast<bf16*>(dq), sq, sk, scale, causal);
  });
}

// Dynamic shared memory a launch asks for: kernel 0 is K4 (at this block_k), 1 is K5a, 2 is
// K5b.
extern "C" int harmony_flash_mma_shared_bytes(int kernel, int d, int block_k) {
  if (kernel == 0) return static_cast<int>(forward_shared_bytes(d, block_k));
  if (kernel == 1) return static_cast<int>(dkv_shared_bytes(d));
  return static_cast<int>(dq_shared_bytes(d));
}
