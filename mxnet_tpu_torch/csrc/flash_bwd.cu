// Flash-attention backward for NVIDIA Hopper (sm_90a), CUDA C++: two
// kernels, dK/dV and dQ, each with its own plain C entry.
//
// Replaces the TPU kernels _flash_bwd_dkdv_kernel
// (mxnet_tpu/ops/attention.py:335, with _bwd_p_block :315) and
// _flash_bwd_dq_kernel (:380), both launched by _flash_bwd_pallas (:416).
// Same function: with the forward's float32 logsumexp lse and
// delta = rowsum(dO * O) (float32, computed outside the kernels, as
// attention.py:434 does), for every visible (query i, key j):
//   p  = exp(q_i . k_j * scale - lse_i)            (recomputed, not stored)
//   dv_j += round(p) * dO_i
//   ds = p * (dO_i . v_j - delta_i) * scale
//   dk_j += round(ds) * q_i                         (kernel 1: dkdv)
//   dq_i += round(ds) * k_j                         (kernel 2: dq)
// round() is to the storage dtype, as the TPU kernels cast p and ds before
// their MXU dots; every sum stays float32.  Keys at or past seq_k are
// masked; under causal, query row i sees keys <= i + (seq_k - seq_q)
// (sequence ends aligned).  A masked score gives p = 0 outright, so a row
// that sees no key (its lse is +1e30) passes zero gradient.
//
// Layout: q, dO (BH, Sq, D); k, v (BH, Sk, D); dq like q, dk and dv like
// k; all contiguous and in one storage dtype (float32, bfloat16 or
// float16).  lse and delta float32 (BH, Sq).
//
// What bounds it on this card: at the training shape (causal, S = 2048,
// D = 64) dkdv does 4 products of D multiply-adds per visible pair (8*D
// flop) and dq 3 (6*D flop) against 6 tensors of reads and writes:
// ~190 and ~140 flop per byte in f32, so the operations bound both, not
// the bytes.  The ceiling is the 67 TFLOP/s of the FMA units: f32 stays
// exact f32.  The tensor cores take f32 only as TF32 (10-bit mantissa),
// which breaks the f32 limit the kernels are held to (2**-12 times the sum
// of the absolute terms); three TF32 products a product (3xTF32) would
// keep it, at the price of hi/lo operand splits and a new error analysis,
// so f32 stays on the FMA units and the 16-bit dtypes run the same code.
//
// dkdv, a register-tiled SIMT product on a cp.async stream:
// - One block of 256 threads owns a k-tile of BK keys of one batch*head
//   and streams tiles of BQ queries, from the first that can see the
//   k-tile (the causal skip of attention.py:368-370, turned around).  K
//   and V are staged once; the q-tile (q, dO, lse, delta) is double
//   buffered: the cp.async copy of tile n+1 is in flight while tile n is
//   computed.  Staged tiles keep the storage dtype (16-byte cp.async.cg;
//   rows and head dims past the tensor are zero-filled by the src-size
//   operand).  A row whose bytes are not a multiple of 16, or a base that
//   is not 16-byte aligned, is staged by plain loads and stores instead.
// - Each q-tile is four small products, each thread a register micro-tile
//   of each, as a SIMT SGEMM does.  Phase A: S = Q K^T and dP = dO V^T,
//   BQ/16 queries x BK/16 keys a thread, over the padded head dim DP;
//   then p = exp(s * scale - lse) and ds = p * (dp - delta) * scale,
//   rounded to the storage dtype and written key-major (P^T, dS^T) to
//   shared memory.  Phase B, after one barrier: dV += P^T dO and
//   dK += dS^T Q over the BQ queries, BK/16 keys x DP/16 head dims a
//   thread, in registers across all q-tiles.
// - Only a q-tile that straddles the causal diagonal or the ragged edge
//   takes the per-score mask; the others run an unmasked instantiation.
// - The lanes of a warp form an 8 x 4 grid (8 keys or dims by 4 queries
//   or keys) and rows are padded by 16 bytes, so every shared-memory read
//   of a micro-tile is one conflict-free wavefront or a broadcast.  At
//   D = 64 (BK = 128, BQ = 64, 4 x 8 and 8 x 4 micro-tiles) that is one
//   16-byte read (f32) for every 10.7 FMAs in both phases.
// - Tiles by padded head dim DP (32, 64, 128, 256): BK x BQ = 64 x 64,
//   128 x 64, 32 x 64, 32 x 32, so the dK and dV sums stay at or below 64
//   registers a thread and shared memory within the 227 KB of a block.  At
//   D = 64, f32: 205 KB and 254 registers without spill, one block an SM.
//   Of the shapes timed at the training shape (64 x 64, 128 x 64, 64 x 32
//   at two blocks an SM) 128 x 64 was the fastest, and the inner loops
//   are unrolled twice: four or full unrolling ran slower (PERF.md).
// - Blocks start heaviest first: grid (batch*head, k-tile), so under
//   causal every head's first k-tile, which the most queries see, starts
//   before any later one, and the short k-tiles fill the tail: on an
//   H100 at the training shape, 4-6 % faster than the grid (k-tile,
//   batch*head) (PERF.md).
// - No atomics: each dK, dV element is summed by one thread in query
//   order, so the result is the same from run to run.
//
// dq (the first design, kept): a query row is owned by TPR threads, each
// holding DPT = 32 of the head dims of q, dO and dq (3 * 32 floats), so
// D <= 32 uses one thread a row, D <= 64 two, D <= 128 four, D <= 256
// eight; partial dot products are summed with warp shuffles.  The k/v
// tile is staged once in shared memory as float32 and read by every row
// of the block as broadcasts; slices of different threads are offset by 4
// floats.  Scores are taken CH = 2 keys at a time: with CH = 8 ptxas
// hoisted the chunk's loads past the register file and spilled kilobytes
// (PERF.md).  dq stops at the last key the q-tile's last row can see, as
// flash_fwd does.  Ragged Sq and Sk, and D below the slice width, are
// masked in-kernel; nothing is padded or copied.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kDPT = 32;   // head dims a thread holds
constexpr int kNT = 128;   // threads a block
constexpr int kCH = 2;     // streamed rows per score chunk

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to the storage dtype T (identity for float32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Stage rows [r0, r0 + R) of two (rows, d) tensors into shared memory as
// float32, each row laid out as TPR slices of DPS floats.
template <typename T, int R, int TPR, int DPS>
__device__ __forceinline__ void stage_pair(float* __restrict__ a_s,
                                           float* __restrict__ b_s,
                                           const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           size_t base, int r0, int rows,
                                           int d, int tid) {
  constexpr int ROW = TPR * DPS;
  for (int e = tid; e < R * TPR * kDPT; e += kNT) {
    const int r = e / (TPR * kDPT);
    const int c = e - r * (TPR * kDPT);
    const bool ok = r0 + r < rows && c < d;
    const size_t g = base + (size_t)(r0 + r) * d + c;
    const int s_idx = r * ROW + (c / kDPT) * DPS + (c % kDPT);
    a_s[s_idx] = ok ? to_f(a[g]) : 0.f;
    b_s[s_idx] = ok ? to_f(b[g]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// dK/dV
// ---------------------------------------------------------------------------

constexpr int kDkdvThreads = 256;   // 8 warps, a 16 x 16 grid of threads

// keys a block owns (BK), queries a streamed tile (BQ) and the blocks an
// SM is to hold (MINB, for ptxas's register budget), by padded head dim
template <int DP> struct DkdvTile;
template <> struct DkdvTile<32> { static constexpr int BK = 64, BQ = 64, MINB = 1; };
template <> struct DkdvTile<64> { static constexpr int BK = 128, BQ = 64, MINB = 1; };
template <> struct DkdvTile<128> { static constexpr int BK = 32, BQ = 64, MINB = 1; };
template <> struct DkdvTile<256> { static constexpr int BK = 32, BQ = 32, MINB = 1; };

// head dims a phase-B read (VW consecutive values)
__host__ __device__ constexpr int dkdv_vw(int dp) { return dp >= 64 ? 4 : 2; }

// Shared memory of one block: K, V (BK rows each), two stages of
// (Q, dO: BQ rows each; lse, delta: BQ floats each), then P^T and dS^T
// (BK rows of BQ floats).  Rows are padded by 16 bytes; every region
// starts 16-byte aligned.
template <typename T, int DP, int BK, int BQ>
struct DkdvSmem {
  static constexpr int DS = DP + 16 / (int)sizeof(T);   // row stride, in T
  static constexpr int PS = BQ + 4;                     // P^T row stride
  static constexpr size_t kv = 2 * (size_t)BK * DS * sizeof(T);
  static constexpr size_t rows = 2 * (size_t)BQ * DS * sizeof(T);
  static constexpr size_t stage = rows + 2 * BQ * sizeof(float);
  static constexpr size_t bytes = kv + 2 * stage + 2 * (size_t)BK * PS * 4;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy *bytes* (16 or 0: then 16 zero bytes) from global to shared memory
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four consecutive staged values as float32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 ld4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// two consecutive staged values as float32
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 ld2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// VW (2 or 4) consecutive staged values into out[0, VW)
template <int VW, typename T>
__device__ __forceinline__ void ldv(const T* p, float* out) {
  if constexpr (VW == 4) {
    const float4 x = ld4(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    const float2 x = ld2(p);
    out[0] = x.x; out[1] = x.y;
  }
}

__device__ __forceinline__ float lane_of(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// Stage rows [r0, r0 + R) of a (rows, d) tensor at *src* into shared
// memory at *dst* (row stride DS), zeros past *rows* and from d to DP.
// *vec*: d * sizeof(T) is a multiple of 16 and *src* is 16-byte aligned,
// so every 16-byte chunk of a padded row is copied by cp.async or zeroed;
// else plain loads and stores.
template <typename T, int R, int DP, int DS>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst,
                                           const T* __restrict__ src,
                                           int r0, int rows, int d,
                                           bool vec, int tid) {
  if (vec) {
    constexpr int EPC = 16 / (int)sizeof(T);   // values a chunk
    constexpr int CPR = DP / EPC;              // chunks a padded row
    for (int e = tid; e < R * CPR; e += kDkdvThreads) {
      const int r = e / CPR;
      const int c = (e - r * CPR) * EPC;
      const bool ok = r0 + r < rows && c < d;
      cp_async16(dst + r * DS + c, ok ? src + (size_t)(r0 + r) * d + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < R * DP; e += kDkdvThreads) {
      const int r = e / DP;
      const int c = e - r * DP;
      const bool ok = r0 + r < rows && c < d;
      dst[r * DS + c] = ok ? src[(size_t)(r0 + r) * d + c] : from_f<T>(0.f);
    }
  }
}

// acc[i][j] = a_row(ty + 16 i) . b_row(tx + 16 j) over DP, summed in
// order
template <typename T, int MI, int NJ, int DP, int DS>
__device__ __forceinline__ void dot_tile(const T* __restrict__ a,
                                         const T* __restrict__ b, int ty,
                                         int tx, float (&acc)[MI][NJ]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < DP; c += 4) {
    float4 x[MI], y[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) x[i] = ld4(a + (ty + 16 * i) * DS + c);
#pragma unroll
    for (int j = 0; j < NJ; ++j) y[j] = ld4(b + (tx + 16 * j) * DS + c);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
    }
  }
}

// Phase A of one q-tile: scores, p and ds of queries ty + 16 i against
// keys tx + 16 j, written to P^T and dS^T (key-major) as their values
// rounded to T.  MASKED: the tile straddles the causal diagonal or the
// ragged edge, so each score is masked (a masked score gives p = 0).
template <bool MASKED, typename T, int DP, int BK, int BQ>
__device__ __forceinline__ void dkdv_scores(
    const T* __restrict__ qs, const T* __restrict__ dos,
    const T* __restrict__ ks, const T* __restrict__ vs,
    const float* __restrict__ ls, const float* __restrict__ dls,
    float* __restrict__ pts, float* __restrict__ dsts, int tx, int ty,
    int q0, int k0, int sq, int sk, int off, int causal, float scale) {
  using S = DkdvSmem<T, DP, BK, BQ>;
  constexpr int MI = BQ / 16, NJ = BK / 16;
  float s[MI][NJ], dp[MI][NJ];
  dot_tile<T, MI, NJ, DP, S::DS>(qs, ks, ty, tx, s);
  dot_tile<T, MI, NJ, DP, S::DS>(dos, vs, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = ty + 16 * i;
    const float l = ls[r], dl = dls[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      bool ok = true;
      if (MASKED) {
        const int qi = q0 + r, kj = k0 + c;
        ok = qi < sq && kj < sk && (!causal || kj <= qi + off);
      }
      const float p = ok ? expf(s[i][j] * scale - l) : 0.f;
      const float ds = p * (dp[i][j] - dl) * scale;
      pts[c * S::PS + r] = round_to<T>(p);
      dsts[c * S::PS + r] = round_to<T>(ds);
    }
  }
}

// Phase B of one q-tile: dv += P^T dO and dk += dS^T Q for keys
// ty + 16 i and head dims c * 16 * VW + tx * VW + e, over the BQ queries
// in order.
template <typename T, int DP, int BK, int BQ, int VW>
__device__ __forceinline__ void dkdv_accumulate(
    const T* __restrict__ qs, const T* __restrict__ dos,
    const float* __restrict__ pts, const float* __restrict__ dsts, int tx,
    int ty, float (&dka)[BK / 16][DP / 16],
    float (&dva)[BK / 16][DP / 16]) {
  using S = DkdvSmem<T, DP, BK, BQ>;
  constexpr int NK = BK / 16, NV = DP / (16 * VW);
#pragma unroll 2
  for (int r = 0; r < BQ; r += 4) {
    float4 pa[NK], sa[NK];
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      pa[i] = ld4(pts + (ty + 16 * i) * S::PS + r);
      sa[i] = ld4(dsts + (ty + 16 * i) * S::PS + r);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        float o[VW], x[VW];
        ldv<VW>(dos + (r + u) * S::DS + c * 16 * VW + tx * VW, o);
        ldv<VW>(qs + (r + u) * S::DS + c * 16 * VW + tx * VW, x);
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          const float pu = lane_of(pa[i], u), su = lane_of(sa[i], u);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            dva[i][c * VW + e] = fmaf(pu, o[e], dva[i][c * VW + e]);
            dka[i][c * VW + e] = fmaf(su, x[e], dka[i][c * VW + e]);
          }
        }
      }
    }
  }
}

// One q-tile: phase A, a barrier, phase B.  *ls* holds lse, then delta.
template <bool MASKED, typename T, int DP, int BK, int BQ>
__device__ __forceinline__ void dkdv_step(
    const T* __restrict__ qs, const T* __restrict__ dos,
    const T* __restrict__ ks, const T* __restrict__ vs,
    const float* __restrict__ ls, float* __restrict__ pts,
    float* __restrict__ dsts, int tx, int ty, int q0, int k0, int sq,
    int sk, int off, int causal, float scale,
    float (&dka)[BK / 16][DP / 16], float (&dva)[BK / 16][DP / 16]) {
  dkdv_scores<MASKED, T, DP, BK, BQ>(qs, dos, ks, vs, ls, ls + BQ, pts,
                                     dsts, tx, ty, q0, k0, sq, sk, off,
                                     causal, scale);
  __syncthreads();
  dkdv_accumulate<T, DP, BK, BQ, dkdv_vw(DP)>(qs, dos, pts, dsts, tx, ty,
                                              dka, dva);
}

// dK and dV of keys [k0, k0 + BK) of one batch*head; see the note at the
// top.
template <typename T, int DP, int BK, int BQ>
__device__ __forceinline__ void dkdv_tile(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int bh, int k0, int sq, int sk,
    int d, float scale, int causal, int vec) {
  using S = DkdvSmem<T, DP, BK, BQ>;
  constexpr int VW = dkdv_vw(DP);
  constexpr int NK = BK / 16, ND = DP / 16;
  static_assert(BK % 16 == 0 && BQ % 16 == 0 && DP % (16 * VW) == 0,
                "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BK * S::DS;
  unsigned char* stages = smem + S::kv;
  float* pts = reinterpret_cast<float*>(stages + 2 * S::stage);
  float* dsts = pts + BK * S::PS;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);   // keys (A), dims (B)
  const int ty = (warp >> 1) * 4 + (lane >> 3); // queries (A), keys (B)
  const int off = sk - sq;
  const T* qb = q + (size_t)bh * sq * d;
  const T* dob = dout + (size_t)bh * sq * d;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;

  // q, dO, lse, delta of queries [q0, q0 + BQ) into stage *st*
  auto stage_tile = [&](int q0, int st) {
    T* qs = reinterpret_cast<T*>(stages + st * S::stage);
    T* dos = qs + BQ * S::DS;
    float* ls = reinterpret_cast<float*>(stages + st * S::stage + S::rows);
    stage_rows<T, BQ, DP, S::DS>(qs, qb, q0, sq, d, vec, tid);
    stage_rows<T, BQ, DP, S::DS>(dos, dob, q0, sq, d, vec, tid);
    if (tid < 2 * BQ) {   // lse at ls[r], delta at ls[BQ + r]
      const int r = tid % BQ;
      const bool ok = q0 + r < sq;
      const float* src = (tid < BQ ? lb : db) + (ok ? q0 + r : 0);
      cp_async4(ls + tid, src, ok ? 4 : 0);
    }
    cp_async_commit();
  };

  float dka[NK][ND], dva[NK][ND];
#pragma unroll
  for (int i = 0; i < NK; ++i)
#pragma unroll
    for (int c = 0; c < ND; ++c) dka[i][c] = dva[i][c] = 0.f;

  // under causal, query i sees key k0 iff k0 <= i + off: queries before
  // k0 - off see no key of this tile
  const int q_begin = causal ? max(0, k0 - off) : 0;
  if (q_begin < sq) {   // K, V ride in the first tile's cp.async group
    stage_rows<T, BK, DP, S::DS>(ks, k + (size_t)bh * sk * d, k0, sk, d,
                                 vec, tid);
    stage_rows<T, BK, DP, S::DS>(vs, v + (size_t)bh * sk * d, k0, sk, d,
                                 vec, tid);
    stage_tile(q_begin, 0);
  }
  int st = 0;
  for (int q0 = q_begin; q0 < sq; q0 += BQ, st ^= 1) {
    cp_async_wait_all();
    // this tile (and K, V) are in shared memory for every thread, and
    // every thread is done with the previous tile's stage and P^T, dS^T
    __syncthreads();
    if (q0 + BQ < sq) stage_tile(q0 + BQ, st ^ 1);
    const T* qs = reinterpret_cast<const T*>(stages + st * S::stage);
    const T* dos = qs + BQ * S::DS;
    const float* ls =
        reinterpret_cast<const float*>(stages + st * S::stage + S::rows);
    // the ragged edges, or under causal a query of the tile that does not
    // see the tile's last key
    const bool masked = q0 + BQ > sq || k0 + BK > sk ||
                        (causal && q0 + off < k0 + BK - 1);
    if (masked)
      dkdv_step<true, T, DP, BK, BQ>(qs, dos, ks, vs, ls, pts, dsts, tx, ty,
                                     q0, k0, sq, sk, off, causal, scale, dka,
                                     dva);
    else
      dkdv_step<false, T, DP, BK, BQ>(qs, dos, ks, vs, ls, pts, dsts, tx,
                                      ty, q0, k0, sq, sk, off, causal, scale,
                                      dka, dva);
  }

#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= sk) continue;
    const size_t base = ((size_t)bh * sk + kj) * d;
#pragma unroll
    for (int c = 0; c < ND / VW; ++c)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int dim = c * 16 * VW + tx * VW + e;
        if (dim < d) {
          dk[base + dim] = from_f<T>(dka[i][c * VW + e]);
          dv[base + dim] = from_f<T>(dva[i][c * VW + e]);
        }
      }
  }
}

// Grid (batch*head, k-tiles): blocks start in order of blockIdx.x fastest,
// so every head's first k-tile, the one most queries see under causal,
// starts before any later one.  A block takes k-tiles blockIdx.y,
// + gridDim.y, ... (more than one only past 65535 k-tiles).
template <typename T, int DP, int BK, int BQ>
__global__ void __launch_bounds__(kDkdvThreads, DkdvTile<DP>::MINB)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, int d, float scale,
                      int causal, int vec) {
  const int nk = (sk + BK - 1) / BK;
  for (int kt = blockIdx.y; kt < nk; kt += gridDim.y) {
    if (kt != (int)blockIdx.y) __syncthreads();   // shared memory is free
    dkdv_tile<T, DP, BK, BQ>(q, k, v, dout, lse, delta, dk, dv, blockIdx.x,
                             kt * BK, sq, sk, d, scale, causal, vec);
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// One block per (q-tile of BQ queries, batch*head).
template <typename T, int TPR>
__global__ void __launch_bounds__(kNT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, int d, float scale, int causal) {
  constexpr int BQ = kNT / TPR;   // queries a block owns
  constexpr int BK = kNT / TPR;   // keys staged per step
  constexpr int DPS = TPR > 1 ? kDPT + 4 : kDPT;
  constexpr int ROW = TPR * DPS;
  static_assert(BK % kCH == 0, "chunk must divide the k-tile");
  __shared__ __align__(16) float ks[BK * ROW];
  __shared__ __align__(16) float vs[BK * ROW];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int qi = q0 + row;
  const bool row_ok = qi < sq;
  const int off = sk - sq;
  const int qpos = qi + off;
  const size_t qbase = ((size_t)bh * sq + (row_ok ? qi : 0)) * d;
  const size_t kvbase = (size_t)bh * sk * d;

  float qr[kDPT], dor[kDPT], acc[kDPT];
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int c = part * kDPT + i;
    const bool ok = row_ok && c < d;
    qr[i] = ok ? to_f(q[qbase + c]) : 0.f;
    dor[i] = ok ? to_f(dout[qbase + c]) : 0.f;
    acc[i] = 0.f;
  }
  const float lse_i = row_ok ? lse[(size_t)bh * sq + qi] : 0.f;
  const float delta_i = row_ok ? delta[(size_t)bh * sq + qi] : 0.f;

  int k_end = sk;
  if (causal) {
    // last key visible to the tile's last row
    const int last = min(q0 + BQ, sq) - 1 + off;
    k_end = max(0, min(sk, last + 1));
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every row is done with the previous tile
    stage_pair<T, BK, TPR, DPS>(ks, vs, k, v, kvbase, k0, sk, d, tid);
    __syncthreads();

    for (int kk = 0; kk < BK; kk += kCH) {
      float s[kCH], dp[kCH];
#pragma unroll
      for (int j = 0; j < kCH; ++j) {
        const float4* kr =
            reinterpret_cast<const float4*>(ks + (kk + j) * ROW + part * DPS);
        const float4* vr =
            reinterpret_cast<const float4*>(vs + (kk + j) * ROW + part * DPS);
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int i = 0; i < kDPT / 4; ++i) {
          const float4 k4 = kr[i];
          const float4 v4 = vr[i];
          a = fmaf(qr[4 * i + 0], k4.x, a);
          a = fmaf(qr[4 * i + 1], k4.y, a);
          a = fmaf(qr[4 * i + 2], k4.z, a);
          a = fmaf(qr[4 * i + 3], k4.w, a);
          b = fmaf(dor[4 * i + 0], v4.x, b);
          b = fmaf(dor[4 * i + 1], v4.y, b);
          b = fmaf(dor[4 * i + 2], v4.z, b);
          b = fmaf(dor[4 * i + 3], v4.w, b);
        }
        s[j] = a;
        dp[j] = b;
      }
#pragma unroll
      for (int w = 1; w < TPR; w <<= 1) {
#pragma unroll
        for (int j = 0; j < kCH; ++j) {
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], w);
          dp[j] += __shfl_xor_sync(0xffffffffu, dp[j], w);
        }
      }

#pragma unroll
      for (int j = 0; j < kCH; ++j) {
        const int key = k0 + kk + j;
        const bool ok = row_ok && key < sk && (!causal || key <= qpos);
        const float p = ok ? expf(s[j] * scale - lse_i) : 0.f;
        const float dsr = round_to<T>(p * (dp[j] - delta_i) * scale);
        const float4* kr =
            reinterpret_cast<const float4*>(ks + (kk + j) * ROW + part * DPS);
#pragma unroll
        for (int i = 0; i < kDPT / 4; ++i) {
          const float4 k4 = kr[i];
          acc[4 * i + 0] = fmaf(dsr, k4.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(dsr, k4.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(dsr, k4.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(dsr, k4.w, acc[4 * i + 3]);
        }
      }
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int c = part * kDPT + i;
    if (c < d) dq[qbase + c] = from_f<T>(acc[i]);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  int bh, sq, sk, d;
  float scale;
  int causal;
  cudaStream_t stream;
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// DP: the padded head dim.  Raises the block's dynamic shared memory limit
// before every launch: the limit is per device, and the call is cheap next
// to the kernel.
template <typename T, int DP>
cudaError_t launch_dkdv(const Args& a, void* dk, void* dv) {
  constexpr int BK = DkdvTile<DP>::BK, BQ = DkdvTile<DP>::BQ;
  constexpr size_t bytes = DkdvSmem<T, DP, BK, BQ>::bytes;
  static_assert(bytes <= 232448, "shared memory of a block");
  auto kernel = flash_bwd_dkdv_kernel<T, DP, BK, BQ>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  const int vec = (a.d * sizeof(T)) % 16 == 0 && aligned16(a.q) &&
                  aligned16(a.k) && aligned16(a.v) && aligned16(a.dout);
  dim3 grid(a.bh, std::min((a.sk + BK - 1) / BK, 65535));
  kernel<<<grid, kDkdvThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.sq, a.sk, a.d,
      a.scale, a.causal, vec);
  return cudaGetLastError();
}

template <typename T, int TPR>
cudaError_t launch_dq(const Args& a, void* dq) {
  dim3 grid((a.sq + kNT / TPR - 1) / (kNT / TPR), a.bh);
  flash_bwd_dq_kernel<T, TPR><<<grid, kNT, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dq), a.sq, a.sk, a.d, a.scale, a.causal);
  return cudaGetLastError();
}

// the padded head dim: the least of 32, 64, 128, 256 that covers d
template <typename T>
cudaError_t dkdv_by_dim(const Args& a, void* dk, void* dv) {
  if (a.d <= 32) return launch_dkdv<T, 32>(a, dk, dv);
  if (a.d <= 64) return launch_dkdv<T, 64>(a, dk, dv);
  if (a.d <= 128) return launch_dkdv<T, 128>(a, dk, dv);
  return launch_dkdv<T, 256>(a, dk, dv);
}

// threads a row: the least power of two whose slices of kDPT cover d
template <typename T>
cudaError_t dq_by_dim(const Args& a, void* dq) {
  if (a.d <= kDPT) return launch_dq<T, 1>(a, dq);
  if (a.d <= 2 * kDPT) return launch_dq<T, 2>(a, dq);
  if (a.d <= 4 * kDPT) return launch_dq<T, 4>(a, dq);
  if (a.d <= 8 * kDPT) return launch_dq<T, 8>(a, dq);
  return launch_dq<T, 256 / kDPT>(a, dq);
}

bool bad_shape(int bh, int sq, int sk, int d) {
  return bh < 1 || bh > 65535 || sq < 1 || sk < 1 || d < 1 || d > 256;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  Every pointer is required.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv, int bh,
                              int sq, int sk, int d, float sm_scale,
                              int causal, int dtype, void* stream) {
  if (bad_shape(bh, sq, sk, d)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, bh, sq, sk, d, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)dkdv_by_dim<float>(a, dk, dv);
    case 1: return (int)dkdv_by_dim<__nv_bfloat16>(a, dk, dv);
    case 2: return (int)dkdv_by_dim<__half>(a, dk, dv);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int bh, int sq,
                            int sk, int d, float sm_scale, int causal,
                            int dtype, void* stream) {
  if (bad_shape(bh, sq, sk, d)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, bh, sq, sk, d, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)dq_by_dim<float>(a, dq);
    case 1: return (int)dq_by_dim<__nv_bfloat16>(a, dq);
    case 2: return (int)dq_by_dim<__half>(a, dq);
    default: return (int)cudaErrorInvalidValue;
  }
}
