// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel _flash_fwd_kernel (mxnet_tpu/ops/attention.py:164,
// launched by _flash_fwd_pallas, :252).  Same function: per (batch*head,
// query row), a stream over the keys with an online softmax whose running
// max m, sum l and output accumulator stay in float32; o = acc / l; an
// optional float32 lse = m + log(l).  Keys at or past seq_k are masked;
// under causal, query row i sees keys <= i + (seq_k - seq_q) (sequence ends
// aligned).  A masked score gives p = 0 outright, and a row that sees no
// key writes o = 0 and lse = +1e30.
//
// Layout: q (BH, Sq, D), k and v (BH, Sk, D), o like q, all contiguous and
// in one storage dtype (float32, bfloat16 or float16); lse float32 (BH, Sq).
//
// What bounds it on this card: at the serving shape (causal, S = 2048,
// D = 64) the work is 2 products of D multiply-adds per visible (query,
// key) pair against 4 tensors of reads and writes, ~128 flop per byte in
// f32: the operations bound it, not the bytes.  Three kernels, picked by a
// rule on dtype, head dim and alignment (route(), mirrored by
// attention._fwd_route):
// - bfloat16 / float16 with D <= 128, D % 8 == 0 and 16-byte aligned
//   bases: the tensor-core kernel (flash_fwd_tc_kernel, below), against
//   the 989 TFLOP/s of the tensor cores;
// - float32, and the 16-bit shapes off that route up to D = 256: the
//   register-tiled SIMT kernel (flash_fwd_kernel), exact f32 on the FMA
//   units (no TF32, no mma), against their 67 TFLOP/s; 16-bit values are
//   staged in their storage dtype;
// - D > 256: the wide kernel.
//
// The tensor-core kernel, designed for Hopper:
// - A persistent grid, one block an SM, walks (batch*head, q-tile) slots
//   in chunks of heads whose K and V fit in a third of L2, each chunk's
//   q-tiles heaviest first (the causal q-tiles that see the most keys).
//   A block is two consumer warpgroups of 64 query rows each (BQ = 128)
//   and a producer warpgroup, which gives its registers to the consumers
//   with setmaxnreg; one producer thread loads Q once a q-tile and streams
//   K and V tiles of BK keys through a ring of kTcStages stages with TMA
//   (3-d tensor maps, zeros past the tensor's rows and head dims, 128- or
//   64-byte swizzle), each stage's full and empty mbarriers handing it
//   between the producer and the consumers' warps.  The producer runs
//   ahead into the next q-tile while the consumers finish one.
// - Both products are wgmma.mma_async with f32 accumulators: S = Q K^T
//   with Q and K K-major in shared memory, O += P V with P in registers
//   and V read MN-major (wgmma's transpose, which it offers only for
//   16-bit types).  S's accumulator fragment is P's A fragment two
//   registers at a time, so P never leaves the registers.  These Hopper
//   pieces (mbarriers, TMA, descriptors, the wgmma wrappers, the
//   fragment packing, the tensor maps) live in hopper_tc.cuh, which
//   flash_bwd.cu's tensor-core dK/dV kernel shares.
// - The online softmax runs on the fragment: a row's max inside the
//   thread, then two __shfl_xor_sync across its quad, in log2 units;
//   p = exp2(s * scale * log2(e) - m) on the special-function unit; l sums
//   the unrounded p while P is p rounded to v's dtype (attention.py:206,
//   :212).  k-tile t's S = Q K^T runs beside k-tile t - 1's P V, and its
//   softmax while that P V finishes.
// - The same contract as below: causal aligns the sequence ends, only a
//   k-tile that straddles the diagonal or the ragged key edge takes the
//   per-score mask, k-tiles wholly above a warpgroup's last row are not
//   computed, a row that sees no key writes o = 0 and lse = +1e30, rows
//   past Sq are not stored, and there are no atomics.
//
// The register-tiled kernel: a SIMT product on a cp.async K/V stream (the
// shape of flash_bwd.cu's dkdv kernel, plus the online softmax's row max):
// - A block of 256 threads owns a q-tile of BQ queries of one batch*head.
//   Q is staged once; K and V tiles of BK keys are streamed with 16-byte
//   cp.async.cg, double-buffered: the copy of tile n+1 is in flight while
//   tile n is computed.  Staged tiles keep the storage dtype; rows and
//   head dims past the tensor are zero-filled by the src-size operand.  A
//   row whose bytes are not a multiple of 16, or a base that is not 16-byte
//   aligned, is staged by plain loads and stores instead.  Under causal
//   the stream stops at the last key the tile's last row can see, which
//   skips the k-tiles wholly above the diagonal.
// - Each warp owns BQ/8 query rows in both products.  Its lanes form a
//   4 x 8 grid: lane (ly, lx) holds rows ly + 4 i of the warp's rows, keys
//   lx + 8 j of S = Q K^T (a register micro-tile, as a SIMT SGEMM does),
//   then head dims 32 c + 4 lx + e of O.  The row max is taken inside the
//   thread, then by __shfl_xor_sync across the 8 lanes of the row, and
//   kept in log2 units, so each p is one FMA and one exp2; each lane
//   keeps its own part of the row sum l, summed across the lanes once at
//   the end.  p = exp(s * scale - m_new) is rounded to v's dtype and
//   written to the warp's own rows of a P buffer in shared memory, while l
//   sums the unrounded p (as attention.py:204-213 does); after
//   __syncwarp, O = O * alpha + P V.  m, l, alpha and O stay in registers,
//   because the same lanes own the same rows in both products; the only
//   block barriers are the K/V stage handoffs, one a k-tile.
// - Rows are padded by 16 bytes and the P buffer by 8 floats, so every
//   shared-memory read of a micro-tile is one conflict-free wavefront or a
//   broadcast.  At D = 64 (BQ = 128, BK = 64, 4 x 8 micro-tiles in both
//   products) that is one 16-byte read (f32) for every 10.7 FMAs.  Of the
//   shapes timed at the serving shape (BQ x BK x blocks an SM: 128 x 64 x
//   1, 128 x 32 x 1 and 2, 64 x 64 x 1 and 2) 128 x 64 x 1 was the
//   fastest; both loops are unrolled four times: twice, or fully, ran
//   slower (PERF.md, tools/torch_flash_fwd_tiles.py).
// - Only a k-tile that straddles the causal diagonal or the ragged key
//   edge takes the per-score mask; the others run an unmasked
//   instantiation.  Rows past Sq compute on zeros and are not stored.
// - Blocks start heaviest first: grid (batch*head, q-tile) with the q-tile
//   counted from the end, so under causal every head's last q-tile, which
//   sees the most keys, starts before any lighter one.  batch*head on
//   grid.x takes up to 2**31 - 1; past 65535 q-tiles a block strides.
// - No atomics: each output is summed by one thread in key order, so a
//   relaunch gives the same bits, with or without lse.
//
// Head dims past 256 (up to kMaxHeadDim): a simple kernel, one warp a
// query row, 4 warps a block.  The row's q and its float32 output sum live
// in dynamic shared memory with the head dim strided across the lanes; K
// and V are streamed one row at a time from global memory with coalesced
// reads; each score is a lane's partial sum plus five __shfl_xor_sync,
// which leave the same bits in every lane.  The same online softmax, one
// key at a time: m moves only on a visible key, the sum is rescaled only
// when m grows, p is rounded to v's dtype against the running max and l
// sums the unrounded p.  The speed is not tuned (PERF.md).

#include <cuda.h>   // CUtensorMap; the driver function comes through the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

#include "hopper_tc.cuh"

namespace {

using namespace hopper_tc;

constexpr float kNegInf = -1e30f;   // the masked-score sentinel (_NEG_INF)
constexpr int kThreads = 256;       // 8 warps
constexpr int kWarps = kThreads / 32;

// the largest head dim the kernels take (flash_bwd.cu's bound, set by its
// wide dK/dV block's shared memory)
constexpr int kMaxHeadDim = 2048;
constexpr int kWideWarps = 4;                  // query rows a wide block
constexpr int kWideThreads = 32 * kWideWarps;
constexpr float kLog2e = 1.44269504088896341f;

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

// p in v's storage dtype for the P.V product (identity for float32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// queries a block owns (BQ) and keys a streamed tile (BK), by padded head
// dim: O's micro-tile (BQ/32 rows x DP/8 dims) stays at or below 32
// registers and shared memory within the 227 KB of a block
template <int DP> struct FwdTile;
template <> struct FwdTile<32> { static constexpr int BQ = 128, BK = 64; };
template <> struct FwdTile<64> { static constexpr int BQ = 128, BK = 64; };
template <> struct FwdTile<128> { static constexpr int BQ = 64, BK = 64; };
template <> struct FwdTile<256> { static constexpr int BQ = 32, BK = 32; };

// Shared memory of one block: Q (BQ rows), two stages of (K, V: BK rows
// each), then P (BQ rows of BK floats).  Rows are padded by 16 bytes;
// every region starts 16-byte aligned.
template <typename T, int DP, int BQ, int BK>
struct FwdSmem {
  static constexpr int DS = DP + 16 / (int)sizeof(T);   // row stride, in T
  static constexpr int PS = BK + 8;                     // P row stride
  static constexpr size_t q = (size_t)BQ * DS * sizeof(T);
  static constexpr size_t stage = 2 * (size_t)BK * DS * sizeof(T);
  static constexpr size_t bytes = q + 2 * stage + (size_t)BQ * PS * 4;
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
    for (int e = tid; e < R * CPR; e += kThreads) {
      const int r = e / CPR;
      const int c = (e - r * CPR) * EPC;
      const bool ok = r0 + r < rows && c < d;
      cp_async16(dst + r * DS + c, ok ? src + (size_t)(r0 + r) * d + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < R * DP; e += kThreads) {
      const int r = e / DP;
      const int c = e - r * DP;
      const bool ok = r0 + r < rows && c < d;
      dst[r * DS + c] = ok ? src[(size_t)(r0 + r) * d + c] : from_f<T>(0.f);
    }
  }
}

// One k-tile of keys [k0, k0 + BK) for the warp's rows r0 + ly + 4 i:
// S = Q K^T, the online softmax update of m, l (this lane's part) and O,
// P through the warp's rows of *ps*.  *scale2* is the softmax scale times
// log2(e), and m is kept in those units: p = exp2(s * scale2 - m) is one
// FMA and one exp2 (the same function as exp(s * scale - m / log2(e))).
// MASKED: the k-tile straddles the causal diagonal or the ragged key
// edge, so each score is masked.
template <bool MASKED, typename T, int DP, int BQ, int BK>
__device__ __forceinline__ void fwd_step(
    const T* __restrict__ qs, const T* __restrict__ ks,
    const T* __restrict__ vs, float* __restrict__ ps, int r0, int lx,
    int ly, int q0, int k0, int sk, int off, int causal, float scale2,
    float (&m)[BQ / 32], float (&l)[BQ / 32], float (&o)[BQ / 32][DP / 8]) {
  using S = FwdSmem<T, DP, BQ, BK>;
  constexpr int MI = BQ / 32, NJ = BK / 8, NV = DP / 32;
  float s[MI][NJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 x[MI], y[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) x[i] = ld4(qs + (r0 + ly + 4 * i) * S::DS + c);
#pragma unroll
    for (int j = 0; j < NJ; ++j) y[j] = ld4(ks + (lx + 8 * j) * S::DS + c);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = r0 + ly + 4 * i;
    const int qpos = q0 + r + off;
    float mx = kNegInf;   // of the unscaled scores
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kj = k0 + lx + 8 * j;
      if (!MASKED || (kj < sk && (!causal || kj <= qpos)))
        mx = fmaxf(mx, s[i][j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = mx > kNegInf * 0.5f ? fmaxf(m[i], mx * scale2) : m[i];
    const float alpha = exp2f(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kj = k0 + lx + 8 * j;
      const bool ok = !MASKED || (kj < sk && (!causal || kj <= qpos));
      const float p = ok ? exp2f(fmaf(s[i][j], scale2, -m_new)) : 0.f;
      sum += p;
      ps[r * S::PS + lx + 8 * j] = round_to<T>(p);
    }
    l[i] = l[i] * alpha + sum;
    m[i] = m_new;
#pragma unroll
    for (int e = 0; e < DP / 8; ++e) o[i][e] *= alpha;
  }
  __syncwarp();   // the warp's rows of P are written

#pragma unroll 4
  for (int kk = 0; kk < BK; kk += 4) {
    float4 pa[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) pa[i] = ld4(ps + (r0 + ly + 4 * i) * S::PS + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const float4 w = ld4(vs + (kk + u) * S::DS + 32 * c + 4 * lx);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float pu = lane_of(pa[i], u);
          o[i][4 * c + 0] = fmaf(pu, w.x, o[i][4 * c + 0]);
          o[i][4 * c + 1] = fmaf(pu, w.y, o[i][4 * c + 1]);
          o[i][4 * c + 2] = fmaf(pu, w.z, o[i][4 * c + 2]);
          o[i][4 * c + 3] = fmaf(pu, w.w, o[i][4 * c + 3]);
        }
      }
    }
  }
}

// o (and lse) of queries [q0, q0 + BQ) of one batch*head; see the note at
// the top.
template <typename T, int DP, int BQ, int BK>
__device__ __forceinline__ void fwd_tile(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int bh, int q0, int sq, int sk, int d, float scale, int causal,
    int vec) {
  using S = FwdSmem<T, DP, BQ, BK>;
  constexpr int MI = BQ / 32, NV = DP / 32;
  static_assert(BQ % 32 == 0 && BK % 8 == 0 && DP % 32 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  unsigned char* stages = smem + S::q;
  float* ps = reinterpret_cast<float*>(stages + 2 * S::stage);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int lx = lane & 7, ly = lane >> 3;
  const int r0 = warp * (BQ / kWarps);   // the warp's first row
  const int off = sk - sq;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;

  // K and V of keys [k0, k0 + BK) into stage *st*
  auto stage_kv = [&](int k0, int st) {
    T* kd = reinterpret_cast<T*>(stages + st * S::stage);
    stage_rows<T, BK, DP, S::DS>(kd, kb, k0, sk, d, vec, tid);
    stage_rows<T, BK, DP, S::DS>(kd + BK * S::DS, vb, k0, sk, d, vec, tid);
    cp_async_commit();
  };

  float m[MI], l[MI], acc[MI][DP / 8];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DP / 8; ++e) acc[i][e] = 0.f;
  }

  int k_end = sk;
  if (causal) {
    // one past the last key visible to the tile's last row
    k_end = max(0, min(sk, min(q0 + BQ, sq) + off));
  }
  const int nk = (k_end + BK - 1) / BK;
  const float scale2 = scale * kLog2e;
  if (nk > 0) {   // Q rides in the first k-tile's cp.async group
    stage_rows<T, BQ, DP, S::DS>(qs, q + (size_t)bh * sq * d, q0, sq, d,
                                 vec, tid);
    stage_kv(0, 0);
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait_all();
    // this k-tile (and Q) are in shared memory for every thread, and
    // every warp is done with the previous k-tile's stage
    __syncthreads();
    if (t + 1 < nk) stage_kv((t + 1) * BK, (t + 1) & 1);
    const T* ks = reinterpret_cast<const T*>(stages + (t & 1) * S::stage);
    const T* vs = ks + BK * S::DS;
    const int k0 = t * BK;
    // the ragged key edge, or under causal a row of the tile that does
    // not see the k-tile's last key
    const bool masked = k0 + BK > sk || (causal && q0 + off < k0 + BK - 1);
    if (masked)
      fwd_step<true, T, DP, BQ, BK>(qs, ks, vs, ps, r0, lx, ly, q0, k0, sk,
                                    off, causal, scale2, m, l, acc);
    else
      fwd_step<false, T, DP, BQ, BK>(qs, ks, vs, ps, r0, lx, ly, q0, k0, sk,
                                     off, causal, scale2, m, l, acc);
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int qi = q0 + r0 + ly + 4 * i;
    if (qi >= sq) continue;
    const bool degenerate = m[i] <= kNegInf * 0.5f;
    const size_t base = ((size_t)bh * sq + qi) * d;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dim = 32 * c + 4 * lx + e;
        if (dim < d)
          o[base + dim] = from_f<T>(degenerate ? 0.f : acc[i][4 * c + e] / li);
      }
    if (lse != nullptr && lx == 0)
      lse[(size_t)bh * sq + qi] =
          degenerate ? 1e30f : m[i] * 0.693147180559945309f + logf(li);
  }
}

// Grid (batch*head, q-tiles): blocks start in order of blockIdx.x fastest,
// and blockIdx.y counts q-tiles from the last, so every head's heaviest
// q-tile under causal starts before any lighter one.  A block takes
// q-tiles blockIdx.y, + gridDim.y, ... (more than one only past 65535).
template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int d, float scale,
                 int causal, int vec) {
  const int nq = (sq + BQ - 1) / BQ;
  for (int j = blockIdx.y; j < nq; j += gridDim.y) {
    if (j != (int)blockIdx.y) __syncthreads();   // shared memory is free
    fwd_tile<T, DP, BQ, BK>(q, k, v, o, lse, blockIdx.x, (nq - 1 - j) * BQ,
                            sq, sk, d, scale, causal, vec);
  }
}

// the sum of x over the warp, the same bits in every lane
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

// o (and lse) of query rows counted from the last (under causal the
// heaviest first), blockIdx.y * 4 + warp, + gridDim.y * 4, ...; see the
// note at the top.  Shared memory a warp: q and o rows of d floats.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int d,
                      float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* qr = reinterpret_cast<float*>(smem) + (size_t)warp * 2 * d;
  float* acc = qr + d;
  const int bh = blockIdx.x;
  const float scale2 = scale * kLog2e;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;
  for (int r = blockIdx.y * kWideWarps + warp; r < sq;
       r += gridDim.y * kWideWarps) {
    const int qi = sq - 1 - r;
    const size_t base = ((size_t)bh * sq + qi) * d;
    // each lane reads and writes only its own dims c = lane + 32 t
    for (int c = lane; c < d; c += 32) {
      qr[c] = to_f(q[base + c]);
      acc[c] = 0.f;
    }
    // one past the last key the row sees
    const int k_end = causal ? max(0, min(sk, qi + sk - sq + 1)) : sk;
    float m = kNegInf, l = 0.f;   // m in log2 units, as the tiled kernel's
    for (int j = 0; j < k_end; ++j) {
      const T* kj = kb + (size_t)j * d;
      const T* vj = vb + (size_t)j * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s = fmaf(qr[c], to_f(kj[c]), s);
      s = warp_sum(s);
      const float m_new = fmaxf(m, s * scale2);
      if (m_new > m) {   // the same in every lane
        const float alpha = exp2f(m - m_new);
        l *= alpha;
        for (int c = lane; c < d; c += 32) acc[c] *= alpha;
        m = m_new;
      }
      const float p = exp2f(fmaf(s, scale2, -m));
      l += p;
      const float pr = round_to<T>(p);
      for (int c = lane; c < d; c += 32) acc[c] = fmaf(pr, to_f(vj[c]), acc[c]);
    }
    const bool degenerate = m <= kNegInf * 0.5f;
    for (int c = lane; c < d; c += 32)
      o[base + c] = from_f<T>(degenerate ? 0.f : acc[c] / l);
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * sq + qi] =
          degenerate ? 1e30f : m * 0.693147180559945309f + logf(l);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core kernel for 16-bit storage (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kTcConsumers = 2;                         // warpgroups
constexpr int kTcConsumerThreads = 128 * kTcConsumers;
constexpr int kTcBQ = 64 * kTcConsumers;                // queries a block
constexpr int kTcStages = 4;                            // the K/V ring
// + a producer warpgroup, which hands its registers to the consumers
// with setmaxnreg: each of the SM's four register files holds one warp of
// every warpgroup, so a block of 9 warps would cap all at 168 registers
constexpr int kTcThreads = kTcConsumerThreads + 128;
constexpr int kTcProducerRegs = 24;
constexpr int kTcConsumerRegs =
    (65536 / 128 - kTcProducerRegs) / kTcConsumers / 8 * 8;
// the K and V bytes of the heads whose blocks run together: a third of
// the card's 50 MB L2
constexpr long long kTcL2Bytes = 16LL << 20;

// keys a k-tile by padded head dim: at DP 128 a consumer thread holds O
// (64 f32) beside S (BK / 2 f32) and P (BK / 4 words)
template <int DP> struct TcTile;
template <> struct TcTile<32> { static constexpr int BK = 128; };
template <> struct TcTile<64> { static constexpr int BK = 128; };
template <> struct TcTile<128> { static constexpr int BK = 64; };

// Shared memory of one block, every tile in the layout TMA writes and
// wgmma reads: column blocks of CB values (SW bytes: the swizzle span),
// each holding every row of the tile at SW bytes a row, 16-byte chunks
// swizzled within 8-row atoms.  Q (kTcBQ rows), then kTcStages stages of
// K and V (BK rows each), then the mbarriers.  The base is 1024-aligned.
template <int DP, int BK>
struct TcSmem {
  static constexpr int SW = TcLayout<DP>::SW;
  static constexpr int CB = TcLayout<DP>::CB;
  static constexpr int NCB = TcLayout<DP>::NCB;
  static constexpr uint32_t q = kTcBQ * DP * 2;
  static constexpr uint32_t kv = BK * DP * 2;   // K (or V) of one stage
  static constexpr uint32_t stages = kTcStages * 2 * kv;
  static constexpr uint32_t bars = q + stages;  // full[], empty[], qfull, qempty
  static constexpr size_t bytes = 1024 + bars + 8 * (2 * kTcStages + 2);
};

// The online softmax of one k-tile of keys [k0, k0 + BK) on S's
// accumulator fragment, in place: s becomes p = exp2(s * scale2 - m_new)
// (0 where masked), m and l move, and alpha = exp2(m - m_new) is what O
// must be scaled by.  A thread holds rows rw and rw + 8 (i = 0, 1) of the
// warpgroup's 64 and of each group n of 8 keys the two at 8 n + 2 (lane %
// 4) + j: register 4 n + 2 i + j (the same for O's head dims).  *qpos0*
// is row rw's position among the keys.  MASKED: the k-tile straddles the
// causal diagonal or the ragged key edge.
template <bool MASKED, int BK>
__device__ __forceinline__ void tc_softmax(float (&s)[BK / 2], int lane,
                                           int qpos0, int k0, int sk,
                                           int causal, float scale2,
                                           float (&m)[2], float (&l)[2],
                                           float (&alpha)[2]) {
  const int kc = k0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qpos0 + 8 * i;
    // the max of the unscaled scores, and the sum below, in 4 chains
    float part[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = kc + 8 * n + j;
        if (!MASKED || (kj < sk && (!causal || kj <= qpos)))
          part[(2 * n + j) & 3] = fmaxf(part[(2 * n + j) & 3],
                                        s[4 * n + 2 * i + j]);
      }
    float mx = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = mx > kNegInf * 0.5f ? fmaxf(m[i], mx * scale2) : m[i];
    alpha[i] = ex2(m[i] - m_new);
#pragma unroll
    for (int c = 0; c < 4; ++c) part[c] = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = kc + 8 * n + j;
        const bool ok = !MASKED || (kj < sk && (!causal || kj <= qpos));
        float& x = s[4 * n + 2 * i + j];
        x = ok ? ex2(fmaf(x, scale2, -m_new)) : 0.f;
        part[(2 * n + j) & 3] += x;
      }
    l[i] = l[i] * alpha[i] + ((part[0] + part[1]) + (part[2] + part[3]));
    m[i] = m_new;
  }
}

// A persistent block takes slots blockIdx.x, + gridDim.x, ... of the
// nbh * ceil(sq / kTcBQ) (batch*head, q-tile) slots (see tile() below).
// Its first kTcConsumers warpgroups are consumers of 64 query rows each;
// the first thread after them is the producer, which loads Q once a
// q-tile and streams K and V through a ring of kTcStages stages with TMA:
// full[s] completes when a stage's bytes have landed, empty[s] when every
// consumer warp is done with it; qfull and qempty do the same for Q.
template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    T* __restrict__ o, float* __restrict__ lse, int nbh,
                    int sq, int sk, int d, float scale, int causal,
                    int group) {
  using S = TcSmem<DP, BK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t qs = base;
  const uint32_t bars = base + S::bars;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kTcStages + st); };
  const uint32_t qfull = bars + 16 * kTcStages;
  const uint32_t qempty = qfull + 8;
  auto kst = [&](int st) { return base + S::q + st * 2 * S::kv; };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kTcConsumers * 4);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, kTcConsumers * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nq = (sq + kTcBQ - 1) / kTcBQ;
  const int off = sk - sq;
  const long long tiles = (long long)nbh * nq;
  // The (batch*head, q-tile) of a slot: slots run through chunks of
  // *group* heads, each chunk's q-tiles heaviest first, so that the K and
  // V the blocks in flight read fit in L2.  Returns q0, sets *head*.
  auto tile = [&](long long slot, int& head) {
    const long long per = (long long)group * nq;
    const long long chunk = slot / per;
    const long long r = slot - chunk * per;
    const int heads = (int)min((long long)group, nbh - chunk * group);
    head = (int)(chunk * group + r % heads);
    return (nq - 1 - (int)(r / heads)) * kTcBQ;
  };
  // one past the last key the q-tile at q0 needs, in k-tiles
  auto k_tiles = [&](int q0) {
    const int k_end =
        causal ? max(0, min(sk, min(q0 + kTcBQ, sq) + off)) : sk;
    return (k_end + BK - 1) / BK;
  };

  if (tid >= kTcConsumerThreads) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kTcProducerRegs));
    if (tid != kTcConsumerThreads) return;
    int it = 0, jt = 0;
    for (long long slot = blockIdx.x; slot < tiles; slot += gridDim.x) {
      int bh;
      const int q0 = tile(slot, bh);
      const int nk = k_tiles(q0);
      if (nk == 0) continue;
      mbar_wait(qempty, (jt & 1) ^ 1);
      mbar_expect_tx(qfull, S::q);
#pragma unroll
      for (int c = 0; c < S::NCB; ++c)
        tma_load(qs + c * (kTcBQ * S::SW), &qmap, qfull, c * S::CB, q0, bh);
      ++jt;
      for (int t = 0; t < nk; ++t, ++it) {
        const int st = it % kTcStages;
        mbar_wait(empty(st), ((it / kTcStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * S::kv);
#pragma unroll
        for (int c = 0; c < S::NCB; ++c) {
          tma_load(kst(st) + c * (BK * S::SW), &kmap, full(st), c * S::CB,
                   t * BK, bh);
          tma_load(kst(st) + S::kv + c * (BK * S::SW), &vmap, full(st),
                   c * S::CB, t * BK, bh);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kTcConsumerRegs));
  const int g = tid >> 7;                 // the consumer warpgroup
  const int w = (tid >> 5) & 3, lane = tid & 31;
  const int rw = 16 * w + (lane >> 2);    // the thread's first row of 64
  const float scale2 = scale * kLog2e;
  // a warp is done with a stage (or Q): one arrival for its 32 threads,
  // after its wgmma.wait_group, which all of them execute together
  auto release = [&](uint32_t bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  int it = 0, jt = 0;   // k-tiles and q-tiles taken so far
  for (long long slot = blockIdx.x; slot < tiles; slot += gridDim.x) {
    int bh;
    const int q0 = tile(slot, bh);
    const int q0w = q0 + 64 * g;          // the warpgroup's first row
    const int nk = k_tiles(q0);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[DP / 2];
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;
    if (nk > 0) {
      mbar_wait(qfull, jt & 1);
      ++jt;
      const uint32_t qw = qs + 64 * g * S::SW;
      // k-tiles the warpgroup computes: under causal, one past the last
      // key its last row sees changes nothing and is skipped
      const int last = q0w + 63 + off;
      const int nkw = causal ? min(nk, last < 0 ? 0 : last / BK + 1) : nk;
      auto stage = [&](int t) { return kst((it + t) % kTcStages); };
      auto wait_full = [&](int t) {
        mbar_wait(full((it + t) % kTcStages), ((it + t) / kTcStages) & 1);
      };
      float sc[BK / 2], alpha[2];
      uint32_t p[BK / 16][4];
      auto softmax = [&](int t) {
        const int k0 = t * BK;
        if (k0 + BK > sk || (causal && q0w + off < k0 + BK - 1))
          tc_softmax<true, BK>(sc, lane, q0w + rw + off, k0, sk, causal,
                               scale2, m, l, alpha);
        else
          tc_softmax<false, BK>(sc, lane, q0w + rw + off, k0, sk, causal,
                                scale2, m, l, alpha);
      };
      if (nkw > 0) {
        wait_full(0);
        wgmma_fence();
        tc_qk<T, DP, BK, kTcBQ>(qw, stage(0), sc);
        wgmma_wait0();
        reg_fence(sc);
        softmax(0);   // O is 0: alpha is not needed
        tc_pack<T, BK>(sc, p);
        // k-tile t's S = Q K^T runs on the tensor cores beside k-tile
        // t - 1's O += P V; its softmax runs while P V finishes
        for (int t = 1; t < nkw; ++t) {
          wait_full(t);
          reg_fence(sc);
          reg_fence(p);
          reg_fence(acc);
          wgmma_fence();
          tc_qk<T, DP, BK, kTcBQ>(qw, stage(t), sc);
          tc_pv<T, DP, BK>(stage(t - 1) + S::kv, p, acc);
          wgmma_wait1();
          reg_fence(sc);
          softmax(t);
          wgmma_wait0();
          reg_fence(acc);
          release(empty((it + t - 1) % kTcStages));
#pragma unroll
          for (int e = 0; e < DP / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
          tc_pack<T, BK>(sc, p);
        }
        // every S = Q K^T of the q-tile is done: the producer may load
        // the next q-tile's Q
        release(qempty);
        reg_fence(p);
        reg_fence(acc);
        wgmma_fence();
        tc_pv<T, DP, BK>(stage(nkw - 1) + S::kv, p, acc);
        wgmma_wait0();
        reg_fence(acc);
        release(empty((it + nkw - 1) % kTcStages));
      } else {
        release(qempty);
      }
      // a skipped k-tile is released once it has landed, so that the
      // arrival counts toward its own phase of the stage's barrier
      for (int t = nkw; t < nk; ++t) {
        wait_full(t);
        release(empty((it + t) % kTcStages));
      }
      it += nk;
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int qi = q0w + rw + 8 * i;
      if (qi >= sq) continue;
      const bool degenerate = m[i] <= kNegInf * 0.5f;
      const float inv = degenerate ? 0.f : 1.f / li;
      T* row = o + ((size_t)bh * sq + qi) * d;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = 8 * n + 2 * (lane & 3);
        if (col < d)   // d % 8 == 0: the pair is whole
          *reinterpret_cast<uint32_t*>(row + col) = pack2<T>(
              acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
      }
      if (lse != nullptr && (lane & 3) == 0)
        lse[(size_t)bh * sq + qi] =
            degenerate ? 1e30f : m[i] * 0.693147180559945309f + logf(li);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      void* lse, int bh, int sq, int sk, int d, float scale,
                      int causal, cudaStream_t stream) {
  constexpr int BK = TcTile<DP>::BK;
  using S = TcSmem<DP, BK>;
  static_assert(S::bytes <= 232448, "shared memory of a block");
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap qm, km, vm;
  memset(&km, 0, sizeof(km));
  memset(&vm, 0, sizeof(vm));
  cudaError_t err = tensor_map(&qm, q, bf16, bh, sq, d, kTcBQ, S::CB, S::SW);
  if (err == cudaSuccess && sk > 0)   // sk == 0: no k-tile is loaded
    err = tensor_map(&km, k, bf16, bh, sk, d, BK, S::CB, S::SW);
  if (err == cudaSuccess && sk > 0)
    err = tensor_map(&vm, v, bf16, bh, sk, d, BK, S::CB, S::SW);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_tc_kernel<T, DP, BK>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::bytes);
  if (err != cudaSuccess) return err;
  // heads a chunk: their K and V within kTcL2Bytes
  const int group = (int)std::max<long long>(
      1, std::min<long long>(bh, kTcL2Bytes / (4LL * std::max(sk, 1) * d)));
  // one block an SM, each walking the slots blockIdx.x, + gridDim.x, ...
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)bh * ((sq + kTcBQ - 1) / kTcBQ);
  kernel<<<(unsigned)std::min<long long>(tiles, sms), kTcThreads, S::bytes,
           stream>>>(qm, km, vm, static_cast<T*>(o),
                     static_cast<float*>(lse), bh, sq, sk, d, scale, causal,
                     group);
  return cudaGetLastError();
}

// DP: the padded head dim.  Raises the block's dynamic shared memory limit
// before every launch: the limit is per device, and the call is cheap next
// to the kernel.
template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int sq, int sk, int d, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int BQ = FwdTile<DP>::BQ, BK = FwdTile<DP>::BK;
  constexpr size_t bytes = FwdSmem<T, DP, BQ, BK>::bytes;
  static_assert(bytes <= 232448, "shared memory of a block");
  auto kernel = flash_fwd_kernel<T, DP, BQ, BK>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  const int vec = (d * sizeof(T)) % 16 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v);
  dim3 grid(bh, std::min((sq + BQ - 1) / BQ, 65535));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sq, sk, d, scale, causal, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        void* o, void* lse, int bh, int sq, int sk, int d,
                        float scale, int causal, cudaStream_t stream) {
  const size_t bytes = (size_t)kWideWarps * 2 * d * sizeof(float);
  auto kernel = flash_fwd_wide_kernel<T>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid(bh, std::min((sq + kWideWarps - 1) / kWideWarps, 65535));
  kernel<<<grid, kWideThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sq, sk, d, scale, causal);
  return cudaGetLastError();
}

// the padded head dim: the least of 32, 64, 128 (and 256 off the tensor
// cores) that covers d; past 256 the wide kernel
template <typename T>
cudaError_t by_dim(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int sq, int sk, int d, float scale,
                   int causal, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    if (route(d, 1, aligned16(q) && aligned16(k) && aligned16(v)) ==
        kRouteWgmma) {
      if (d <= 32)
        return launch_tc<T, 32>(q, k, v, o, lse, bh, sq, sk, d, scale, causal,
                                stream);
      if (d <= 64)
        return launch_tc<T, 64>(q, k, v, o, lse, bh, sq, sk, d, scale, causal,
                                stream);
      return launch_tc<T, 128>(q, k, v, o, lse, bh, sq, sk, d, scale, causal,
                               stream);
    }
  }
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, lse, bh, sq, sk, d, scale, causal, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, bh, sq, sk, d, scale, causal, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, lse, bh, sq, sk, d, scale, causal,
                          stream);
  if (d <= 256)
    return launch<T, 256>(q, k, v, o, lse, bh, sq, sk, d, scale, causal,
                          stream);
  return launch_wide<T>(q, k, v, o, lse, bh, sq, sk, d, scale, causal,
                        stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  lse may be null.  batch*head
// goes up to 2**31 - 1 (grid.x), d up to kMaxHeadDim (2048).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int sq, int sk, int d,
                         float sm_scale, int causal, int dtype,
                         void* stream) {
  if (bh < 1 || sq < 1 || sk < 0 || d < 1 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)by_dim<float>(q, k, v, o, lse, bh, sq, sk, d, sm_scale,
                                causal, st);
    case 1:
      return (int)by_dim<__nv_bfloat16>(q, k, v, o, lse, bh, sq, sk, d,
                                        sm_scale, causal, st);
    case 2:
      return (int)by_dim<__half>(q, k, v, o, lse, bh, sq, sk, d, sm_scale,
                                 causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The route a launch with this head dim, dtype (as flash_fwd takes it)
// and 16-byte alignment of all three bases takes: 0 the register-tiled
// kernel, 1 the wide kernel, 2 the tensor-core kernel.
extern "C" int flash_fwd_route(int d, int dtype, int aligned) {
  return route(d, dtype, aligned != 0);
}
