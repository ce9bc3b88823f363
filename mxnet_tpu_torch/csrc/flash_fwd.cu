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
// f32: the operations bound it, not the bytes.  f32 stays exact f32 on the
// FMA units (no TF32, no mma): the ceiling is their 67 TFLOP/s, and the
// 16-bit dtypes run the same code on values staged in their storage dtype.
//
// Design, a register-tiled SIMT product on a cp.async K/V stream (the
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// the padded head dim: the least of 32, 64, 128, 256 that covers d; past
// 256 the wide kernel
template <typename T>
cudaError_t by_dim(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int sq, int sk, int d, float scale,
                   int causal, cudaStream_t stream) {
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
