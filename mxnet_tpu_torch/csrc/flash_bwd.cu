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
// the bytes.  f32 stays exact f32 (no TF32): the ceiling is the 67 TFLOP/s
// of the FMA units.
//
// Design (simple and right first; mma/wgmma and TMA are later work):
// - Two kernels and no atomics, as on the TPU: dkdv owns a k-tile and
//   streams the q-tiles, dq owns a q-tile and streams the k-tiles.  Each
//   output element is summed by one thread in a fixed order, so the result
//   is the same from run to run.
// - A row (a key in dkdv, a query in dq) is owned by TPR threads, each
//   holding DPT = 32 of the head dims.  dkdv holds k, v, dk and dv of its
//   key (4 * 32 floats a thread): at D = 64 one thread per row would hold
//   256 floats and spill, so D <= 32 uses one thread a row, D <= 64 two,
//   D <= 128 four, D <= 256 eight; partial dot products are summed with
//   warp shuffles.  dq holds q, dO and dq (3 * 32 floats).
// - The streamed tile (q and dO with their lse and delta in dkdv; k and v
//   in dq) is staged once in shared memory as float32 and read by every
//   row of the block: the threads of a warp read the same streamed row, so
//   the reads are broadcasts.  Slices of different threads are offset by
//   4 floats so they start in different banks.
// - Scores are taken CH = 2 streamed rows at a time (2 * 2 independent dot
//   products, then the 2 updates).  More rows per chunk let ptxas hoist
//   the chunk's shared-memory loads past the register file: with CH = 8
//   every variant of two or more threads a row spilled kilobytes a thread
//   (ptxas -v) and dkdv ran an order of magnitude slower (PERF.md).
// - Causal skips: dkdv starts at the first query that can see the k-tile
//   (the skip of attention.py:368-370, turned around); dq stops at the
//   last key the q-tile's last row can see, as flash_fwd does.
// - Ragged Sq and Sk, and D below the slice width, are masked in-kernel;
//   nothing is padded or copied.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stddef.h>

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

// One block per (k-tile of BK keys, batch*head).
template <typename T, int TPR>
__global__ void __launch_bounds__(kNT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, int d, float scale,
                      int causal) {
  constexpr int BK = kNT / TPR;   // keys a block owns
  constexpr int BQ = kNT / TPR;   // queries staged per step
  constexpr int DPS = TPR > 1 ? kDPT + 4 : kDPT;
  constexpr int ROW = TPR * DPS;
  static_assert(BQ % kCH == 0, "chunk must divide the q-tile");
  __shared__ __align__(16) float qs[BQ * ROW];
  __shared__ __align__(16) float dos[BQ * ROW];
  __shared__ float lses[BQ];
  __shared__ float dels[BQ];

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int kj = k0 + row;
  const bool row_ok = kj < sk;
  const int off = sk - sq;
  const size_t kbase = ((size_t)bh * sk + (row_ok ? kj : 0)) * d;
  const size_t qbase = (size_t)bh * sq * d;
  const size_t rbase = (size_t)bh * sq;

  float kr[kDPT], vr[kDPT], dka[kDPT], dva[kDPT];
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int c = part * kDPT + i;
    const bool ok = row_ok && c < d;
    kr[i] = ok ? to_f(k[kbase + c]) : 0.f;
    vr[i] = ok ? to_f(v[kbase + c]) : 0.f;
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  // under causal, query i sees key k0 iff k0 <= i + off: queries before
  // k0 - off see no key of this tile
  const int q_begin = causal ? max(0, k0 - off) : 0;

  for (int q0 = q_begin; q0 < sq; q0 += BQ) {
    __syncthreads();  // every row is done with the previous tile
    stage_pair<T, BQ, TPR, DPS>(qs, dos, q, dout, qbase, q0, sq, d, tid);
    for (int r = tid; r < BQ; r += kNT) {
      const bool ok = q0 + r < sq;
      lses[r] = ok ? lse[rbase + q0 + r] : 0.f;
      dels[r] = ok ? delta[rbase + q0 + r] : 0.f;
    }
    __syncthreads();

    for (int jj = 0; jj < BQ; jj += kCH) {
      float s[kCH], dp[kCH];
#pragma unroll
      for (int j = 0; j < kCH; ++j) {
        const float4* qr =
            reinterpret_cast<const float4*>(qs + (jj + j) * ROW + part * DPS);
        const float4* dr =
            reinterpret_cast<const float4*>(dos + (jj + j) * ROW + part * DPS);
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int i = 0; i < kDPT / 4; ++i) {
          const float4 q4 = qr[i];
          const float4 d4 = dr[i];
          a = fmaf(q4.x, kr[4 * i + 0], a);
          a = fmaf(q4.y, kr[4 * i + 1], a);
          a = fmaf(q4.z, kr[4 * i + 2], a);
          a = fmaf(q4.w, kr[4 * i + 3], a);
          b = fmaf(d4.x, vr[4 * i + 0], b);
          b = fmaf(d4.y, vr[4 * i + 1], b);
          b = fmaf(d4.z, vr[4 * i + 2], b);
          b = fmaf(d4.w, vr[4 * i + 3], b);
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
        const int qi = q0 + jj + j;
        const bool ok = row_ok && qi < sq && (!causal || kj <= qi + off);
        const float p = ok ? expf(s[j] * scale - lses[jj + j]) : 0.f;
        const float ds = p * (dp[j] - dels[jj + j]) * scale;
        const float pr = round_to<T>(p);
        const float dsr = round_to<T>(ds);
        const float4* qr =
            reinterpret_cast<const float4*>(qs + (jj + j) * ROW + part * DPS);
        const float4* dr =
            reinterpret_cast<const float4*>(dos + (jj + j) * ROW + part * DPS);
#pragma unroll
        for (int i = 0; i < kDPT / 4; ++i) {
          const float4 q4 = qr[i];
          const float4 d4 = dr[i];
          dva[4 * i + 0] = fmaf(pr, d4.x, dva[4 * i + 0]);
          dva[4 * i + 1] = fmaf(pr, d4.y, dva[4 * i + 1]);
          dva[4 * i + 2] = fmaf(pr, d4.z, dva[4 * i + 2]);
          dva[4 * i + 3] = fmaf(pr, d4.w, dva[4 * i + 3]);
          dka[4 * i + 0] = fmaf(dsr, q4.x, dka[4 * i + 0]);
          dka[4 * i + 1] = fmaf(dsr, q4.y, dka[4 * i + 1]);
          dka[4 * i + 2] = fmaf(dsr, q4.z, dka[4 * i + 2]);
          dka[4 * i + 3] = fmaf(dsr, q4.w, dka[4 * i + 3]);
        }
      }
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int c = part * kDPT + i;
    if (c < d) {
      dk[kbase + c] = from_f<T>(dka[i]);
      dv[kbase + c] = from_f<T>(dva[i]);
    }
  }
}

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

template <typename T, int TPR>
cudaError_t launch_dkdv(const Args& a, void* dk, void* dv) {
  dim3 grid((a.sk + kNT / TPR - 1) / (kNT / TPR), a.bh);
  flash_bwd_dkdv_kernel<T, TPR><<<grid, kNT, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.sq, a.sk, a.d,
      a.scale, a.causal);
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

// threads a row: the least power of two whose slices of kDPT cover d
template <typename T>
cudaError_t dkdv_by_dim(const Args& a, void* dk, void* dv) {
  if (a.d <= kDPT) return launch_dkdv<T, 1>(a, dk, dv);
  if (a.d <= 2 * kDPT) return launch_dkdv<T, 2>(a, dk, dv);
  if (a.d <= 4 * kDPT) return launch_dkdv<T, 4>(a, dk, dv);
  if (a.d <= 8 * kDPT) return launch_dkdv<T, 8>(a, dk, dv);
  return launch_dkdv<T, 256 / kDPT>(a, dk, dv);
}

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
