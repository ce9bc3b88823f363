// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel _flash_fwd_kernel (mxnet_tpu/ops/attention.py:164,
// launched by _flash_fwd_pallas, :252).  Same function: per (batch*head,
// query row), a stream over the keys with an online softmax whose running
// max m, sum l and output accumulator stay in float32; o = acc / l; an
// optional float32 lse = m + log(l).  Keys at or past seq_k are masked;
// under causal, query row i sees keys <= i + (seq_k - seq_q) (sequence ends
// aligned).  A row that sees no key writes o = 0 and lse = +1e30.
//
// Layout: q (BH, Sq, D), k and v (BH, Sk, D), o like q, all contiguous and
// in one storage dtype (float32, bfloat16 or float16); lse float32 (BH, Sq).
//
// What bounds it on this card: at the serving shape (causal, S = 2048,
// D = 64) the work is ~4*D multiply-adds per visible (query, key) pair
// against 4 tensors of reads/writes, ~128 flop/byte in f32: the operations
// bound it, not the bytes.  f32 stays exact f32 (no TF32), so the ceiling
// is the 67 TFLOP/s of the FMA units, not the tensor cores.
//
// Design (simple and right first; mma/wgmma and TMA are later work):
// - One thread block per (q-tile of BQ rows, batch*head); the loop over
//   k-tiles inside the block replaces the TPU's sequential grid axis.
// - Each query row is owned by TPR threads, each holding DPT = 64 of the
//   head dims of q and of the accumulator in registers, so no score or
//   output ever goes to device memory.  D <= 64 uses one thread per row,
//   D <= 128 two, D <= 256 four (partial dot products are summed with
//   warp shuffles).  The head dim is not padded in memory: loads and
//   stores are masked at D.
// - A k-tile of BK keys of K and V is staged once in shared memory as
//   float32 and read by every row of the q-tile: the threads of a warp
//   read the same key, so shared-memory reads are broadcasts.
// - Scores are taken CH = 16 keys at a time: one rescale of the
//   accumulator per chunk, 16 independent dot products for ILP.
// - Under causal the k-loop stops at the last key the tile's last row
//   can see, which skips the k-tiles wholly above the diagonal.
// - Ragged Sq and Sk are masked in-kernel; nothing is padded or copied.
// - bf16 and f16 load in their storage dtype and accumulate in f32; p is
//   rounded to v's dtype before the P.V product, as the TPU kernel does
//   (attention.py:211-213), while l sums the unrounded p.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;   // the masked-score sentinel (_NEG_INF)

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

template <typename T, int DPT, int TPR, int BQ, int BK, int CH>
__global__ void __launch_bounds__(BQ * TPR)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int d,
                 float scale, int causal) {
  constexpr int NT = BQ * TPR;
  // a thread's slice of a staged key row; slices of different threads
  // are offset by 4 floats so they start in different banks
  constexpr int DPS = TPR > 1 ? DPT + 4 : DPT;
  constexpr int ROW = TPR * DPS;
  static_assert(BK % CH == 0, "chunk must divide the k-tile");
  static_assert(DPT % 4 == 0, "slices are read as float4");
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

  float qr[DPT];
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int c = part * DPT + i;
    qr[i] = (row_ok && c < d) ? to_f(q[qbase + c]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  int k_end = sk;
  if (causal) {
    // last key visible to the tile's last row
    const int last = min(q0 + BQ, sq) - 1 + off;
    k_end = max(0, min(sk, last + 1));
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every row is done with the previous tile
    for (int e = tid; e < BK * TPR * DPT; e += NT) {
      const int r = e / (TPR * DPT);
      const int c = e - r * (TPR * DPT);
      const int key = k0 + r;
      const bool ok = key < sk && c < d;
      const size_t g = kvbase + (size_t)key * d + c;
      const int s_idx = r * ROW + (c / DPT) * DPS + (c % DPT);
      ks[s_idx] = ok ? to_f(k[g]) : 0.f;
      vs[s_idx] = ok ? to_f(v[g]) : 0.f;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; kk += CH) {
      float s[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float4* kr =
            reinterpret_cast<const float4*>(ks + (kk + j) * ROW + part * DPS);
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < DPT / 4; ++i) {
          const float4 kv4 = kr[i];
          a = fmaf(qr[4 * i + 0], kv4.x, a);
          a = fmaf(qr[4 * i + 1], kv4.y, a);
          a = fmaf(qr[4 * i + 2], kv4.z, a);
          a = fmaf(qr[4 * i + 3], kv4.w, a);
        }
        s[j] = a;
      }
#pragma unroll
      for (int w = 1; w < TPR; w <<= 1) {
#pragma unroll
        for (int j = 0; j < CH; ++j)
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], w);
      }

      unsigned valid = 0u;
      float m_new = m;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int key = k0 + kk + j;
        const bool ok = key < sk && (!causal || key <= qpos);
        s[j] *= scale;
        if (ok) {
          valid |= 1u << j;
          m_new = fmaxf(m_new, s[j]);
        }
      }
      if (valid == 0u) continue;  // nothing visible in this chunk

      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float p = ((valid >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
        l += p;
        const float pv = round_to<T>(p);
        const float4* vr =
            reinterpret_cast<const float4*>(vs + (kk + j) * ROW + part * DPS);
#pragma unroll
        for (int i = 0; i < DPT / 4; ++i) {
          const float4 v4 = vr[i];
          acc[4 * i + 0] = fmaf(pv, v4.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(pv, v4.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(pv, v4.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(pv, v4.w, acc[4 * i + 3]);
        }
      }
      m = m_new;
    }
  }

  if (!row_ok) return;
  const bool degenerate = m <= kNegInf * 0.5f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int c = part * DPT + i;
    if (c < d) o[qbase + c] = from_f<T>(degenerate ? 0.f : acc[i] / l);
  }
  if (lse != nullptr && part == 0)
    lse[(size_t)bh * sq + qi] = degenerate ? 1e30f : m + logf(l);
}

template <typename T, int TPR>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int sq, int sk, int d, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int DPT = 64;
  constexpr int BQ = 128 / TPR;   // 128 threads a block
  constexpr int BK = 64 / TPR;    // 32-35 KB of shared memory for K and V
  constexpr int CH = 16;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, DPT, TPR, BQ, BK, CH><<<grid, BQ * TPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int sq, int sk, int d, float scale,
                   int causal, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 1>(q, k, v, o, lse, bh, sq, sk, d, scale, causal, stream);
  if (d <= 128)
    return launch<T, 2>(q, k, v, o, lse, bh, sq, sk, d, scale, causal, stream);
  return launch<T, 4>(q, k, v, o, lse, bh, sq, sk, d, scale, causal, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  lse may be null.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int sq, int sk, int d,
                         float sm_scale, int causal, int dtype,
                         void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 0 || d < 1 || d > 256)
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
