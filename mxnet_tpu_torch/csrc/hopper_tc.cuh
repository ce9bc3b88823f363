// Hopper (sm_90a) pieces of the port's tensor-core attention kernels,
// shared by flash_fwd.cu and flash_bwd.cu: mbarriers, TMA loads through
// 3-d tensor maps, wgmma's shared-memory descriptors and its m64nNk16
// products with float32 accumulators (ss: both operands from shared
// memory; rs: A from registers), the accumulator-to-A-fragment packing,
// exp2 on the special-function unit, the host side of the tensor maps,
// and the rule that sends a launch to the tensor cores (route).  Inline
// PTX, no CUTLASS, no PyTorch header.
//
// Tiles live in shared memory in the layout TMA writes and wgmma reads
// (TcLayout): column blocks of CB values (SW bytes, the swizzle span),
// each holding every row of the tile at SW bytes a row, 16-byte chunks
// swizzled within 8-row atoms.  A tile starts 1024-byte aligned, and the
// distance between its column blocks is its row count times SW, which
// every product below takes as an argument.

#pragma once

#include <cuda.h>   // CUtensorMap; the driver function comes through the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace hopper_tc {

// the swizzle span SW (bytes), values a column block CB and column blocks
// NCB of a tile with padded head dim DP in 16-bit storage
template <int DP>
struct TcLayout {
  static constexpr int SW = DP >= 64 ? 128 : 64;
  static constexpr int CB = SW / 2;
  static constexpr int NCB = DP / CB;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of *bar* with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA box of a (batch*head, rows, d) tensor into shared memory at
// *dst*; coordinates innermost first, past the tensor filled with zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(bh)
      : "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading byte
// offset *lbo* (between column blocks of an MN-major operand; unused for
// K-major), stride byte offset 8 * SW (between 8-row atoms), and the
// swizzle (1: 128 bytes, 2: 64 bytes)
template <int SW>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t layout = SW == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((8 * SW) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait2() {
  asm volatile("wgmma.wait_group.sync.aligned 2;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator
// across the asynchronous wgmma that owns it
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(d[i][r])::"memory");
}

// m64nNk16, float32 accumulators (N / 2 a thread), 16-bit operands.
// ss: A and B from shared memory, both K-major.  rs: A from registers
// (4 words of packed pairs), B from shared memory, MN-major (transposed).
// SD 0: D = A B, else D += A B.
#define FA_R8(a, b, c, d, e, f, g, h)                                    \
  "%" #a ", %" #b ", %" #c ", %" #d ", %" #e ", %" #f ", %" #g ", %" #h
#define FA_REGS16 "{" FA_R8(0, 1, 2, 3, 4, 5, 6, 7) ", " \
  FA_R8(8, 9, 10, 11, 12, 13, 14, 15) "}"
#define FA_REGS32 "{" FA_R8(0, 1, 2, 3, 4, 5, 6, 7) ", "                  \
  FA_R8(8, 9, 10, 11, 12, 13, 14, 15) ", "                                \
  FA_R8(16, 17, 18, 19, 20, 21, 22, 23) ", "                              \
  FA_R8(24, 25, 26, 27, 28, 29, 30, 31) "}"
#define FA_REGS64 "{" FA_R8(0, 1, 2, 3, 4, 5, 6, 7) ", "                  \
  FA_R8(8, 9, 10, 11, 12, 13, 14, 15) ", "                                \
  FA_R8(16, 17, 18, 19, 20, 21, 22, 23) ", "                              \
  FA_R8(24, 25, 26, 27, 28, 29, 30, 31) ", "                              \
  FA_R8(32, 33, 34, 35, 36, 37, 38, 39) ", "                              \
  FA_R8(40, 41, 42, 43, 44, 45, 46, 47) ", "                              \
  FA_R8(48, 49, 50, 51, 52, 53, 54, 55) ", "                              \
  FA_R8(56, 57, 58, 59, 60, 61, 62, 63) "}"
#define FA_ACC8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_ACC16(d) FA_ACC8(d, 0), FA_ACC8(d, 8)
#define FA_ACC32(d) FA_ACC16(d), FA_ACC8(d, 16), FA_ACC8(d, 24)
#define FA_ACC64(d) \
  FA_ACC32(d), FA_ACC8(d, 32), FA_ACC8(d, 40), FA_ACC8(d, 48), FA_ACC8(d, 56)
// (N, its accumulator registers R, then the operand numbers R .. R + 8)
#define FA_MMA(N, R, TY, TS, REGS, ACC, o0, o1, o2, o3, o4, o5, o6, o7, o8) \
  template <>                                                              \
  struct Mma<N, TY> {                                                      \
    template <int SD>                                                      \
    __device__ __forceinline__ static void ss(float (&d)[R], uint64_t a,   \
                                              uint64_t b) {                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #o2 ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TS    \
                   "." TS " " REGS ", %" #o0 ", %" #o1 ", p, %" #o3        \
                   ", %" #o4 ", %" #o5 ", %" #o6 ";\n}\n"                  \
                   : ACC(d)                                                \
                   : "l"(a), "l"(b), "r"(SD), "n"(1), "n"(1), "n"(0),      \
                     "n"(0));                                              \
    }                                                                      \
    template <int SD>                                                      \
    __device__ __forceinline__ static void rs(float (&d)[R],               \
                                              const uint32_t (&a)[4],      \
                                              uint64_t b) {                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #o5 ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TS    \
                   "." TS " " REGS ", {%" #o0 ", %" #o1 ", %" #o2          \
                   ", %" #o3 "}, %" #o4 ", p, %" #o6 ", %" #o7 ", %" #o8   \
                   ";\n}\n"                                                \
                   : ACC(d)                                                \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),   \
                     "r"(SD), "n"(1), "n"(1), "n"(1));                     \
    }                                                                      \
  };

template <int N, typename T> struct Mma;
FA_MMA(32, 16, __nv_bfloat16, "bf16", FA_REGS16, FA_ACC16, 16, 17, 18, 19,
       20, 21, 22, 23, 24)
FA_MMA(64, 32, __nv_bfloat16, "bf16", FA_REGS32, FA_ACC32, 32, 33, 34, 35,
       36, 37, 38, 39, 40)
FA_MMA(128, 64, __nv_bfloat16, "bf16", FA_REGS64, FA_ACC64, 64, 65, 66, 67,
       68, 69, 70, 71, 72)
FA_MMA(32, 16, __half, "f16", FA_REGS16, FA_ACC16, 16, 17, 18, 19, 20, 21,
       22, 23, 24)
FA_MMA(64, 32, __half, "f16", FA_REGS32, FA_ACC32, 32, 33, 34, 35, 36, 37,
       38, 39, 40)
FA_MMA(128, 64, __half, "f16", FA_REGS64, FA_ACC64, 64, 65, 66, 67, 68, 69,
       70, 71, 72)

// two float32 values as a packed pair of T, the lower index in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float x, float y);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x,
                                                                     float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float x, float y) {
  const __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2**x on the special-function unit (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Issue C = A B^T for the warpgroup's 64 rows of A (at *a*, in a tile of
// AROWS rows) against the N rows of the tile at *b* (N rows), as one wgmma
// group: DP / 16 k-steps, each 32 bytes further into the rows of its
// column block.  Both tiles are K-major (rows of DP values).
template <typename T, int DP, int N, int AROWS>
__device__ __forceinline__ void tc_qk(uint32_t a_tile, uint32_t b_tile,
                                      float (&c)[N / 2]) {
  using L = TcLayout<DP>;
  // a k-step moves only the descriptors' start address (in 16-byte units)
  const uint64_t a0 = gmma_desc<L::SW>(a_tile, 0),
                 b0 = gmma_desc<L::SW>(b_tile, 0);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int cb = kk * 16 / L::CB;
    const int off = (kk * 16 % L::CB) * 2;
    const uint64_t a = a0 + ((cb * (AROWS * L::SW) + off) >> 4);
    const uint64_t b = b0 + ((cb * (N * L::SW) + off) >> 4);
    if (kk == 0)
      Mma<N, T>::template ss<0>(c, a, b);
    else
      Mma<N, T>::template ss<1>(c, a, b);
  }
  wgmma_commit();
}

// Issue O += P X against the K rows of the tile at *x* (rows of DP values,
// read MN-major through wgmma's transpose), as one wgmma group: k-step kk
// takes rows [16 kk, 16 kk + 16), two 8-row atoms of every column block,
// and P's A fragment p[kk].
template <typename T, int DP, int K>
__device__ __forceinline__ void tc_pv(uint32_t x,
                                      const uint32_t (&p)[K / 16][4],
                                      float (&o)[DP / 2]) {
  using L = TcLayout<DP>;
  const uint64_t b0 = gmma_desc<L::SW>(x, K * L::SW);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    Mma<DP, T>::template rs<1>(o, p[kk], b0 + ((kk * 16 * L::SW) >> 4));
  wgmma_commit();
}

// An accumulator fragment of 64 x N (float32, see below) rounded to T as
// the A fragment of the next product, whose depth is those N columns:
// register pairs of the fragment, two groups of 8 columns a k-step.  A
// thread holds rows rw and rw + 8 (i = 0, 1) of the warpgroup's 64, rw =
// 16 (warp % 4) + lane / 4, and of each group n of 8 columns the two at
// 8 n + 2 (lane % 4) + j: register 4 n + 2 i + j.
template <typename T, int N>
__device__ __forceinline__ void tc_pack(const float (&s)[N / 2],
                                        uint32_t (&p)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

constexpr int kRouteSimt = 0, kRouteWide = 1, kRouteWgmma = 2;

// The kernel a launch of flash_fwd or flash_bwd_dkdv takes, a rule on its
// dtype (0 float32, else 16-bit), head dim and whether its bases are all
// 16-byte aligned (attention._fwd_route and _dkdv_route state the same):
// 16-bit storage with d <= 128 and rows of whole 16-byte chunks on the
// tensor cores; else the register-tiled kernel up to d = 256, past it the
// wide kernel.
inline int route(int d, int dtype, bool aligned) {
  if (dtype != 0 && d <= 128 && d % 8 == 0 && aligned) return kRouteWgmma;
  return d <= 256 ? kRouteSimt : kRouteWide;
}

// cuTensorMapEncodeTiled, a driver function, through the runtime (the
// library links only the runtime); null when the driver lacks it
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a contiguous (bh, rows, d) 16-bit tensor, boxes of
// (1, box_rows, cols) swizzled by *sw* bytes
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, bool bf16,
                              int bh, int rows, int d, int box_rows, int cols,
                              int sw) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper_tc
