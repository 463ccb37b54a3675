// Tensor-core building blocks for Hopper (sm_90a), shared by the attention
// kernels of this directory (flash_attention.cu, block_sparse_attention.cu).
//
// A [R, D] tile of 2-byte elements lives in shared memory in wgmma's
// canonical swizzled layout (Tile<D>); its shared-memory descriptors serve
// it as a K-major or an MN-major operand of wgmma.mma_async m64nNk16
// (Wgmma<N, T>), its rows arrive by 16-byte cp.async (zero-fill by a source
// size of 0), and the fp32 accumulator fragment of one warpgroup (Frag) is
// rounded in registers into the A operand of the next product (to_a).
// Everything here sits in an anonymous namespace: each kernel library
// compiles its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;      // score of a masked key (the JAX NEG_INF)
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static float round(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  // two values rounded into one 32-bit register, lo in the low half
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <> struct Num<__half> {
  __device__ static float load(const __half* p) { return __half2float(*p); }
  __device__ static void store(__half* p, float v) { *p = __float2half(v); }
  __device__ static float round(float v) {
    return __half2float(__float2half(v));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// Reductions over the 16 threads that share a row (tx = lane % 16).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A [R, D] tile of 2-byte elements in wgmma's canonical swizzled layout:
// D / W column atoms of [R, W] one after another, each row 2W bytes, W the
// widest of 64, 32 and 16 that divides D (D 16, 32, 64, 128, 256 take
// min(D, 64); D 80 five atoms of 16, D 96 three of 32); within 8-row
// groups the 16-byte chunks of row r are XOR-ed with r % 8 (128-byte
// swizzle, W 64), (r / 2) % 4 (64-byte, W 32) or (r / 4) % 2 (32-byte, W
// 16): the hardware's Swizzle<3|2|1, 4, 3> on the byte address, which the
// tile's 1024-byte alignment makes the tile's own offset.
template <int D> struct Tile {
  static_assert(D % 16 == 0, "a tile's width is a whole number of atoms");
  static constexpr int W = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int kRow = 2 * W;                    // bytes a row
  static constexpr uint32_t kMask = W == 64 ? 7 : W == 32 ? 3 : 1;
  static constexpr uint64_t kLayout = W == 64 ? 1 : W == 32 ? 2 : 3;
  __host__ __device__ static constexpr uint32_t bytes(int R) {
    return (uint32_t)R * D * 2;
  }
  // byte offset of element (r, c)
  __device__ static uint32_t offset(int R, int r, int c) {
    uint32_t o = r * kRow + (c % W) * 2;
    o ^= ((o >> 7) & kMask) << 4;
    return (c / W) * (R * kRow) + o;
  }
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (bits 62-63).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand: rows [r0, r0 + 8n) of a tile of R rows are the M (or N)
// dimension, columns [16 kk, 16 kk + 16) the K slice of one wgmma. Within a
// swizzle atom the K slice is a 32-byte step of the start address; 8-row
// groups are kRow * 8 bytes apart (SBO); LBO is unused.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int R, int r0,
                                           int kk) {
  using L = Tile<D>;
  const int c = 16 * kk;
  return make_desc(tile + (c / L::W) * (R * L::kRow) + r0 * L::kRow +
                       (c % L::W) * 2,
                   16, 8 * L::kRow, L::kLayout);
}

// MN-major operand: rows [r0, r0 + 16) of a tile of R rows are the K slice,
// column atom `atom` (W columns) the N dimension. 8-row groups along K are
// kRow * 8 bytes apart. N never exceeds one atom here (a product over D
// columns runs one wgmma of N = W an atom), so the stride between atoms is
// never taken; LBO carries the same 8-row stride.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int R, int r0,
                                            int atom) {
  using L = Tile<D>;
  return make_desc(tile + atom * (R * L::kRow) + r0 * L::kRow, 8 * L::kRow,
                   8 * L::kRow, L::kLayout);
}

__device__ __forceinline__ void wg_arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving register reads or writes of a wgmma
// operand across the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D[64, N] (+)= A[64, 16] B[16, N] for one warpgroup, fp32 accumulators in
// the wgmma fragment (element i: row 16 warp + lane / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (lane % 4) + i % 2). ss: A and B K-major in shared
// memory; rs: A in registers (the m16n8k16 A fragment of each warp's 16
// rows), B MN-major in shared memory. acc = 0 overwrites D.
template <int N, typename T> struct Wgmma;

#define DS_D8(o)                                                           \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),              \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define DS_D16 DS_D8(0), DS_D8(8)
#define DS_D32 DS_D8(0), DS_D8(8), DS_D8(16), DS_D8(24)

#define DS_WGMMA(N, TYPE, TS, REGS, DLIST, SS_OPS, SS_P, RS_OPS, RS_P)    \
  template <> struct Wgmma<N, TYPE> {                                      \
    __device__ static __forceinline__ void ss(float* d, uint64_t a,        \
                                              uint64_t b, int acc) {       \
      asm volatile(                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " SS_P ", 0;\n"                \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TS "." TS " "  \
          REGS ", " SS_OPS ", p, 1, 1, 0, 0;\n}\n"                         \
          : DLIST                                                          \
          : "l"(a), "l"(b), "r"(acc));                                     \
    }                                                                      \
    __device__ static __forceinline__ void rs(float* d,                    \
                                              const uint32_t (&a)[4],      \
                                              uint64_t b, int acc) {       \
      asm volatile(                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " RS_P ", 0;\n"                \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TS "." TS " "  \
          REGS ", " RS_OPS ", p, 1, 1, 1;\n}\n"                            \
          : DLIST                                                          \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)); \
    }                                                                      \
  };

#define DS_WGMMA_TYPE(TYPE, TS)                                            \
  DS_WGMMA(16, TYPE, TS, "{%0, %1, %2, %3, %4, %5, %6, %7}", DS_D8(0),     \
           "%8, %9", "%10", "{%8, %9, %10, %11}, %12", "%13")              \
  DS_WGMMA(32, TYPE, TS,                                                   \
           "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
           "%14, %15}",                                                    \
           DS_D16, "%16, %17", "%18", "{%16, %17, %18, %19}, %20", "%21")  \
  DS_WGMMA(64, TYPE, TS,                                                   \
           "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
           "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "  \
           "%26, %27, %28, %29, %30, %31}",                                \
           DS_D32, "%32, %33", "%34", "{%32, %33, %34, %35}, %36", "%37")

DS_WGMMA_TYPE(__nv_bfloat16, "bf16")
DS_WGMMA_TYPE(__half, "f16")

#undef DS_WGMMA_TYPE
#undef DS_WGMMA
#undef DS_D32
#undef DS_D16
#undef DS_D8

// 16-byte (and 4-byte) asynchronous copies global -> shared; `bytes` 0
// reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait for the copies of all but the newest `pending` groups, then make
// them visible to wgmma (the async proxy) and to the other threads.
template <int pending>
__device__ __forceinline__ void cp_wait_sync() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// The accumulator of an m64nN product, rounded to T in registers, as the
// register A operands of the N / 16 k-slices of the next product.
template <typename T, int N>
__device__ __forceinline__ void to_a(const float (&s)[N / 2],
                                     uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = Num<T>::pack(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// acc[64, NC] += A[64, K] B[K, col0 .. col0 + NC) with A in registers (K /
// 16 slices) and B the MN-major Tile<D> of R rows at `tile` (rows 0..K; a
// tile address advanced by r0 * kRow bytes starts the K rows at r0): one
// wgmma of N = W a column atom. NC = D (the default) takes every column;
// a narrower NC (a whole number of atoms from col0) lets two warpgroups
// share D's columns.
template <typename T, int D, int K, int NC = D>
__device__ __forceinline__ void mma_rs(float (&acc)[NC / 2],
                                       const uint32_t (&a)[K / 16][4],
                                       uint32_t tile, int R, int col0 = 0) {
  constexpr int NW = Tile<D>::W;
  static_assert(NC % NW == 0, "a column range is a whole number of atoms");
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int at = 0; at < NC / NW; ++at)
      Wgmma<NW, T>::rs(acc + at * (NW / 2), a[kk],
                       desc_mn<D>(tile, R, 16 * kk, col0 / NW + at), 1);
}

// s[64, N] = A[64, D] B[N, D]^T: rows [ra0, ra0 + 64) of the K-major tile
// A (RA rows) against rows [rb0, rb0 + N) of the K-major tile B (RB rows).
template <typename T, int D, int N>
__device__ __forceinline__ void mma_ss(float (&s)[N / 2], uint32_t ta,
                                       int RA, int ra0, uint32_t tb, int RB,
                                       int rb0) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<N, T>::ss(s, desc_k<D>(ta, RA, ra0, kk),
                    desc_k<D>(tb, RB, rb0, kk), kk);
}
// ... against the whole K-major tile B of N rows.
template <typename T, int D, int N>
__device__ __forceinline__ void mma_ss(float (&s)[N / 2], uint32_t ta,
                                       int RA, int ra0, uint32_t tb) {
  mma_ss<T, D, N>(s, ta, RA, ra0, tb, N, 0);
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = Num<T>::pack(lo, hi);
}

// The fragment rows of this thread within its warpgroup's 64: ra, ra + 8;
// its column offset within each 8-column block: cq.
struct Frag {
  int wg, lane, ra, cq;
  __device__ Frag()
      : wg(threadIdx.x / 128), lane(threadIdx.x % 32),
        ra(16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4),
        cq(2 * (threadIdx.x % 4)) {}
  // row (0 or 1 for ra / ra + 8) and column of accumulator element i
  __device__ static int row(int i) { return (i >> 1) & 1; }
  __device__ int col(int i) const { return 8 * (i >> 2) + cq + (i & 1); }
};

__device__ __forceinline__ bool bit(uint32_t bits, int i) {
  return (bits >> i) & 1u;
}

// One online-softmax step over a tile of scores s (the accumulator of
// q k^T): s -> fp32 p = exp(s sc - m_new), m, l updated, corr the factor
// the output accumulator takes. Masked elements (bit clear in ok; kMask
// only) score kMasked and give p = 0. Exponentials by __expf
// (ex2.approx), within 2 ulp of expf; the rounding points are the
// CUDA-core kernels'.
template <bool kMask, int NE>
__device__ __forceinline__ void softmax_step(float (&s)[NE], uint32_t ok,
                                             float sc, float (&m)[2],
                                             float (&l)[2],
                                             float (&corr)[2]) {
  float mx[2] = {kMasked, kMasked}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    s[i] = !kMask || bit(ok, i) ? s[i] * sc : kMasked;
    mx[Frag::row(i)] = fmaxf(mx[Frag::row(i)], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    corr[r] = __expf(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    const float p = __expf(s[i] - m[Frag::row(i)]);
    s[i] = !kMask || bit(ok, i) ? p : 0.f;
    sum[Frag::row(i)] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
}

// p = exp(s sc - lse) rounded to T (0 where masked), per row (kKeyRows
// false: lse[r] for fragment row r) or per column (lse_col[f.col(i)]).
template <typename T, bool kMask, bool kKeyRows, int NE>
__device__ __forceinline__ void probs(float (&s)[NE], uint32_t ok, float sc,
                                      const float (&lse_row)[2],
                                      const float* lse_col, const Frag& f) {
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    const float l = kKeyRows ? lse_col[f.col(i)] : lse_row[Frag::row(i)];
    const float p = Num<T>::round(__expf(s[i] * sc - l));
    s[i] = !kMask || bit(ok, i) ? p : 0.f;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
