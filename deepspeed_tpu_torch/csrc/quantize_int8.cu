// Symmetric int8 block quantization and its inverse, for Hopper: the ZeRO++
// wire (qwZ weight gathers, qgZ gradient exchanges).
//
// Replaces the Pallas TPU kernels deepspeed_tpu/ops/pallas/quantization.py:57
// `quantize_int8` (body `_quant_kernel` :28) and :99 `dequantize_int8` (body
// `_dequant_kernel` :37), which run over a [nblocks, 512] view of the
// zero-padded flat tensor. Per 512-element block, in fp32:
//   amax  = max |x|;  scale = max(amax * fl(1/127), 1e-12)
//   q     = clip(round_half_even(x / scale), -127, 127)   as int8
// and the inverse x' = (float)q * scale, one rounded fp32 product, stored in
// the output type (fp32, bf16 or fp16: the fp32 product rounded once, the
// bits of a cast after it). XLA compiles the TPU kernel's `amax / 127.0`, a
// division by a constant, as a product with the constant's fp32 reciprocal
// (so do the Pallas interpreter and the jitted plain path), and this kernel
// does the same by default: the ZeRO++ wire's scale. The exact-division mode
// (`exact`, ds_quantize_int8_mode) takes scale = max(fl(amax / 127), 1e-12)
// instead, the IEEE quotient that the JAX package's eager quantize_param
// computes for LoRA's frozen base (deepspeed_tpu/linear/quantization.py:71);
// the two differ by an ulp in some blocks' scales. The codes are rint of the
// IEEE quotient x / scale in both modes. The max propagates NaN, as jnp.max;
// a quotient that is NaN (a block holding NaN or inf) gives code 0, as XLA's
// and PyTorch's casts of NaN to int8.
//
// The quotient. An IEEE division, rintf and the float-to-int conversion are
// three quarter-rate ops (MUFU and conversions: 16 a clock on an SM) an
// element, which alone take about as long as the bytes do. The codes only
// need rint of the correctly rounded quotient, so codes16 takes y = fl(x *
// r) with r = fl(1 / scale) (__frcp_rn, once a block): |y - x/scale| < 2
// ulps of y. rint(y) differs from rint(fl(x / scale)) only where a
// half-integer lies within those ulps of y; |y| <= 127.0001, so an ulp is
// at most 2^-17, and a lane with any y within 2^-14 of a half-integer takes
// the IEEE division for its 16 values (about 1 lane in 500). The rounding
// is a full-rate add of 1.5 * 2^23. The codes are the division's for every
// fp32 x (tests/test_torch_quantize_int8.py emulates this in numpy). This
// file is built without --use_fast_math.
//
// Both kernels take the input as `rows` rows of `row_len` elements, each row
// cut into ceil(row_len / 512) blocks whose tail is zero-padded: a flat
// tensor is one row; qgZ's [world, chunk] gradient rows, each padded on its
// own as in the TPU package, are `world` rows, with no padded copy. The
// dequantize writes the trimmed [rows, row_len] output directly.
//
// What bounds them on an H100: bytes. The quantize reads each input element
// once and writes one byte and 4 bytes per block; the dequantize reads one
// byte and writes 2 or 4. The quantize has two variants, picked on the host
// from the shapes and the input's alignment (ds_quantize_int8_variant):
//
// * "bulk" (row_len a multiple of 512, input 16-byte aligned: every block is
//   512 contiguous elements at a 16-byte boundary). A persistent grid of
//   four CTAs an SM, each owning a contiguous range of blocks (the ranges
//   differ by at most one block, so there is no tail round). Thread 0 keeps
//   a ring of kStages chunks of kChunkBytes in shared memory (4 x 8 KB: 8
//   bf16 blocks a chunk, one a warp) filled by 1D TMA bulk
//   copies (cp.async.bulk with an mbarrier and complete_tx; the input is
//   read once, so the copies carry an L2 evict-first policy); eight warps
//   quantize a chunk's blocks from shared memory while the next chunks load,
//   a lane owning 16 contiguous elements of a block, so its codes leave in
//   one 16-byte store (a warp writes its block's 512 codes in one coalesced
//   line). A chunk's scales are staged in shared memory and written by one
//   coalesced store once the chunk is done.
// * "ragged" (any other rows: qgZ rows of a length that is no multiple of
//   512, or a misaligned start). One warp a block over a grid-stride loop,
//   16-byte vector loads where a vector is aligned and in the row and
//   element loads (zero past the row) elsewhere.
//
// The dequantize (one warp a block, grid-stride, 16-byte stores where
// aligned) is over half of its bound and faster than its PyTorch yardstick,
// and stays as it was.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlock = 512;            // elements per quantization block
constexpr int kWarps = 8;              // warps per CTA
constexpr int kPerLane = kBlock / 32;  // 16 elements per lane per block
constexpr float kInv127 = 1.f / 127.f;  // fp32 reciprocal, rounded once
// y within this of a half-integer: the IEEE quotient decides the code
constexpr float kNearHalf = 0.5f - 0x1p-14f;
constexpr float kRound = 12582912.f;   // 1.5 * 2^23: y + kRound = rint(y)
constexpr int kStages = 4;             // chunks in the bulk variant's ring
constexpr int kChunkBytes = 8192;      // bytes of input a chunk
constexpr int kBulkCtasPerSM = 4;

template <typename T> struct Elem;
template <> struct Elem<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
};
template <> struct Elem<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};
template <> struct Elem<__half> {
  __device__ static float load(const __half* p) { return __half2float(*p); }
  __device__ static void store(__half* p, float v) { *p = __float2half(v); }
};

// NaN-propagating max of |v| into a, as jnp.max / torch.amax: a NaN anywhere
// in a block makes its scale NaN, so a non-finite gradient stays non-finite
// on the wire.
__device__ __forceinline__ float nan_amax(float a, float v) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(fabsf(v)));
  return d;
}

__device__ __forceinline__ float warp_nan_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = nan_amax(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// The block's scale from its absmax (a NaN scale stays NaN): the product
// with fl(1/127), or with kExact the correctly rounded quotient amax / 127.
template <bool kExact>
__device__ __forceinline__ float scale_of(float amax) {
  const float scale = kExact ? __fdiv_rn(amax, 127.f) : amax * kInv127;
  return scale < 1e-12f ? 1e-12f : scale;
}

// The codes of one lane's 16 values, as float bits: y + 1.5 * 2^23 rounds y
// to the nearest integer (ties to even, as rintf) and holds it in the low
// mantissa bits, so a code is the low byte of the sum's bits and no
// conversion instruction (a quarter-rate op on an SM) is spent on it. y = x
// * r, r = __frcp_rn(scale); where any of the 16 y lies within 2^-14 of a
// half-integer, all 16 take the IEEE quotient x / scale (see the file's
// note). A finite scale of either mode keeps |y| <= 127.0001, so the clip to
// +-127 never acts; a NaN or inf scale (NaN or inf in the block) gives every
// code 0.
__device__ __forceinline__ void codes16(const float (&x)[kPerLane],
                                        float scale, float (&f)[kPerLane]) {
  if (!isfinite(scale)) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) f[i] = kRound;
    return;
  }
  const float r = __frcp_rn(scale);
  float near = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const float y = x[i] * r;
    f[i] = y + kRound;
    near = fmaxf(near, fabsf(y - (f[i] - kRound)));
  }
  if (near > kNearHalf) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) f[i] = x[i] / scale + kRound;
  }
}

// Four codes (the low bytes of f[0..3]'s bits) as one word, code i in byte
// i.
__device__ __forceinline__ uint32_t pack4(const float* f) {
  return __byte_perm(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x0040),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x0040),
      0x5410);
}

// ------------------------------------------------------------ bulk variant
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One 1D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`, L2 evict-first.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

template <typename T>
constexpr int kChunkBlocks = kChunkBytes / (kBlock * (int)sizeof(T));
// shared memory: kStages barriers, then two chunks' scales, then the ring
// at a 128-byte boundary
constexpr int kRingOffset = 256;
static_assert(kStages * 8 + 2 * kChunkBlocks<__half> * 4 <= kRingOffset,
              "barriers and scales fit below the ring");

// Blocks [b0, b1) of CTA c out of `ctas`: contiguous, balanced to one block.
__device__ __forceinline__ long long range_start(long long n, int c,
                                                 int ctas) {
  return n * c / ctas;
}

template <typename T, bool kExact>
__global__ void __launch_bounds__(kWarps * 32)
quantize_bulk_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scales, long long nblocks) {
  constexpr int CB = kChunkBlocks<T>;
  constexpr int kVecs = kPerLane * (int)sizeof(T) / 16;   // per lane a block
  // the stages' barriers, the scales of two chunks [2][CB], the ring
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  float* const sc = reinterpret_cast<float*>(smem + kRingOffset - 2 * CB * 4);
  unsigned char* const ring = smem + kRingOffset;
  const long long b0 = range_start(nblocks, blockIdx.x, gridDim.x);
  const long long b1 = range_start(nblocks, blockIdx.x + 1, gridDim.x);
  const int nchunks = (int)((b1 - b0 + CB - 1) / CB);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  uint64_t policy = 0;
  auto issue = [&](int c) {              // thread 0: chunk c into its stage
    const long long first = b0 + (long long)c * CB;
    const long long n = b1 - first < CB ? b1 - first : CB;
    bulk_load(smem_addr(ring + (c % kStages) * kChunkBytes),
              x + first * kBlock, (uint32_t)(n * kBlock * sizeof(T)),
              smem_addr(full + c % kStages), policy);
  };
  if (threadIdx.x == 0) {
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(full + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < kStages && c < nchunks; ++c) issue(c);
  }
  __syncthreads();

  for (int c = 0; c < nchunks; ++c) {
    const int stage = c % kStages;
    const long long first = b0 + (long long)c * CB;
    const int n = (int)(b1 - first < CB ? b1 - first : CB);
    float* const sc_c = sc + (c & 1) * CB;
    mbar_wait(smem_addr(full + stage), (c / kStages) & 1);
    const unsigned char* const chunk = ring + stage * kChunkBytes;
    for (int j = warp; j < n; j += kWarps) {
      const uint4* src = reinterpret_cast<const uint4*>(
          chunk + (size_t)j * kBlock * sizeof(T)) + lane * kVecs;
      float v[kPerLane];
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const uint4 w = src[k];
        const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
        for (int i = 0; i < 16 / (int)sizeof(T); ++i)
          v[k * (16 / sizeof(T)) + i] = Elem<T>::load(e + i);
      }
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) amax = nan_amax(amax, v[i]);
      const float scale = scale_of<kExact>(warp_nan_max(amax));
      float f[kPerLane];
      codes16(v, scale, f);
      reinterpret_cast<uint4*>(q + (first + j) * kBlock)[lane] =
          make_uint4(pack4(f), pack4(f + 4), pack4(f + 8), pack4(f + 12));
      if (lane == 0) sc_c[j] = scale;
    }
    __syncthreads();                     // the stage is read, sc_c written
    if ((int)threadIdx.x < n) scales[first + threadIdx.x] = sc_c[threadIdx.x];
    if (threadIdx.x == 0 && c + kStages < nchunks) {
      // the stage's generic-proxy reads come before the async copy's write
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(c + kStages);
    }
  }
}

constexpr uint32_t kBulkSmem = kRingOffset + kStages * kChunkBytes;

// ---------------------------------------------------------- ragged variant
// Lane `lane`'s k-th vector of a block covers elements (k * 32 + lane) * V
// .. + V - 1 of the block, V = 16 / sizeof(T): neighbouring lanes read
// neighbouring 16-byte words.
template <typename T, bool kExact>
__global__ void __launch_bounds__(kWarps * 32)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, long long rows, long long row_len,
                long long bpr) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kVec = kPerLane / V;
  const int lane = threadIdx.x & 31;
  const long long nblocks = rows * bpr;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       b < nblocks; b += warps) {
    const long long row = b / bpr;
    const long long col0 = (b - row * bpr) * kBlock;   // block start in row
    const T* src = x + row * row_len + col0;
    const long long valid = row_len - col0;             // > 0
    float v[kPerLane];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int off = (k * 32 + lane) * V;
      const T* p = src + off;
      if (off + V <= valid && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        const uint4 w = *reinterpret_cast<const uint4*>(p);
        const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
        for (int j = 0; j < V; ++j) v[k * V + j] = Elem<T>::load(e + j);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[k * V + j] = off + j < valid ? Elem<T>::load(p + j) : 0.f;
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) amax = nan_amax(amax, v[i]);
    const float scale = scale_of<kExact>(warp_nan_max(amax));
    float f[kPerLane];
    codes16(v, scale, f);
    int8_t* dst = q + b * kBlock;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      int8_t* o = dst + (k * 32 + lane) * V;
      if constexpr (V == 4)
        *reinterpret_cast<uint32_t*>(o) = pack4(f + k * V);
      else
        *reinterpret_cast<uint2*>(o) =
            make_uint2(pack4(f + k * V), pack4(f + k * V + 4));
    }
    if (lane == 0) scales[b] = scale;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, T* __restrict__ out,
                  long long rows, long long row_len, long long bpr) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kVec = kPerLane / V;
  const int lane = threadIdx.x & 31;
  const long long nblocks = rows * bpr;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       b < nblocks; b += warps) {
    const long long row = b / bpr;
    const long long col0 = (b - row * bpr) * kBlock;
    const long long valid = row_len - col0;
    const float scale = scales[b];
    const int8_t* src = q + b * kBlock;
    T* dst = out + row * row_len + col0;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int off = (k * 32 + lane) * V;
      int8_t c[V];
      if constexpr (V == 4) {
        const char4 w = *reinterpret_cast<const char4*>(src + off);
        c[0] = w.x; c[1] = w.y; c[2] = w.z; c[3] = w.w;
      } else {
        const uint2 w = *reinterpret_cast<const uint2*>(src + off);
        memcpy(c, &w, 8);
      }
      T* p = dst + off;
      if (off + V <= valid && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        uint4 w;
        T* e = reinterpret_cast<T*>(&w);
#pragma unroll
        for (int j = 0; j < V; ++j) Elem<T>::store(e + j, (float)c[j] * scale);
        *reinterpret_cast<uint4*>(p) = w;
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (off + j < valid) Elem<T>::store(p + j, (float)c[j] * scale);
      }
    }
  }
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

cudaError_t grid_for(long long nblocks, int* grid) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long long want = (nblocks + kWarps - 1) / kWarps;
  const long long cap = 16LL * sms;
  *grid = (int)(want < cap ? want : cap);
  return cudaSuccess;
}

int variant_of(long long row_len, int aligned) {
  return row_len % kBlock == 0 && aligned ? 1 : 0;
}

template <typename T, bool kExact>
cudaError_t launch_bulk(const T* x, int8_t* q, float* scales,
                        long long nblocks, cudaStream_t st) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(quantize_bulk_kernel<T, kExact>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kBulkSmem);
  if (e != cudaSuccess) return e;
  // a chunk a CTA at the least; two CTAs an SM at the most
  const long long chunks = (nblocks + kChunkBlocks<T> - 1) / kChunkBlocks<T>;
  const long long cap = (long long)kBulkCtasPerSM * sms;
  const int grid = (int)(chunks < cap ? chunks : cap);
  quantize_bulk_kernel<T, kExact><<<grid, kWarps * 32, kBulkSmem, st>>>(
      x, q, scales, nblocks);
  return cudaGetLastError();
}

template <typename T, bool kExact>
cudaError_t launch_quantize(int variant, const void* x, int8_t* q,
                            float* sc, long long rows, long long row_len,
                            long long bpr, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (variant == 1) return launch_bulk<T, kExact>(xt, q, sc, rows * bpr, st);
  int grid = 0;
  cudaError_t e = grid_for(rows * bpr, &grid);
  if (e != cudaSuccess) return e;
  quantize_kernel<T, kExact><<<grid, kWarps * 32, 0, st>>>(
      xt, q, sc, rows, row_len, bpr);
  return cudaGetLastError();
}

template <bool kExact>
int quantize_typed(const void* x, int dtype, int8_t* q, float* sc,
                   long long rows, long long row_len, int variant,
                   long long bpr, cudaStream_t st) {
  if (dtype == 0)
    return (int)launch_quantize<float, kExact>(variant, x, q, sc, rows,
                                               row_len, bpr, st);
  if (dtype == 1)
    return (int)launch_quantize<__nv_bfloat16, kExact>(variant, x, q, sc,
                                                       rows, row_len, bpr, st);
  if (dtype == 2)
    return (int)launch_quantize<__half, kExact>(variant, x, q, sc, rows,
                                                row_len, bpr, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Which quantize kernel a call takes, from its row length and whether the
// input starts on a 16-byte boundary: 1 = "bulk", 0 = "ragged".
extern "C" int ds_quantize_int8_variant(long long row_len, int aligned) {
  return variant_of(row_len, aligned);
}

// C entry points, bound with ctypes. dtype codes: 0 = float32, 1 = bfloat16,
// 2 = float16. x / out: rows x row_len contiguous elements; q: rows * bpr *
// 512 int8 codes (16-byte aligned); scales: rows * bpr fp32, bpr =
// ceil(row_len / 512); exact: 1 = the exact-division scale, 0 = the wire's
// reciprocal product. Each returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int ds_quantize_int8_mode(const void* x, int dtype, void* q,
                                     void* scales, long long rows,
                                     long long row_len, int exact,
                                     void* stream) {
  if (rows <= 0 || row_len <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(q) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long bpr = (row_len + kBlock - 1) / kBlock;
  const int variant = variant_of(
      row_len, (reinterpret_cast<uintptr_t>(x) & 15) == 0 ? 1 : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qc = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scales);
  return exact ? quantize_typed<true>(x, dtype, qc, sc, rows, row_len,
                                      variant, bpr, st)
               : quantize_typed<false>(x, dtype, qc, sc, rows, row_len,
                                       variant, bpr, st);
}

// The wire's entry (the reciprocal-product scale), kept for callers bound
// to it.
extern "C" int ds_quantize_int8(const void* x, int dtype, void* q,
                                void* scales, long long rows,
                                long long row_len, void* stream) {
  return ds_quantize_int8_mode(x, dtype, q, scales, rows, row_len, 0, stream);
}

extern "C" int ds_dequantize_int8(const void* q, const void* scales,
                                  void* out, int dtype, long long rows,
                                  long long row_len, void* stream) {
  if (rows <= 0 || row_len <= 0) return 0;
  const long long bpr = (row_len + kBlock - 1) / kBlock;
  int grid = 0;
  cudaError_t e = grid_for(rows * bpr, &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qc = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scales);
  if (dtype == 0)
    dequantize_kernel<float><<<grid, kWarps * 32, 0, st>>>(
        qc, sc, static_cast<float*>(out), rows, row_len, bpr);
  else if (dtype == 1)
    dequantize_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, st>>>(
        qc, sc, static_cast<__nv_bfloat16*>(out), rows, row_len, bpr);
  else if (dtype == 2)
    dequantize_kernel<__half><<<grid, kWarps * 32, 0, st>>>(
        qc, sc, static_cast<__half*>(out), rows, row_len, bpr);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Message of a code returned above.
extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
