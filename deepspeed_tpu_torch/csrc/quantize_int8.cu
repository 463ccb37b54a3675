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
// does the same; `x / scale` is an IEEE division (this file is built without
// --use_fast_math; no __fdividef) and the rounding rintf, so the codes and
// scales are the TPU kernel's and the plain PyTorch version's bit for bit.
//
// Both kernels take the input as `rows` rows of `row_len` elements, each row
// cut into ceil(row_len / 512) blocks whose tail is zero-padded in registers:
// a flat tensor is one row; qgZ's [world, chunk] gradient rows, each padded on
// its own as in the TPU package, are `world` rows, with no padded copy. The
// dequantize writes the trimmed [rows, row_len] output directly.
//
// What bounds them on an H100: bytes. The quantize reads each input element
// once and writes one byte and 4 bytes per block; the dequantize reads one
// byte and writes 2 or 4. One warp owns one block at a time (32 lanes x 16
// elements, 16-byte vector loads where a vector is aligned and in the row),
// takes the block's absmax with a shuffle max (order-free, so exact) and
// writes codes and scale; blocks are walked grid-stride by 8 warps a CTA.

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

// NaN-propagating max, as jnp.max / torch.amax: a NaN anywhere in a block
// makes its scale NaN, so a non-finite gradient stays non-finite on the wire.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Lane `lane`'s k-th vector of a block covers elements (k * 32 + lane) * V
// .. + V - 1 of the block, V = 16 / sizeof(T): neighbouring lanes read
// neighbouring 16-byte words.
template <typename T>
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
    for (int i = 0; i < kPerLane; ++i) amax = nan_max(amax, fabsf(v[i]));
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, s));
    float scale = amax * kInv127;
    if (scale < 1e-12f) scale = 1e-12f;   // a NaN scale stays NaN
    int8_t* dst = q + b * kBlock;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      int8_t c[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float r = rintf(v[k * V + j] / scale);
        c[j] = (int8_t)fminf(fmaxf(r, -127.f), 127.f);
      }
      int8_t* o = dst + (k * 32 + lane) * V;
      if constexpr (V == 4) {
        *reinterpret_cast<char4*>(o) = make_char4(c[0], c[1], c[2], c[3]);
      } else {
        uint2 w;
        memcpy(&w, c, 8);
        *reinterpret_cast<uint2*>(o) = w;
      }
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

cudaError_t grid_for(long long nblocks, int* grid) {
  int sms = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long want = (nblocks + kWarps - 1) / kWarps;
  const long long cap = 16LL * sms;
  *grid = (int)(want < cap ? want : cap);
  return cudaSuccess;
}

}  // namespace

// C entry points, bound with ctypes. dtype codes: 0 = float32, 1 = bfloat16,
// 2 = float16. x / out: rows x row_len contiguous elements; q: rows * bpr *
// 512 int8 codes; scales: rows * bpr fp32, bpr = ceil(row_len / 512). Each
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ds_quantize_int8(const void* x, int dtype, void* q,
                                void* scales, long long rows,
                                long long row_len, void* stream) {
  if (rows <= 0 || row_len <= 0) return 0;
  const long long bpr = (row_len + kBlock - 1) / kBlock;
  int grid = 0;
  cudaError_t e = grid_for(rows * bpr, &grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qc = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scales);
  if (dtype == 0)
    quantize_kernel<float><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const float*>(x), qc, sc, rows, row_len, bpr);
  else if (dtype == 1)
    quantize_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), qc, sc, rows, row_len, bpr);
  else if (dtype == 2)
    quantize_kernel<__half><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const __half*>(x), qc, sc, rows, row_len, bpr);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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
