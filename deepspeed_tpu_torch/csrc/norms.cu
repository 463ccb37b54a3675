// Row RMSNorm and LayerNorm forward, for Hopper.
//
// Replaces the Pallas TPU kernels deepspeed_tpu/ops/pallas/norms.py:47
// `rms_norm` (body `_rms_kernel` :27) and :81 `layer_norm` (body `_ln_kernel`
// :33), which normalise blocks of 256 rows over the last dim in VMEM. Per
// row of d elements, with fp32 statistics whatever the input type:
//   rms_norm:   y = x * rsqrt(mean(x^2) + eps) * scale
//   layer_norm: mu = mean(x); var = mean((x - mu)^2)   (the centred form)
//               y = (x - mu) * rsqrt(var + eps) * scale + bias
// and y is rounded once into x's type. The products and sums of the last
// line are rounded one at a time (__fmul_rn / __fadd_rn, no contraction into
// an fma), in the order of the plain PyTorch version
// (deepspeed_tpu_torch/ops/layers.py), so the two differ only in the order
// of the row sums and in rsqrtf.
//
// Inputs: x fp32, bf16 or fp16, contiguous [rows, d] (any rows, any d: the
// TPU's d % 128 gate is a tiling constraint this kernel does not have);
// scale and bias [d] in fp32 or in x's type.
//
// What bounds it on an H100: bytes. The kernel reads x once and writes y
// once (plus the scale and bias, which stay in L1/L2): 4 bytes an element in
// bf16. One CTA owns one row at a time (rows are walked grid-stride), with
// one 16-byte vector per thread per step, a scalar head up to the row's first
// 16-byte boundary and a scalar tail, so any d and any row offset load
// vectorised. The row is kept in shared memory as fp32 between the passes
// (d <= 12256); a longer row is read again from global memory (L2). The
// sums reduce by warp shuffles and then across warps through shared memory.
// A row is small work (768-5120 elements on the port's paths): a decode tick
// of 8 rows leaves most SMs idle, which this simple design accepts.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kRed = 32;                       // floats of reduction scratch
constexpr int kSmemBytes = 48 * 1024;          // without an opt-in attribute

template <typename T> struct Elem;
template <> struct Elem<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static float get(float v) { return v; }
  __device__ static float put(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static float get(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 put(float v) { return __float2bfloat16(v); }
};
template <> struct Elem<__half> {
  __device__ static float load(const __half* p) { return __half2float(*p); }
  __device__ static float get(__half v) { return __half2float(v); }
  __device__ static __half put(float v) { return __float2half(v); }
};

// Elements of a row at p before its first 16-byte boundary (at most d).
template <typename T>
__device__ __forceinline__ long long head_of(const T* p, long long d) {
  const long long h =
      (long long)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
      (long long)sizeof(T);
  return h < d ? h : d;
}

// f(i, value as fp32) for every element i of the row p[0..d): scalar head,
// 16-byte vectors, scalar tail; each thread takes every blockDim.x-th piece.
template <typename T, typename F>
__device__ __forceinline__ void for_row(const T* p, long long d, F f) {
  constexpr int V = 16 / sizeof(T);
  const long long head = head_of(p, d);
  for (long long i = threadIdx.x; i < head; i += blockDim.x)
    f(i, Elem<T>::load(p + i));
  const long long nvec = (d - head) / V;
  const uint4* vp = reinterpret_cast<const uint4*>(p + head);
  for (long long k = threadIdx.x; k < nvec; k += blockDim.x) {
    const uint4 w = vp[k];
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int j = 0; j < V; ++j) f(head + k * V + j, Elem<T>::get(e[j]));
  }
  for (long long i = head + nvec * V + threadIdx.x; i < d; i += blockDim.x)
    f(i, Elem<T>::load(p + i));
}

// p[i] = g(i) for every element of the row p[0..d), with the same split.
template <typename T, typename G>
__device__ __forceinline__ void store_row(T* p, long long d, G g) {
  constexpr int V = 16 / sizeof(T);
  const long long head = head_of(p, d);
  for (long long i = threadIdx.x; i < head; i += blockDim.x)
    p[i] = Elem<T>::put(g(i));
  const long long nvec = (d - head) / V;
  uint4* vp = reinterpret_cast<uint4*>(p + head);
  for (long long k = threadIdx.x; k < nvec; k += blockDim.x) {
    uint4 w;
    T* e = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = Elem<T>::put(g(head + k * V + j));
    vp[k] = w;
  }
  for (long long i = head + nvec * V + threadIdx.x; i < d; i += blockDim.x)
    p[i] = Elem<T>::put(g(i));
}

// The sum of v over the CTA, returned to every thread. `red` holds kRed
// floats; the leading barrier lets a caller reuse it right away.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) t += __shfl_xor_sync(0xffffffffu, t, s);
  return t;
}

// kLayer: LayerNorm (centred variance, bias); otherwise RMSNorm.
template <typename T, typename S, bool kLayer>
__global__ void __launch_bounds__(kMaxThreads)
norm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
            const S* __restrict__ bias, T* __restrict__ y, long long rows,
            long long d, float eps, int cached) {
  extern __shared__ float smem[];
  float* red = smem;
  float* row = smem + kRed;
  const float fd = (float)d;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * d;
    T* yr = y + r * d;
    float acc = 0.f;
    for_row(xr, d, [&](long long i, float v) {
      if (cached) row[i] = v;
      acc += kLayer ? v : v * v;
    });
    const float s1 = block_sum(acc, red);      // its barriers publish `row`
    float mean = 0.f, var;
    if (kLayer) {
      mean = s1 / fd;
      float acc2 = 0.f;
      if (cached) {
        for (long long i = threadIdx.x; i < d; i += blockDim.x) {
          const float c = row[i] - mean;
          acc2 += c * c;
        }
      } else {
        for_row(xr, d, [&](long long, float v) {
          const float c = v - mean;
          acc2 += c * c;
        });
      }
      var = block_sum(acc2, red) / fd;
    } else {
      var = s1 / fd;
    }
    const float rstd = rsqrtf(var + eps);
    store_row(yr, d, [&](long long i) {
      const float v = cached ? row[i] : Elem<T>::load(xr + i);
      const float s = Elem<S>::load(scale + i);
      if (kLayer)
        return __fadd_rn(__fmul_rn(__fmul_rn(__fadd_rn(v, -mean), rstd), s),
                         Elem<S>::load(bias + i));
      return __fmul_rn(__fmul_rn(v, rstd), s);
    });
    __syncthreads();                           // `row` is rewritten next
  }
}

template <typename T, typename S, bool kLayer>
cudaError_t launch(const void* x, const void* scale, const void* bias,
                   void* y, long long rows, long long d, float eps,
                   cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  long long want = (d + V - 1) / V;
  want = (want + 31) / 32 * 32;
  const int threads = (int)(want < 32 ? 32
                                      : (want > kMaxThreads ? kMaxThreads
                                                            : want));
  const long long cache_bytes = (long long)(kRed + d) * 4;
  const int cached = cache_bytes <= kSmemBytes;
  const size_t smem = cached ? (size_t)cache_bytes : kRed * 4;
  const long long cap = 1LL << 30;
  const int grid = (int)(rows < cap ? rows : cap);
  norm_kernel<T, S, kLayer><<<grid, threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<const S*>(bias), static_cast<T*>(y), rows, d, eps, cached);
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16; the scale (and bias)
// code is 0 or the input's.
template <bool kLayer>
int dispatch(const void* x, const void* scale, const void* bias, void* y,
             int dtype, int scale_dtype, long long rows, long long d,
             float eps, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (scale_dtype != 0 && scale_dtype != dtype)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f32 = scale_dtype == 0;
  cudaError_t e;
  if (dtype == 0)
    e = launch<float, float, kLayer>(x, scale, bias, y, rows, d, eps, st);
  else if (dtype == 1)
    e = f32 ? launch<__nv_bfloat16, float, kLayer>(x, scale, bias, y, rows,
                                                   d, eps, st)
            : launch<__nv_bfloat16, __nv_bfloat16, kLayer>(
                  x, scale, bias, y, rows, d, eps, st);
  else if (dtype == 2)
    e = f32 ? launch<__half, float, kLayer>(x, scale, bias, y, rows, d, eps,
                                            st)
            : launch<__half, __half, kLayer>(x, scale, bias, y, rows, d, eps,
                                             st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)e;
}

}  // namespace

// C entry points, bound with ctypes. x, y: rows x d contiguous elements of
// `dtype`; scale (and bias): d elements of `scale_dtype`. Each returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ds_rms_norm(const void* x, const void* scale, void* y,
                           int dtype, int scale_dtype, long long rows,
                           long long d, float eps, void* stream) {
  return dispatch<false>(x, scale, nullptr, y, dtype, scale_dtype, rows, d,
                         eps, stream);
}

extern "C" int ds_layer_norm(const void* x, const void* scale,
                             const void* bias, void* y, int dtype,
                             int scale_dtype, long long rows, long long d,
                             float eps, void* stream) {
  return dispatch<true>(x, scale, bias, y, dtype, scale_dtype, rows, d, eps,
                        stream);
}

// Message of a code returned above.
extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
