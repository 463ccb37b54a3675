// Fused Lion over one flat fp32 buffer, for Hopper.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/fused_optimizers.py:165
// `fused_lion` (body `_lion_kernel` :146, call :190), which the TPU launches
// once per parameter tensor over [rows, 128] blocks and which returns the
// delta new_p - p for the engine to add back. Here the engine keeps the fp32
// master and Lion's momentum m of every parameter as views into two flat
// buffers and gathers the fp32 grads into a third, so one launch updates the
// whole model and writes p directly. Per element, with
// hp = lr, b1, b2, coef, apply on the device:
//   g = g * coef                        (the gradient-clipping coefficient)
//   u = sign(b1 m + (1 - b1) g) [+ wd * p]
//   p = p - lr u;   m = b2 m + (1 - b2) g
// and, when `out` is given, the compute-dtype (bf16/fp16) copy of the new p
// in the same pass. lr comes from the schedule at the pre-increment step, so
// launching needs no host sync; hp[4] == 0 (an fp16 overflow step) leaves p,
// m and the copy untouched. Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn: no contraction into fma), so the kernel gives the
// same bits as the plain PyTorch version, whose ops are separate passes.
//
// What bounds it on an H100: bytes. Per element it reads p, g, m and writes
// p, m (20 bytes, +2 for a bf16 copy) for ~10 flops: over GPT-2 125M's
// 124,475,904 values 2.74 GB, 0.82 ms at 3.35 TB/s. The design streams the
// buffers once with 16-byte vector accesses in a grid-stride loop, a scalar
// tail covering sizes that are not a multiple of 4.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float lr, b1, b2, coef, wd;
};

// torch.sign: -1, 0 or 1, NaN stays NaN
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__device__ __forceinline__ void lion_one(float& p, float g, float& m,
                                         const Hyper& h) {
  g = __fmul_rn(g, h.coef);
  float u = sign_of(__fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(1.f - h.b1, g)));
  if (h.wd != 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
  m = __fadd_rn(__fmul_rn(h.b2, m), __fmul_rn(1.f - h.b2, g));
}

template <typename O> struct Out;
template <> struct Out<float> {   // no compute copy
  __device__ static void store(float*, long long, float) {}
};
template <> struct Out<__nv_bfloat16> {
  __device__ static void store(__nv_bfloat16* o, long long i, float v) {
    o[i] = __float2bfloat16(v);
  }
};
template <> struct Out<__half> {
  __device__ static void store(__half* o, long long i, float v) {
    o[i] = __float2half(v);
  }
};

template <typename O>
__global__ void __launch_bounds__(kThreads)
fused_lion_kernel(float* __restrict__ p, const float* __restrict__ g,
                  float* __restrict__ m, const float* __restrict__ hp,
                  O* __restrict__ out, long long n, float wd) {
  if (hp[4] == 0.f) return;            // overflow step: nothing changes
  const Hyper h{hp[0], hp[1], hp[2], hp[3], wd};
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long long i = first; i < n4; i += stride) {
    float4 pp = p4[i], gg = g4[i], mm = m4[i];
    lion_one(pp.x, gg.x, mm.x, h);
    lion_one(pp.y, gg.y, mm.y, h);
    lion_one(pp.z, gg.z, mm.z, h);
    lion_one(pp.w, gg.w, mm.w, h);
    p4[i] = pp;
    m4[i] = mm;
    Out<O>::store(out, 4 * i, pp.x);
    Out<O>::store(out, 4 * i + 1, pp.y);
    Out<O>::store(out, 4 * i + 2, pp.z);
    Out<O>::store(out, 4 * i + 3, pp.w);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float pp = p[i], mm = m[i];
    lion_one(pp, g[i], mm, h);
    p[i] = pp;
    m[i] = mm;
    Out<O>::store(out, i, pp);
  }
}

template <typename O>
cudaError_t launch(float* p, const float* g, float* m, const float* hp,
                   void* out, long long n, float wd, cudaStream_t stream) {
  int sms = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
  fused_lion_kernel<O><<<blocks, kThreads, 0, stream>>>(
      p, g, m, hp, static_cast<O*>(out), n, wd);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. p, g, m: n fp32 values, 16-byte aligned;
// hp: 5 fp32 values on the device (lr, b1, b2, coef, apply); out: null or n
// values of out_dtype (1 = bfloat16, 2 = float16). Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int ds_fused_lion(void* p, const void* g, void* m, const void* hp,
                             void* out, int out_dtype, long long n, float wd,
                             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  float* mf = static_cast<float*>(m);
  const float* gf = static_cast<const float*>(g);
  const float* h = static_cast<const float*>(hp);
  if (out == nullptr)
    return (int)launch<float>(pf, gf, mf, h, nullptr, n, wd, st);
  if (out_dtype == 1)
    return (int)launch<__nv_bfloat16>(pf, gf, mf, h, out, n, wd, st);
  if (out_dtype == 2)
    return (int)launch<__half>(pf, gf, mf, h, out, n, wd, st);
  return (int)cudaErrorInvalidValue;
}

// Message of a code returned above.
extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
