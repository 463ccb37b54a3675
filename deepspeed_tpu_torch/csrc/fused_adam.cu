// Fused Adam / AdamW over one flat fp32 buffer, for Hopper.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/fused_optimizers.py:75
// `fused_adam` (body `_adam_kernel` :47), which the TPU launches once per
// parameter tensor over [rows, 128] blocks. Here the engine keeps the fp32
// master, m and v of every parameter as views into three flat buffers and
// gathers the fp32 grads into a fourth, so one launch updates all of them
// (multi-tensor apply by layout). Per element, with the optax conventions of
// the TPU kernel (hp = lr, b1, b2, eps, 1/(1-b1^t), 1/(1-b2^t)):
//   g = g * coef                       (the gradient-clipping coefficient)
//   g = g + wd * p                     (L2 mode only)
//   m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
//   u = (m c1) / (sqrt(v c2) + eps) [+ wd * p in AdamW mode];  p = p - lr u
// and, when `out` is given, the compute-dtype (bf16/fp16) copy of the new p
// in the same pass. hp lives on the device (lr from the schedule at the
// pre-increment step, bias corrections at t = step + 1), so launching needs
// no host sync; hp[7] == 0 (an fp16 overflow step) skips the update.
//
// What bounds it on an H100: bytes. Per element it reads p, g, m, v and
// writes p, m, v (28 bytes, +2 for a bf16 copy) for ~15 flops. The design
// streams the buffers once with 16-byte vector accesses in a grid-stride
// loop, a scalar tail covering sizes that are not a multiple of 4.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float lr, b1, b2, eps, c1, c2, coef, wd;
  int adamw;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, const Hyper& h) {
  g = g * h.coef;
  if (h.wd != 0.f && !h.adamw) g = g + h.wd * p;
  m = h.b1 * m + (1.f - h.b1) * g;
  v = h.b2 * v + (1.f - h.b2) * g * g;
  float u = (m * h.c1) / (sqrtf(v * h.c2) + h.eps);
  if (h.wd != 0.f && h.adamw) u = u + h.wd * p;
  p = p - h.lr * u;
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
fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                  float* __restrict__ m, float* __restrict__ v,
                  const float* __restrict__ hp, O* __restrict__ out,
                  long long n, float wd, int adamw) {
  if (hp[7] == 0.f) return;            // overflow step: nothing changes
  const Hyper h{hp[0], hp[1], hp[2], hp[3], hp[4], hp[5], hp[6], wd, adamw};
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long long i = first; i < n4; i += stride) {
    float4 pp = p4[i], gg = g4[i], mm = m4[i], vv = v4[i];
    adam_one(pp.x, gg.x, mm.x, vv.x, h);
    adam_one(pp.y, gg.y, mm.y, vv.y, h);
    adam_one(pp.z, gg.z, mm.z, vv.z, h);
    adam_one(pp.w, gg.w, mm.w, vv.w, h);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
    Out<O>::store(out, 4 * i, pp.x);
    Out<O>::store(out, 4 * i + 1, pp.y);
    Out<O>::store(out, 4 * i + 2, pp.z);
    Out<O>::store(out, 4 * i + 3, pp.w);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam_one(pp, g[i], mm, vv, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
    Out<O>::store(out, i, pp);
  }
}

template <typename O>
cudaError_t launch(float* p, const float* g, float* m, float* v,
                   const float* hp, void* out, long long n, float wd,
                   int adamw, cudaStream_t stream) {
  int sms = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
  fused_adam_kernel<O><<<blocks, kThreads, 0, stream>>>(
      p, g, m, v, hp, static_cast<O*>(out), n, wd, adamw);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. p, g, m, v: n fp32 values, 16-byte
// aligned; hp: 8 fp32 values on the device (lr, b1, b2, eps, c1, c2, coef,
// apply); out: null or n values of out_dtype (1 = bfloat16, 2 = float16).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ds_fused_adam(void* p, const void* g, void* m, void* v,
                             const void* hp, void* out, int out_dtype,
                             long long n, float wd, int adamw, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* gf = static_cast<const float*>(g);
  const float* h = static_cast<const float*>(hp);
  if (out == nullptr)
    return (int)launch<float>(pf, gf, mf, vf, h, nullptr, n, wd, adamw, st);
  if (out_dtype == 1)
    return (int)launch<__nv_bfloat16>(pf, gf, mf, vf, h, out, n, wd, adamw,
                                      st);
  if (out_dtype == 2)
    return (int)launch<__half>(pf, gf, mf, vf, h, out, n, wd, adamw, st);
  return (int)cudaErrorInvalidValue;
}

// Message of a code returned above.
extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
