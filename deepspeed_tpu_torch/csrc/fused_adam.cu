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
// writes p, m, v (28 bytes, +2 for a bf16 copy) for ~15 flops, and every
// byte is touched once. The design: a CTA step covers a tile of 2 x 256
// 16-byte vectors of each buffer, thread t taking vectors t and t + 256
// (8 values, every load and store of a warp one coalesced 512-byte line,
// two independent vectors in flight a buffer); its compute copy leaves in
// two 8-byte stores of 4 values; the grid is persistent (SMs x resident
// CTAs, from the occupancy query, cached) and walks the tiles
// grid-stride, all CTAs moving through the buffers together; the n % 2048
// values past the last tile go one a thread. Measured on the card against
// this: contiguous ranges a CTA and the streaming (evict-first) hints
// were each a little slower, and two adjacent vectors a thread (one
// 16-byte copy store, a warp's loads half-using every sector) about a
// third slower.

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

// Every product and sum rounded on its own (the _rn intrinsics are never
// contracted into an fma), in adam_plain's order, so p, m, v and the copy
// are the plain version's bit for bit; the division and sqrtf are IEEE.
__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, const Hyper& h) {
  g = __fmul_rn(g, h.coef);
  if (h.wd != 0.f && !h.adamw) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(__fsub_rn(1.f, h.b1), g));
  v = __fadd_rn(__fmul_rn(h.b2, v),
                __fmul_rn(__fmul_rn(__fsub_rn(1.f, h.b2), g), g));
  float u = __fmul_rn(m, h.c1) / __fadd_rn(sqrtf(__fmul_rn(v, h.c2)), h.eps);
  if (h.wd != 0.f && h.adamw) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
}

__device__ __forceinline__ void adam4(float4& p, const float4& g, float4& m,
                                      float4& v, const Hyper& h) {
  adam_one(p.x, g.x, m.x, v.x, h);
  adam_one(p.y, g.y, m.y, v.y, h);
  adam_one(p.z, g.z, m.z, v.z, h);
  adam_one(p.w, g.w, m.w, v.w, h);
}

// The compute copy: none (float), bf16 or fp16, each value rounded to
// nearest even once.
template <typename O> struct Out;
template <> struct Out<float> {
  static constexpr bool kCopy = false;
  __device__ static void store(float*, long long, float) {}
};
template <> struct Out<__nv_bfloat16> {
  static constexpr bool kCopy = true;
  __device__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  __device__ static void store(__nv_bfloat16* o, long long i, float v) {
    o[i] = __float2bfloat16(v);
  }
};
template <> struct Out<__half> {
  static constexpr bool kCopy = true;
  __device__ static uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  __device__ static void store(__half* o, long long i, float v) {
    o[i] = __float2half(v);
  }
};

constexpr int kTile = 2 * kThreads;    // 16-byte vectors a CTA step

template <typename O>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                  float* __restrict__ m, float* __restrict__ v,
                  const float* __restrict__ hp, O* __restrict__ out,
                  long long n, float wd, int adamw) {
  if (hp[7] == 0.f) return;            // overflow step: nothing changes
  const Hyper h{hp[0], hp[1], hp[2], hp[3], hp[4], hp[5], hp[6], wd, adamw};
  const long long tiles = n / (4 * kTile);
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long a = t * kTile + threadIdx.x, b = a + kThreads;
    float4 pa = p4[a], pb = p4[b];
    const float4 ga = g4[a], gb = g4[b];
    float4 ma = m4[a], mb = m4[b];
    float4 va = v4[a], vb = v4[b];
    adam4(pa, ga, ma, va, h);
    adam4(pb, gb, mb, vb, h);
    p4[a] = pa;
    p4[b] = pb;
    m4[a] = ma;
    m4[b] = mb;
    v4[a] = va;
    v4[b] = vb;
    if constexpr (Out<O>::kCopy) {
      uint2* o2 = reinterpret_cast<uint2*>(out);
      o2[a] = make_uint2(Out<O>::pack(pa.x, pa.y), Out<O>::pack(pa.z, pa.w));
      o2[b] = make_uint2(Out<O>::pack(pb.x, pb.y), Out<O>::pack(pb.z, pb.w));
    }
  }
  for (long long i = 4 * kTile * tiles + (long long)blockIdx.x * kThreads +
                     threadIdx.x;
       i < n; i += (long long)gridDim.x * kThreads) {
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
  static int slots = 0;                // SMs x resident CTAs, once
  if (slots == 0) {
    int sms = 0, dev = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_adam_kernel<O>, kThreads, 0);
    if (e != cudaSuccess) return e;
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long want = (n + 4 * kTile - 1) / (4 * kTile);
  const int blocks = (int)(want < slots ? (want > 0 ? want : 1) : slots);
  fused_adam_kernel<O><<<blocks, kThreads, 0, stream>>>(
      p, g, m, v, hp, static_cast<O*>(out), n, wd, adamw);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. p, g, m, v: n fp32 values, 16-byte
// aligned; hp: 8 fp32 values on the device (lr, b1, b2, eps, c1, c2, coef,
// apply); out: null or n values of out_dtype (1 = bfloat16, 2 = float16),
// 16-byte aligned (8-byte stores at 8-value steps). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ds_fused_adam(void* p, const void* g, void* m, void* v,
                             const void* hp, void* out, int out_dtype,
                             long long n, float wd, int adamw, void* stream) {
  if (n <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
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
