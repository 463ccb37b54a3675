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
// Inputs: x fp32, bf16 or fp16, contiguous [rows, d]; scale and bias [d] in
// fp32 or in x's type.
//
// What bounds it on an H100: bytes. A norm reads x once and writes y once
// (the params stay in L1/L2): 4 bytes an element in bf16, 0.0100 ms for
// [2048, 4096] at 3.35 TB/s. Three kernels, picked from the shapes alone
// (plan_of; ops/norms.py launch_plan mirrors it):
//
//   warp_row  (norm_rows_kernel, kCta false): one warp a row, d up to
//             32 x kMaxVecs 16-byte vectors (1024 elements in bf16/fp16,
//             512 in fp32). The sums are xor-shuffle butterflies within the
//             warp: no shared memory, no barrier. A CTA holds kRowWarps
//             warps, each walking its own rows.
//   cta_row   (norm_rows_kernel, kCta true): 2-16 warps a row (up to 16384
//             elements in bf16/fp16, 8192 in fp32), a CTA a row. A sum is
//             the warps' butterflies, then one exchange of their partials
//             through a double-buffered scratch: one barrier a sum, and the
//             scratch a sum writes is read again only two barriers later.
//   general   (norm_kernel, the PR-6 design): one CTA a row, the row cached
//             in shared memory, any d and any alignment. It takes what the
//             two above do not: d not a whole number of 16-byte vectors, a
//             pointer off a 16-byte boundary, or a row wider than their
//             register ceiling.
//
// The two row kernels keep a row in registers: each thread holds up to
// kMaxVecs (the template parameter VPT) 16-byte vectors of it, vector k of a
// row going to thread k mod (threads a row), so a warp's loads are
// contiguous. The grid is persistent: min(row groups, SMs x resident CTAs),
// the occupancy queried once per kernel and block size. Each CTA converts
// its share of scale and bias to fp32 in registers once and keeps them for
// every row it takes, and issues the next row's loads (a second register
// buffer) before the current row's sums, so two rows a warp are in flight.
// x is loaded with the evict-first hint (__ldcs); y is stored plainly (the
// next GEMM reads it from L2). The order of every sum is fixed by the
// shapes: within a thread its vectors in order, element by element; then the
// butterfly (xor 16, 8, 4, 2, 1); then the warps' partials in warp order.
// Every add and product of the sums is rounded on its own, so the numpy
// emulation of this schedule (tests/test_torch_norms.py) repeats it bit for
// bit up to rsqrtf. No atomics: reruns are bit-identical, and a NaN in one
// row reaches no other. chip_smoke.py phase 3 times each main-path shape
// beside a copy of x (copy_ms), the pass of the same bytes this design
// aims at.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;               // general
constexpr int kRed = 32;                       // floats of reduction scratch
constexpr int kSmemBytes = 48 * 1024;          // without an opt-in attribute
constexpr int kMaxVecs = 4;          // row kernels: vectors a thread holds
constexpr int kRowWarps = 4;         // warp_row: warps (rows) a CTA
constexpr int kRowBlocksPerSM = 4;   // warp_row: <= 128 registers a thread
constexpr int kMaxRowWarps = 16;     // cta_row: warps a row (<= 128 regs)

// variant codes (ops/norms.py VARIANTS)
constexpr int kGeneral = 0, kWarpRow = 1, kCtaRow = 2;

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


// ------------------------------------------------ warp_row and cta_row

// The fp32 values of a row's params under x's vector k (V elements: one or
// two 16-byte loads).
template <typename S, int V>
__device__ __forceinline__ void load_params(const S* p, int k,
                                            float (&f)[V]) {
  constexpr int PV = 16 / sizeof(S);           // V % PV == 0: S is fp32 or T
  const uint4* q = reinterpret_cast<const uint4*>(p + (long long)k * V);
#pragma unroll
  for (int h = 0; h < V / PV; ++h) {
    const uint4 w = __ldg(q + h);
    const S* e = reinterpret_cast<const S*>(&w);
#pragma unroll
    for (int j = 0; j < PV; ++j) f[h * PV + j] = Elem<S>::get(e[j]);
  }
}

// This thread's vectors (first + j * stride) of row r; zeros where a vector
// is past the row or the row past the last (`live` false).
template <int VPT, typename T>
__device__ __forceinline__ void load_vecs(const T* x, long long r,
                                          long long d, int first,
                                          int stride, int nvec, bool live,
                                          uint4 (&v)[VPT]) {
  const uint4* p = reinterpret_cast<const uint4*>(x + (live ? r * d : 0));
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int k = first + j * stride;
    v[j] = live && k < nvec ? __ldcs(p + k) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// sum of f(element) over this thread's vectors, in order, each add rounded.
template <typename T, int VPT, typename F>
__device__ __forceinline__ float thread_sum(const uint4 (&v)[VPT], int first,
                                            int stride, int nvec, F f) {
  constexpr int V = 16 / sizeof(T);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (first + j * stride < nvec) {
      const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
      for (int i = 0; i < V; ++i) acc = __fadd_rn(acc, f(Elem<T>::get(e[i])));
    }
  }
  return acc;
}

// The row's sum to every thread of the row: the warp's butterfly, then (cta
// row) the warps' partials through red[buf], in warp order. One barrier: the
// buffer this sum writes was last read before the previous sum's barrier.
template <bool kCta>
__device__ __forceinline__ float row_sum(float v,
                                         float (*red)[kMaxRowWarps],
                                         int& buf, int nwarps) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, s));
  if (!kCta) return v;
  if ((threadIdx.x & 31) == 0) red[buf][threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < nwarps; ++w) t = __fadd_rn(t, red[buf][w]);
  buf ^= 1;
  return t;
}

// y of this thread's vectors of row r, by the plain version's rounding chain.
template <typename T, bool kLayer, int VPT, int V>
__device__ __forceinline__ void store_vecs(T* y, long long r, long long d,
                                           const uint4 (&v)[VPT],
                                           const float (&sc)[VPT][V],
                                           const float (&bi)[VPT][V],
                                           int first, int stride, int nvec,
                                           float mean, float rstd) {
  uint4* p = reinterpret_cast<uint4*>(y + r * d);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int k = first + j * stride;
    if (k < nvec) {
      const T* e = reinterpret_cast<const T*>(&v[j]);
      uint4 w;
      T* o = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xv = Elem<T>::get(e[i]);
        o[i] = Elem<T>::put(
            kLayer ? __fadd_rn(__fmul_rn(__fmul_rn(__fadd_rn(xv, -mean), rstd),
                                         sc[j][i]),
                               bi[j][i])
                   : __fmul_rn(__fmul_rn(xv, rstd), sc[j][i]));
      }
      p[k] = w;
    }
  }
}

// warp_row (kCta false: warp w of CTA b takes rows b * kRowWarps + w, then
// every gridDim.x * kRowWarps-th) and cta_row (kCta true: CTA b takes rows
// b, b + gridDim.x, ...; the bound is the same for all its threads, so each
// reaches every barrier). nvec = d / V; VPT x the threads of a row >= nvec.
template <typename T, typename S, bool kLayer, bool kCta, int VPT>
__global__ void __launch_bounds__(kCta ? kMaxRowWarps * 32 : kRowWarps * 32,
                                  kCta ? 1 : kRowBlocksPerSM)
norm_rows_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                 const S* __restrict__ bias, T* __restrict__ y,
                 long long rows, int nvec, float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[2][kMaxRowWarps];
  const int first = kCta ? (int)threadIdx.x : (int)(threadIdx.x & 31);
  const int stride = kCta ? (int)blockDim.x : 32;
  const int nwarps = blockDim.x >> 5;
  const long long step =
      kCta ? (long long)gridDim.x : (long long)gridDim.x * nwarps;
  long long r = kCta ? (long long)blockIdx.x
                     : (long long)blockIdx.x * nwarps + (threadIdx.x >> 5);
  const long long d = (long long)nvec * V;
  const float fd = (float)d;
  float sc[VPT][V] = {}, bi[VPT][V] = {};
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int k = first + j * stride;
    if (k < nvec) {
      load_params<S, V>(scale, k, sc[j]);
      if (kLayer) load_params<S, V>(bias, k, bi[j]);
    }
  }
  uint4 cur[VPT], nxt[VPT];
  load_vecs<VPT>(x, r, d, first, stride, nvec, r < rows, cur);
  int buf = 0;
  for (; r < rows; r += step) {
    load_vecs<VPT>(x, r + step, d, first, stride, nvec, r + step < rows,
                   nxt);
    const float s1 = row_sum<kCta>(
        thread_sum<T, VPT>(cur, first, stride, nvec,
                           [](float v) { return kLayer ? v
                                                       : __fmul_rn(v, v); }),
        red, buf, nwarps);
    float mean = 0.f, var;
    if (kLayer) {
      mean = s1 / fd;
      var = row_sum<kCta>(
                thread_sum<T, VPT>(cur, first, stride, nvec,
                                   [mean](float v) {
                                     const float c = __fadd_rn(v, -mean);
                                     return __fmul_rn(c, c);
                                   }),
                red, buf, nwarps) / fd;
    } else {
      var = s1 / fd;
    }
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    store_vecs<T, kLayer, VPT, V>(y, r, d, cur, sc, bi, first, stride, nvec,
                                  mean, rstd);
#pragma unroll
    for (int j = 0; j < VPT; ++j) cur[j] = nxt[j];
  }
}

// ------------------------------------------------------------ the plan

struct Plan {
  int variant;    // kGeneral, kWarpRow or kCtaRow
  int warps;      // warps a row (general: the CTA's warps, a CTA a row)
  int vecs;       // 16-byte vectors a thread holds of a row (general: 0)
  int threads;    // threads a CTA
};

// The kernel a call takes, from d, x's element size and whether every
// pointer is 16-byte aligned (a row start is then aligned when d is a whole
// number of vectors). cta_row's vecs is 3 or 4: warps = ceil(nvec / 128) > 1
// gives nvec / (32 warps) > 4 (warps - 1) / warps >= 2.
Plan plan_of(int itemsize, long long d, bool aligned) {
  const int V = 16 / itemsize;
  const long long nvec = d / V, per_warp = 32LL * kMaxVecs;
  if (aligned && d % V == 0 && nvec <= per_warp)
    return {kWarpRow, 1, (int)((nvec + 31) / 32), kRowWarps * 32};
  const long long warps = (nvec + per_warp - 1) / per_warp;
  if (aligned && d % V == 0 && warps <= kMaxRowWarps)
    return {kCtaRow, (int)warps, (int)((nvec + 32 * warps - 1) / (32 * warps)),
            (int)warps * 32};
  long long want = (d + V - 1) / V;
  want = (want + 31) / 32 * 32;
  const int threads = (int)(want < 32 ? 32
                                      : (want > kMaxThreads ? kMaxThreads
                                                            : want));
  return {kGeneral, threads / 32, 0, threads};
}

// One call: its arguments, its plan and the grid it launches (with `dry`
// the grid only, no launch).
struct Call {
  const void *x, *scale, *bias;
  void* y;
  long long rows, d;
  float eps;
  cudaStream_t st;
  bool dry, aligned;
  Plan plan;
  long long grid;
};

template <typename T, typename S, bool kLayer, bool kCta, int VPT>
cudaError_t launch_rows(Call& c) {
  constexpr int V = 16 / sizeof(T);
  auto kernel = norm_rows_kernel<T, S, kLayer, kCta, VPT>;
  // SMs x resident CTAs, by warps a CTA, queried at the first call (the
  // current device's; the port runs on one card)
  static int slots[kMaxRowWarps + 1];
  int& slot = slots[c.plan.threads / 32];
  if (slot == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        c.plan.threads, 0);
    if (e != cudaSuccess) return e;
    slot = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long groups = kCta ? c.rows : (c.rows + kRowWarps - 1) / kRowWarps;
  c.grid = groups < slot ? groups : slot;
  if (c.dry) return cudaSuccess;
  kernel<<<(int)c.grid, c.plan.threads, 0, c.st>>>(
      static_cast<const T*>(c.x), static_cast<const S*>(c.scale),
      static_cast<const S*>(c.bias), static_cast<T*>(c.y), c.rows,
      (int)(c.d / V), c.eps);
  return cudaGetLastError();
}

template <typename T, typename S, bool kLayer>
cudaError_t launch_general(Call& c) {
  const int threads = c.plan.threads;
  const long long cache_bytes = (long long)(kRed + c.d) * 4;
  const int cached = cache_bytes <= kSmemBytes;
  const size_t smem = cached ? (size_t)cache_bytes : kRed * 4;
  const long long cap = 1LL << 30;
  c.grid = c.rows < cap ? c.rows : cap;
  if (c.dry) return cudaSuccess;
  norm_kernel<T, S, kLayer><<<(int)c.grid, threads, smem, c.st>>>(
      static_cast<const T*>(c.x), static_cast<const S*>(c.scale),
      static_cast<const S*>(c.bias), static_cast<T*>(c.y), c.rows, c.d,
      c.eps, cached);
  return cudaGetLastError();
}

template <typename T, typename S, bool kLayer>
cudaError_t launch(Call& c) {
  c.plan = plan_of((int)sizeof(T), c.d, c.aligned);
  if (c.plan.variant == kWarpRow) {
    switch (c.plan.vecs) {
      case 1: return launch_rows<T, S, kLayer, false, 1>(c);
      case 2: return launch_rows<T, S, kLayer, false, 2>(c);
      case 3: return launch_rows<T, S, kLayer, false, 3>(c);
      case 4: return launch_rows<T, S, kLayer, false, 4>(c);
    }
  } else if (c.plan.variant == kCtaRow) {
    switch (c.plan.vecs) {
      case 3: return launch_rows<T, S, kLayer, true, 3>(c);
      case 4: return launch_rows<T, S, kLayer, true, 4>(c);
    }
  } else {
    return launch_general<T, S, kLayer>(c);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16; the scale (and bias)
// code is 0 or the input's. `aligned` < 0: from the pointers (a launch);
// else as given (a plan).
template <bool kLayer>
int dispatch(Call& c, int dtype, int scale_dtype, int aligned) {
  if (c.rows < 0 || c.d <= 0 || dtype < 0 || dtype > 2
      || (scale_dtype != 0 && scale_dtype != dtype))
    return (int)cudaErrorInvalidValue;
  if (c.rows == 0 && !c.dry) return 0;
  c.aligned = aligned < 0 ? aligned16(c.x) && aligned16(c.y)
                                && aligned16(c.scale)
                                && (!kLayer || aligned16(c.bias))
                          : aligned != 0;
  const bool f32 = scale_dtype == 0;
  cudaError_t e;
  if (dtype == 0)
    e = launch<float, float, kLayer>(c);
  else if (dtype == 1)
    e = f32 ? launch<__nv_bfloat16, float, kLayer>(c)
            : launch<__nv_bfloat16, __nv_bfloat16, kLayer>(c);
  else
    e = f32 ? launch<__half, float, kLayer>(c)
            : launch<__half, __half, kLayer>(c);
  return (int)e;
}

}  // namespace

// C entry points, bound with ctypes. x, y: rows x d contiguous elements of
// `dtype`; scale (and bias): d elements of `scale_dtype`. Each returns
// cudaGetLastError() after the launch (0 = launched) and writes the variant
// it launched (0 general, 1 warp_row, 2 cta_row) to *variant.
extern "C" int ds_rms_norm(const void* x, const void* scale, void* y,
                           int dtype, int scale_dtype, long long rows,
                           long long d, float eps, void* stream,
                           int* variant) {
  Call c{x, scale, nullptr, y, rows, d, eps,
         static_cast<cudaStream_t>(stream), false, false, {}, 0};
  const int err = dispatch<false>(c, dtype, scale_dtype, -1);
  *variant = c.plan.variant;
  return err;
}

extern "C" int ds_layer_norm(const void* x, const void* scale,
                             const void* bias, void* y, int dtype,
                             int scale_dtype, long long rows, long long d,
                             float eps, void* stream, int* variant) {
  Call c{x, scale, bias, y, rows, d, eps, static_cast<cudaStream_t>(stream),
         false, false, {}, 0};
  const int err = dispatch<true>(c, dtype, scale_dtype, -1);
  *variant = c.plan.variant;
  return err;
}

// The variant (0 general, 1 warp_row, 2 cta_row) a call of `kind` (0 RMS,
// 1 Layer) takes at these dtypes and d, with every pointer 16-byte aligned
// or not; -1 where no kernel takes the arguments.
extern "C" int ds_norm_variant(int kind, int dtype, int scale_dtype,
                               long long d, int aligned) {
  if (kind < 0 || kind > 1 || dtype < 0 || dtype > 2 || d <= 0
      || (scale_dtype != 0 && scale_dtype != dtype))
    return -1;
  const int itemsize = dtype == 0 ? 4 : 2;
  return plan_of(itemsize, d, aligned != 0).variant;
}

// The whole plan of such a call over `rows` rows: out[0..4] = variant,
// warps a row, vectors a thread, threads a CTA, grid (the occupancy query
// runs here, on the current device). Returns a CUDA error code (0 = done).
extern "C" int ds_norm_plan(int kind, int dtype, int scale_dtype,
                            long long d, int aligned, long long rows,
                            long long* out) {
  if (kind < 0 || kind > 1) return (int)cudaErrorInvalidValue;
  Call c{nullptr, nullptr, nullptr, nullptr, rows, d, 0.f, nullptr, true,
         false, {}, 0};
  const int err = kind ? dispatch<true>(c, dtype, scale_dtype, aligned != 0)
                       : dispatch<false>(c, dtype, scale_dtype, aligned != 0);
  out[0] = c.plan.variant;
  out[1] = c.plan.warps;
  out[2] = c.plan.vecs;
  out[3] = c.plan.threads;
  out[4] = c.grid;
  return err;
}

// Message of a code returned above.
extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
