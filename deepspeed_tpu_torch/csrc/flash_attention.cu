// Flash attention, forward and backward, for Hopper (CUDA cores).
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   * `_flash_fwd` (:88): online-softmax attention that never materialises the
//     [S, S] score matrix; writes o and the log-sum-exp lse;
//   * `_flash_bwd` (:226): recomputes p = exp(s - lse) blockwise and forms
//     dv = p^T do, dp = do v^T, ds = p (dp - delta), dk = ds^T q sc and
//     dq = ds k sc with delta = rowsum(do o).
// Layouts: q/o/dq [B, S, Hq, D]; k/v/dk/dv [B, S, Hkv, D] (GQA: q head h reads
// kv head h / (Hq/Hkv)); lse and delta [B, Hq, S] fp32. fp32, bf16 or fp16;
// scores, softmax and every sum accumulate in fp32. As in the TPU kernels, p
// (forward and backward) and ds are rounded to the input dtype before the
// products that consume them. Causal or full attention, an optional sliding
// window (causal only: query i sees keys (i - window, i]). Any S: the ragged
// last tile is masked. The JAX wrapper sends S that is not a multiple of 128
// to the exact unfused path instead (its grid floors S); the function is the
// same, so on the GPU every S takes these kernels. The TPU's long-sequence
// fallback to the stock kernel exists for a VMEM limit the GPU does not have.
//
// What bounds it on an H100: at GPT-2 shapes (S 1024, D 64) the work is
// ~60 flops per byte moved, so the tensor cores would make it bound by
// bytes; this first port does its products in fp32 FMAs on CUDA cores out of
// shared memory and is bound by those operations and the shared-memory reads
// that feed them. Design, simple first:
//   * tiles of 64 query rows x 64 keys staged in shared memory as fp32 (row
//     stride D+1, so the column walks of the products are bank-conflict free);
//     256 threads as a 16 x 16 grid, each owning a 4 x 4 block of scores and
//     4 rows x D/16 channels of every [64, D] accumulator, in registers;
//   * nothing carries between thread blocks on the GPU, so the TPU's
//     sequential grid axis becomes a loop inside the block: forward, one block
//     per (b*Hq, q tile) walks kv tiles from the window's first live tile to
//     the causal diagonal;
//   * backward is two launches and uses no atomics (deterministic): the dq
//     kernel, one block per (b*Hq, q tile), first forms delta for its rows and
//     writes it out, then walks kv tiles accumulating dq in registers; the
//     dk/dv kernel, one block per (b*Hkv, kv tile), walks the GQA group's rep
//     q heads and their q tiles, accumulating dk and dv for the kv head in
//     registers, so no per-q-head dk/dv or group sum is ever materialised (the
//     TPU kernel's dq slab is race-free only on its sequential grid, :174).
// Later work: mma/wgmma tensor-core products, cp.async/TMA double buffering.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // a 16 x 16 grid of threads
constexpr int kTile = 64;              // query rows / keys per tile
constexpr int kPad = kTile + 1;        // row stride of a [64, 64] smem tile
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
};
template <> struct Num<__half> {
  __device__ static float load(const __half* p) { return __half2float(*p); }
  __device__ static void store(__half* p, float v) { *p = __float2half(v); }
  __device__ static float round(float v) {
    return __half2float(__float2half(v));
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

__device__ __forceinline__ bool visible(int qi, int kj, int S, int causal,
                                        int window) {
  return qi < S && kj < S && (!causal || kj <= qi) &&
         (window <= 0 || qi - kj < window);
}

// Rows [r0, r0 + 64) of head h of a [B, S, H, D] tensor into dst[64][D+1] as
// fp32; rows past S are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const T* __restrict__ src, int b,
                                          int h, int H, int S, int r0) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D, s = r0 + r;
    dst[r * (D + 1) + d] =
        s < S ? Num<T>::load(src + (((long long)b * S + s) * H + h) * D + d)
              : 0.f;
  }
}

// acc[i][j] += sum_k A[m_i][k] * B[n_j][k], m_i = ty + 16 i, n_j = tx + 16 j
// (both operands row-major with k contiguous).
template <int K, int NJ>
__device__ __forceinline__ void mm_nt(float (&acc)[4][NJ],
                                      const float* __restrict__ A, int lda,
                                      const float* __restrict__ B, int ldb,
                                      int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = B[(tx + 16 * j) * ldb + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k A[m_i][k] * B[k][n_j] (B row-major with n contiguous).
template <int K, int NJ>
__device__ __forceinline__ void mm_nn(float (&acc)[4][NJ],
                                      const float* __restrict__ A, int lda,
                                      const float* __restrict__ B, int ldb,
                                      int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// Key tiles [lo, hi) a query tile [q0, q0 + 64) must visit.
__device__ __forceinline__ void key_range(int q0, int S, int causal,
                                          int window, int& lo, int& hi) {
  const int q_last = min(q0 + kTile, S) - 1;
  hi = causal ? q_last + 1 : S;
  lo = window > 0 ? max(0, q0 - window + 1) / kTile * kTile : 0;
}

// ------------------------------------------------------------------ forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int Hq, int Hkv, int causal,
                 int window, float sc) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;                    // [64][D+1]
  float* ks = qs + kTile * LD;         // [64][D+1]
  float* vs = ks + kTile * LD;         // [64][D+1]
  float* ps = vs + kTile * LD;         // [64][65] p, rounded to T

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  // causal: the last q tiles have the most keys, so they start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<T, D>(qs, q, b, h, Hq, S, q0);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  key_range(q0, S, causal, window, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    __syncthreads();                   // the previous tile is consumed
    load_rows<T, D>(ks, k, b, hk, Hkv, S, k0);
    load_rows<T, D>(vs, v, b, hk, Hkv, S, k0);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    mm_nt<D, 4>(s, qs, LD, ks, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float tmax = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qi, k0 + tx + 16 * j, S, causal, window);
        s[i][j] = ok ? s[i][j] * sc : kMasked;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qi, k0 + tx + 16 * j, S, causal, window);
        const float p = ok ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        ps[(ty + 16 * i) * kPad + tx + 16 * j] = Num<T>::round(p);
      }
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    mm_nn<kTile, NJ>(acc, ps, kPad, vs, LD, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float lv = fmaxf(l[i], 1e-30f);
    T* dst = o + (((long long)b * S + qi) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) Num<T>::store(dst + tx + 16 * j, acc[i][j] / lv);
    if (tx == 0) lse[(long long)bh * S + qi] = m[i] + logf(lv);
  }
}

// ------------------------------------------------------------ backward: dq
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int S,
                    int Hq, int Hkv, int causal, int window, float sc) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;                    // [64][D+1]
  float* dos = qs + kTile * LD;        // [64][D+1]
  float* ks = dos + kTile * LD;        // [64][D+1]
  float* vs = ks + kTile * LD;         // [64][D+1]
  float* dss = vs + kTile * LD;        // [64][65] ds, rounded to T
  float* lse_s = dss + kTile * kPad;   // [64]
  float* delta_s = lse_s + kTile;      // [64]

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<T, D>(qs, q, b, h, Hq, S, q0);
  load_rows<T, D>(dos, dout, b, h, Hq, S, q0);
  __syncthreads();
  // delta = rowsum(do * o) in fp32, from the stored (dtype-rounded) o
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    float part = 0.f;
    if (qi < S) {
      const T* orow = o + (((long long)b * S + qi) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        part += dos[r * LD + tx + 16 * j] * Num<T>::load(orow + tx + 16 * j);
    }
    part = row_sum(part);
    if (tx == 0) {
      delta_s[r] = part;
      lse_s[r] = qi < S ? lse[(long long)bh * S + qi] : 0.f;
      if (qi < S) delta[(long long)bh * S + qi] = part;
    }
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int lo, hi;
  key_range(q0, S, causal, window, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    __syncthreads();
    load_rows<T, D>(ks, k, b, hk, Hkv, S, k0);
    load_rows<T, D>(vs, v, b, hk, Hkv, S, k0);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_nt<D, 4>(s, qs, LD, ks, LD, ty, tx);
    mm_nt<D, 4>(dp, dos, LD, vs, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(q0 + r, k0 + tx + 16 * j, S, causal, window);
        const float p = ok ? Num<T>::round(expf(s[i][j] * sc - lse_s[r])) : 0.f;
        dss[r * kPad + tx + 16 * j] = Num<T>::round(p * (dp[i][j] - delta_s[r]));
      }
    }
    __syncthreads();
    mm_nn<kTile, NJ>(acc, dss, kPad, ks, LD, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    T* dst = dq + (((long long)b * S + qi) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) Num<T>::store(dst + tx + 16 * j, acc[i][j] * sc);
  }
}

// --------------------------------------------------------- backward: dk, dv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Hq, int Hkv, int causal,
                     int window, float sc) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;                    // [64][D+1]
  float* vs = ks + kTile * LD;         // [64][D+1]
  float* qs = vs + kTile * LD;         // [64][D+1]
  float* dos = qs + kTile * LD;        // [64][D+1]
  float* ps = dos + kTile * LD;        // [64 keys][65] p^T, rounded to T
  float* dss = ps + kTile * kPad;      // [64 keys][65] ds^T, rounded to T
  float* lse_s = dss + kTile * kPad;   // [64]
  float* delta_s = lse_s + kTile;      // [64]

  const int bhk = blockIdx.y, b = bhk / Hkv, g = bhk % Hkv;
  const int rep = Hq / Hkv;
  const int k0 = blockIdx.x * kTile;   // causal: low kv tiles have most rows
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<T, D>(ks, k, b, g, Hkv, S, k0);
  load_rows<T, D>(vs, v, b, g, Hkv, S, k0);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // query rows that see some key of [k0, k_last]
  const int k_last = min(k0 + kTile, S) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k_last + window) : S;
  for (int h = g * rep; h < (g + 1) * rep; ++h) {
    const int bh = b * Hq + h;
    for (int q0 = q_lo; q0 < q_hi; q0 += kTile) {
      __syncthreads();
      load_rows<T, D>(qs, q, b, h, Hq, S, q0);
      load_rows<T, D>(dos, dout, b, h, Hq, S, q0);
      if (threadIdx.x < kTile) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < S ? lse[(long long)bh * S + qi] : 0.f;
        delta_s[threadIdx.x] = qi < S ? delta[(long long)bh * S + qi] : 0.f;
      }
      __syncthreads();
      float st[4][4], dpt[4][4];       // [key i][row j]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      mm_nt<D, 4>(st, ks, LD, qs, LD, ty, tx);
      mm_nt<D, 4>(dpt, vs, LD, dos, LD, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const bool ok = visible(q0 + r, k0 + key, S, causal, window);
          const float p =
              ok ? Num<T>::round(expf(st[i][j] * sc - lse_s[r])) : 0.f;
          ps[key * kPad + r] = p;
          dss[key * kPad + r] = Num<T>::round(p * (dpt[i][j] - delta_s[r]));
        }
      }
      __syncthreads();
      mm_nn<kTile, NJ>(dv_acc, ps, kPad, dos, LD, ty, tx);
      mm_nn<kTile, NJ>(dk_acc, dss, kPad, qs, LD, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= S) continue;
    const long long base = (((long long)b * S + kj) * Hkv + g) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      Num<T>::store(dk + base + tx + 16 * j, dk_acc[i][j] * sc);
      Num<T>::store(dv + base + tx + 16 * j, dv_acc[i][j]);
    }
  }
}

constexpr size_t tile_bytes(int d) { return (size_t)kTile * (d + 1) * 4; }
constexpr size_t square_bytes() { return (size_t)kTile * kPad * 4; }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int b, int s, int hq, int hkv, int causal,
                int window, cudaStream_t stream) {
  const size_t smem = 3 * tile_bytes(D) + square_bytes();
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((s + kTile - 1) / kTile, b * hq);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      s, hq, hkv, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, int b, int s, int hq, int hkv, int causal,
                int window, cudaStream_t stream) {
  const float sc = 1.0f / sqrtf((float)D);
  const int tiles = (s + kTile - 1) / kTile;
  const size_t smem_dq = 4 * tile_bytes(D) + square_bytes() + 2 * kTile * 4;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, smem_dq);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<T, D><<<dim3(tiles, b * hq), kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), s, hq, hkv, causal,
      window, sc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem_kv = 4 * tile_bytes(D) + 2 * square_bytes() + 2 * kTile * 4;
  e = allow_smem(flash_bwd_dkv_kernel<T, D>, smem_kv);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<T, D><<<dim3(tiles, b * hkv), kThreads, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), s, hq, hkv, causal, window,
      sc);
  return cudaGetLastError();
}

bool shape_ok(int b, int s, int hq, int hkv) {
  return b > 0 && s > 0 && hkv > 0 && hq % hkv == 0 &&
         (long long)b * hq <= 65535;
}

}  // namespace

// C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16;
// d in {16, 32, 64, 128}; window <= 0 means none. Each returns
// cudaGetLastError() after its launches (0 = launched).
extern "C" int ds_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int dtype, int b, int s, int hq,
                                      int hkv, int d, int causal, int window,
                                      void* stream) {
  if (!shape_ok(b, s, hq, hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_FWD(T, D) \
  return (int)fwd<T, D>(q, k, v, o, lse, b, s, hq, hkv, causal, window, st)
  if (dtype == 0) {
    if (d == 16) DS_FWD(float, 16);
    if (d == 32) DS_FWD(float, 32);
    if (d == 64) DS_FWD(float, 64);
    if (d == 128) DS_FWD(float, 128);
  } else if (dtype == 1) {
    if (d == 16) DS_FWD(__nv_bfloat16, 16);
    if (d == 32) DS_FWD(__nv_bfloat16, 32);
    if (d == 64) DS_FWD(__nv_bfloat16, 64);
    if (d == 128) DS_FWD(__nv_bfloat16, 128);
  } else if (dtype == 2) {
    if (d == 16) DS_FWD(__half, 16);
    if (d == 32) DS_FWD(__half, 32);
    if (d == 64) DS_FWD(__half, 64);
    if (d == 128) DS_FWD(__half, 128);
  }
#undef DS_FWD
  return (int)cudaErrorInvalidValue;
}

// delta: [B, Hq, S] fp32 scratch, written by the dq pass, read by dk/dv.
extern "C" int ds_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk,
                                      void* dv, int dtype, int b, int s,
                                      int hq, int hkv, int d, int causal,
                                      int window, void* stream) {
  if (!shape_ok(b, s, hq, hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_BWD(T, D)                                                         \
  return (int)bwd<T, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, s, hq, \
                        hkv, causal, window, st)
  if (dtype == 0) {
    if (d == 16) DS_BWD(float, 16);
    if (d == 32) DS_BWD(float, 32);
    if (d == 64) DS_BWD(float, 64);
    if (d == 128) DS_BWD(float, 128);
  } else if (dtype == 1) {
    if (d == 16) DS_BWD(__nv_bfloat16, 16);
    if (d == 32) DS_BWD(__nv_bfloat16, 32);
    if (d == 64) DS_BWD(__nv_bfloat16, 64);
    if (d == 128) DS_BWD(__nv_bfloat16, 128);
  } else if (dtype == 2) {
    if (d == 16) DS_BWD(__half, 16);
    if (d == 32) DS_BWD(__half, 32);
    if (d == 64) DS_BWD(__half, 64);
    if (d == 128) DS_BWD(__half, 128);
  }
#undef DS_BWD
  return (int)cudaErrorInvalidValue;
}

// Message of a code returned above.
extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
