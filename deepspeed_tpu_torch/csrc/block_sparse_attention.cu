// Block-sparse attention, forward and backward, for Hopper (CUDA cores).
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/sparse_attention/kernels.py:
//   * `_sparse_fwd` (:121, body `_fwd_kernel` :79): online-softmax attention
//     of each q block over only its live k blocks (the row's `jmap` list of
//     `counts` blocks); writes o and the log-sum-exp lse;
//   * `_sparse_bwd` (:210, body `_bwd_kernel` :163): recomputes
//     p = exp(s - lse) over the live blocks and forms dv = p^T do,
//     ds = p (do v^T - delta), dk = ds^T q sc, dq = ds k sc, with
//     delta = rowsum(do o), walking the transposed lists (`imap`, `countsT`).
// Layouts: q/k/v/o/do/dq/dk/dv [B, H, S, D] (the reference sparse-attention
// layout); lse and delta [B, H, S] fp32; jmap [H, nq, L] and counts [H, nq],
// imap [H, nk, LT] and countsT [H, nk] int32, nq = nk = S / block. fp32, bf16
// or fp16; scores, softmax and sums in fp32. As in the TPU kernels, masking
// is by whole blocks only (no token mask inside a live block), p (forward and
// backward) and ds are rounded to the input dtype before the products that
// consume them, and a row with no live block returns o = 0 (lse = -1e30) and
// gets dq = 0: the kernels' documented divergence from dense softmax.
//
// What bounds it on an H100: at the sparse layouts of DeepSpeed's examples
// (block 16, ~26% of blocks live at S 4096) the live work is ~130 flops per
// byte moved, so the tensor cores would make it bound by operations near
// the byte line; this first port does its products as fp32 FMAs on CUDA
// cores out of shared memory and is bound by those operations and the
// shared-memory reads that feed them. Design, simple first:
//   * a row's live k blocks are read as one stream of count * block keys
//     (key t is row t % block of block jmap[t / block]), staged in chunks
//     of 64 keys in shared memory as fp32 (row stride D+1: conflict-free
//     column walks), so any block size that is a multiple of 8 runs the
//     same code and a block of 16 does not leave 16-key tiles idle;
//   * a thread block owns a tile of TY query rows of one q block (TY = 16,
//     or 8 when the block is not a multiple of 16), 16 threads per row: a
//     thread owns 4 keys of each chunk's scores and D/16 channels of the
//     row's accumulators, in registers; row max/sum are 16-lane shuffles;
//   * nothing carries between thread blocks on the GPU, so the TPU's
//     sequential grid axis over live blocks becomes a loop inside the block,
//     and the backward is two launches with no atomics (deterministic): the
//     dq pass, one block per (b*H, query tile) over the jmap lists, first
//     forms and writes delta for its rows; the dk/dv pass, one block per
//     (b*H, key tile) over the imap lists. (The TPU backward's dq slab is
//     race-free only because its grid runs in order, kernels.py:173-175.)
//   * head_dim up to 128: the kernels are compiled for 16, 32, 64 and 128
//     channels and a smaller multiple of 8 is zero-padded in shared memory.
// Known limit, left to a later PR: in the dk/dv pass a key tile of a global
// column walks every q block while a local one walks a few (256 against 4
// at the layout above), so a few blocks do ~60x the work of the rest.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;             // keys (or query rows) per staged chunk
constexpr int kPad = kChunk + 1;       // row stride of a [TY, 64] smem tile
constexpr float kMasked = -1e30f;      // the JAX NEG_INF
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

// Rows [r0, r0 + rows) of one (b, h) [S, D] slab into dst[rows][DP+1] as
// fp32, channels D..DP-1 zero.
template <typename T, int DP, int NT>
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const T* __restrict__ src, int r0,
                                          int rows, int D) {
  for (int i = threadIdx.x; i < rows * DP; i += NT) {
    const int r = i / DP, d = i % DP;
    dst[r * (DP + 1) + d] =
        d < D ? Num<T>::load(src + (long long)(r0 + r) * D + d) : 0.f;
  }
}

// Entries [t0, t0 + 64) of a stream of n rows through the live blocks
// `live` (entry t is row t % block of block live[t / block]) into
// dst[64][DP+1] as fp32; entries past n are zeros.
template <typename T, int DP, int NT>
__device__ __forceinline__ void load_stream(float* __restrict__ dst,
                                            const T* __restrict__ src,
                                            const int* __restrict__ live,
                                            int block, int t0, int n, int D) {
  for (int i = threadIdx.x; i < kChunk * DP; i += NT) {
    const int r = i / DP, d = i % DP, t = t0 + r;
    float val = 0.f;
    if (t < n && d < D) {
      const int row = live[t / block] * block + t % block;
      val = Num<T>::load(src + (long long)row * D + d);
    }
    dst[r * (DP + 1) + d] = val;
  }
}

// Row `row` of the entry-t index of a stream (as load_stream), or -1.
__device__ __forceinline__ int stream_row(const int* __restrict__ live,
                                          int block, int t, int n) {
  return t < n ? live[t / block] * block + t % block : -1;
}

// s[j] += A[a] . B[tx + 16 j] over DP channels (both row-major, stride DP+1).
template <int DP>
__device__ __forceinline__ void dot4(float (&s)[4], const float* __restrict__ a,
                                     const float* __restrict__ B, int tx) {
#pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    const float av = a[d];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s[j] = fmaf(av, B[(tx + 16 * j) * (DP + 1) + d], s[j]);
  }
}

// acc[j] += sum_t w[t] * B[t][tx + 16 j] over the 64 entries of a chunk.
template <int DP>
__device__ __forceinline__ void axpy_rows(float (&acc)[DP / 16],
                                          const float* __restrict__ w,
                                          const float* __restrict__ B,
                                          int tx) {
#pragma unroll 4
  for (int t = 0; t < kChunk; ++t) {
    const float wt = w[t];
#pragma unroll
    for (int j = 0; j < DP / 16; ++j)
      acc[j] = fmaf(wt, B[t * (DP + 1) + tx + 16 * j], acc[j]);
  }
}

// ------------------------------------------------------------------ forward
template <typename T, int DP, int TY>
__global__ void __launch_bounds__(TY * 16)
bs_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, const int* __restrict__ jmap,
              const int* __restrict__ counts, int H, int S, int D, int block,
              int L, float sc) {
  constexpr int NT = TY * 16, NJ = DP / 16, LD = DP + 1;
  extern __shared__ float smem[];
  float* qs = smem;                    // [TY][LD]
  float* ks = qs + TY * LD;            // [64][LD]
  float* vs = ks + kChunk * LD;        // [64][LD]
  float* ps = vs + kChunk * LD;        // [TY][65] p, rounded to T

  const int bh = blockIdx.y, h = bh % H, nq = S / block;
  const int r0 = blockIdx.x * TY, qb = r0 / block;
  const int n = counts[h * nq + qb] * block;       // live keys of the row
  const int* live = jmap + ((long long)h * nq + qb) * L;
  const long long base = (long long)bh * S * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<T, DP, NT>(qs, q + base, r0, TY, D);
  float m = kMasked, l = 0.f, acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    __syncthreads();                   // the previous chunk is consumed
    load_stream<T, DP, NT>(ks, k + base, live, block, c0, n, D);
    load_stream<T, DP, NT>(vs, v + base, live, block, c0, n, D);
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    dot4<DP>(s, qs + ty * LD, ks, tx);
    float tmax = kMasked;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = c0 + tx + 16 * j < n ? s[j] * sc : kMasked;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, row_max(tmax));
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = c0 + tx + 16 * j < n ? expf(s[j] - m_new) : 0.f;
      psum += p;
      ps[ty * kPad + tx + 16 * j] = Num<T>::round(p);
    }
    l = l * corr + row_sum(psum);
    m = m_new;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= corr;
    __syncthreads();
    axpy_rows<DP>(acc, ps + ty * kPad, vs, tx);
  }

  const int row = r0 + ty;
  const float lv = fmaxf(l, 1e-30f);   // a dead row: acc = 0, so o = 0
  T* dst = o + base + (long long)row * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (tx + 16 * j < D) Num<T>::store(dst + tx + 16 * j, acc[j] / lv);
  if (tx == 0) lse[(long long)bh * S + row] = m + logf(lv);
}

// ------------------------------------------------------------ backward: dq
template <typename T, int DP, int TY>
__global__ void __launch_bounds__(TY * 16)
bs_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ delta, T* __restrict__ dq,
                 const int* __restrict__ jmap, const int* __restrict__ counts,
                 int H, int S, int D, int block, int L, float sc) {
  constexpr int NT = TY * 16, NJ = DP / 16, LD = DP + 1;
  extern __shared__ float smem[];
  float* qs = smem;                    // [TY][LD]
  float* dos = qs + TY * LD;           // [TY][LD]
  float* ks = dos + TY * LD;           // [64][LD]
  float* vs = ks + kChunk * LD;        // [64][LD]
  float* dss = vs + kChunk * LD;       // [TY][65] ds, rounded to T
  float* lse_s = dss + TY * kPad;      // [TY]
  float* delta_s = lse_s + TY;         // [TY]

  const int bh = blockIdx.y, h = bh % H, nq = S / block;
  const int r0 = blockIdx.x * TY, qb = r0 / block;
  const int n = counts[h * nq + qb] * block;
  const int* live = jmap + ((long long)h * nq + qb) * L;
  const long long base = (long long)bh * S * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row = r0 + ty;

  load_rows<T, DP, NT>(qs, q + base, r0, TY, D);
  load_rows<T, DP, NT>(dos, dout + base, r0, TY, D);
  __syncthreads();
  // delta = rowsum(do * o) in fp32, from the stored (dtype-rounded) o
  float part = 0.f;
  const T* orow = o + base + (long long)row * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (tx + 16 * j < D)
      part += dos[ty * LD + tx + 16 * j] * Num<T>::load(orow + tx + 16 * j);
  part = row_sum(part);
  if (tx == 0) {
    delta_s[ty] = part;
    lse_s[ty] = lse[(long long)bh * S + row];
    delta[(long long)bh * S + row] = part;
  }

  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    __syncthreads();
    load_stream<T, DP, NT>(ks, k + base, live, block, c0, n, D);
    load_stream<T, DP, NT>(vs, v + base, live, block, c0, n, D);
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    dot4<DP>(s, qs + ty * LD, ks, tx);
    dot4<DP>(dp, dos + ty * LD, vs, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = c0 + tx + 16 * j < n
                          ? Num<T>::round(expf(s[j] * sc - lse_s[ty]))
                          : 0.f;
      dss[ty * kPad + tx + 16 * j] = Num<T>::round(p * (dp[j] - delta_s[ty]));
    }
    __syncthreads();
    axpy_rows<DP>(acc, dss + ty * kPad, ks, tx);
  }

  T* dst = dq + base + (long long)row * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (tx + 16 * j < D) Num<T>::store(dst + tx + 16 * j, acc[j] * sc);
}

// --------------------------------------------------------- backward: dk, dv
template <typename T, int DP, int TY>
__global__ void __launch_bounds__(TY * 16)
bs_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, const int* __restrict__ imap,
                  const int* __restrict__ countsT, int H, int S, int D,
                  int block, int LT, float sc) {
  constexpr int NT = TY * 16, NJ = DP / 16, LD = DP + 1;
  extern __shared__ float smem[];
  float* ks = smem;                    // [TY][LD]
  float* vs = ks + TY * LD;            // [TY][LD]
  float* qs = vs + TY * LD;            // [64][LD]
  float* dos = qs + kChunk * LD;       // [64][LD]
  float* ps = dos + kChunk * LD;       // [TY keys][65] p^T, rounded to T
  float* dss = ps + TY * kPad;         // [TY keys][65] ds^T, rounded to T
  float* lse_s = dss + TY * kPad;      // [64]
  float* delta_s = lse_s + kChunk;     // [64]

  const int bh = blockIdx.y, h = bh % H, nk = S / block;
  const int k0 = blockIdx.x * TY, kb = k0 / block;
  const int n = countsT[h * nk + kb] * block;      // query rows seeing kb
  const int* live = imap + ((long long)h * nk + kb) * LT;
  const long long base = (long long)bh * S * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<T, DP, NT>(ks, k + base, k0, TY, D);
  load_rows<T, DP, NT>(vs, v + base, k0, TY, D);
  float dk_acc[NJ], dv_acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    __syncthreads();
    load_stream<T, DP, NT>(qs, q + base, live, block, c0, n, D);
    load_stream<T, DP, NT>(dos, dout + base, live, block, c0, n, D);
    for (int i = threadIdx.x; i < kChunk; i += NT) {
      const int r = stream_row(live, block, c0 + i, n);
      lse_s[i] = r >= 0 ? lse[(long long)bh * S + r] : 0.f;
      delta_s[i] = r >= 0 ? delta[(long long)bh * S + r] : 0.f;
    }
    __syncthreads();
    float st[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
    dot4<DP>(st, ks + ty * LD, qs, tx);    // [key ty][query tx + 16 j]
    dot4<DP>(dpt, vs + ty * LD, dos, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int slot = tx + 16 * j;
      const float p = c0 + slot < n
                          ? Num<T>::round(expf(st[j] * sc - lse_s[slot]))
                          : 0.f;
      ps[ty * kPad + slot] = p;
      dss[ty * kPad + slot] = Num<T>::round(p * (dpt[j] - delta_s[slot]));
    }
    __syncthreads();
    axpy_rows<DP>(dv_acc, ps + ty * kPad, dos, tx);
    axpy_rows<DP>(dk_acc, dss + ty * kPad, qs, tx);
  }

  const long long at = base + (long long)(k0 + ty) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (tx + 16 * j >= D) continue;
    Num<T>::store(dk + at + tx + 16 * j, dk_acc[j] * sc);
    Num<T>::store(dv + at + tx + 16 * j, dv_acc[j]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

constexpr size_t rows_bytes(int rows, int dp) {
  return (size_t)rows * (dp + 1) * 4;
}

template <typename T, int DP, int TY>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, const int* jmap, const int* counts, int b, int h,
                int s, int d, int block, int L, cudaStream_t stream) {
  const size_t smem = rows_bytes(TY, DP) + 2 * rows_bytes(kChunk, DP) +
                      (size_t)TY * kPad * 4;
  cudaError_t e = allow_smem(bs_fwd_kernel<T, DP, TY>, smem);
  if (e != cudaSuccess) return e;
  bs_fwd_kernel<T, DP, TY><<<dim3(s / TY, b * h), TY * 16, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      jmap, counts, h, s, d, block, L, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

template <typename T, int DP, int TY>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, const int* jmap, const int* counts,
                int L, const int* imap, const int* countsT, int LT, int b,
                int h, int s, int d, int block, cudaStream_t stream) {
  const float sc = 1.0f / sqrtf((float)d);
  const dim3 grid(s / TY, b * h);
  const size_t smem_dq = 2 * rows_bytes(TY, DP) + 2 * rows_bytes(kChunk, DP) +
                         (size_t)TY * kPad * 4 + 2 * TY * 4;
  cudaError_t e = allow_smem(bs_bwd_dq_kernel<T, DP, TY>, smem_dq);
  if (e != cudaSuccess) return e;
  bs_bwd_dq_kernel<T, DP, TY><<<grid, TY * 16, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), jmap, counts, h, s, d,
      block, L, sc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem_kv = 2 * rows_bytes(TY, DP) + 2 * rows_bytes(kChunk, DP) +
                         2 * (size_t)TY * kPad * 4 + 2 * kChunk * 4;
  e = allow_smem(bs_bwd_dkv_kernel<T, DP, TY>, smem_kv);
  if (e != cudaSuccess) return e;
  bs_bwd_dkv_kernel<T, DP, TY><<<grid, TY * 16, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), imap, countsT, h, s, d, block,
      LT, sc);
  return cudaGetLastError();
}

bool shape_ok(int b, int h, int s, int d, int block) {
  return b > 0 && h > 0 && (long long)b * h <= 65535 && block >= 8 &&
         block % 8 == 0 && s % block == 0 && d > 0 && d % 8 == 0 && d <= 128;
}

}  // namespace

// Calls F(T, DP, TY) for the dtype code (0 = float32, 1 = bfloat16,
// 2 = float16), the channel count the kernel is compiled for (the least of
// 16, 32, 64, 128 that holds d) and the query tile (16 when block is a
// multiple of 16, else 8).
#define DS_DISPATCH_TY(F, T, DP) \
  if (block % 16 == 0) F(T, DP, 16); \
  F(T, DP, 8)
#define DS_DISPATCH_DP(F, T)                      \
  if (d <= 16) { DS_DISPATCH_TY(F, T, 16); }      \
  if (d <= 32) { DS_DISPATCH_TY(F, T, 32); }      \
  if (d <= 64) { DS_DISPATCH_TY(F, T, 64); }      \
  DS_DISPATCH_TY(F, T, 128)
#define DS_DISPATCH(F)                                     \
  if (dtype == 0) { DS_DISPATCH_DP(F, float); }            \
  if (dtype == 1) { DS_DISPATCH_DP(F, __nv_bfloat16); }    \
  if (dtype == 2) { DS_DISPATCH_DP(F, __half); }           \
  return (int)cudaErrorInvalidValue

// C entry points, bound with ctypes. Each returns cudaGetLastError() after
// its launches (0 = launched). block: a multiple of 8 dividing s; d: a
// multiple of 8 up to 128; L: the length of a jmap row.
extern "C" int ds_block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* jmap, const void* counts, int L, int dtype, int b, int h,
    int s, int d, int block, void* stream) {
  if (!shape_ok(b, h, s, d, block)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* jm = static_cast<const int*>(jmap);
  const int* ct = static_cast<const int*>(counts);
#define DS_FWD(T, DP, TY) \
  return (int)fwd<T, DP, TY>(q, k, v, o, lse, jm, ct, b, h, s, d, block, L, st)
  DS_DISPATCH(DS_FWD);
#undef DS_FWD
}

// delta: [B, H, S] fp32 scratch, written by the dq pass, read by dk/dv.
// LT: the length of an imap row.
extern "C" int ds_block_sparse_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const void* jmap, const void* counts, int L, const void* imap,
    const void* countsT, int LT, int dtype, int b, int h, int s, int d,
    int block, void* stream) {
  if (!shape_ok(b, h, s, d, block)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* jm = static_cast<const int*>(jmap);
  const int* ct = static_cast<const int*>(counts);
  const int* im = static_cast<const int*>(imap);
  const int* ctT = static_cast<const int*>(countsT);
#define DS_BWD(T, DP, TY)                                                    \
  return (int)bwd<T, DP, TY>(q, k, v, o, dout, lse, delta, dq, dk, dv, jm,   \
                             ct, L, im, ctT, LT, b, h, s, d, block, st)
  DS_DISPATCH(DS_BWD);
#undef DS_BWD
}

#undef DS_DISPATCH
#undef DS_DISPATCH_DP
#undef DS_DISPATCH_TY

// Message of a code returned above.
extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
