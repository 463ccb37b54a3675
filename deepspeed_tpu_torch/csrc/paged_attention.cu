// Paged (blocked-flash) attention over a block-table KV pool, for Hopper.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/inference/v2/paged.py:61
// `paged_attention_kernel` (fp pools). Per batch row b and query row i it
// computes softmax(q k^T / sqrt(D) [+ alibi]) v over
//   * the row's cached keys at absolute positions [0, pos0[b]), read from
//     the pools through block_tables[b] (entries clamped to [0, nb-1]), and
//   * this chunk's fresh keys k_new/v_new at positions pos0[b] + j,
//     j < true_len[b], causal within the chunk,
// with an optional sliding window (qpos - kpos < window) and ALiBi slopes.
// Query rows >= true_len[b] are written as zeros. Scores, softmax and the
// output accumulate in fp32; the output is q's dtype.
//
// What bounds it on an H100: bytes. A decode row reads 2*ctx*Hkv*D*itemsize
// bytes of KV per layer (3.35 TB/s) and does 4*ctx*Hq*D flops, far below the
// card's ridge point. Design, simple first:
//   * one thread block per (batch row, kv head, tile of query rows); the
//     tile holds the GQA group's rep q heads for its query rows, so every
//     K/V element a block loads is used by all rep heads sharing it;
//   * the TPU kernel's sequential page-slot grid axis (which carried the
//     running max/sum/output in VMEM scratch) becomes a loop inside the
//     block over 32-key tiles: the tile's keys are staged in shared memory
//     as fp32 with 16-byte loads, then each warp updates the online softmax
//     of its rows (lane = key for the scores, lane = channel for p.v);
//   * only keys some row of the block can see are loaded (the window and the
//     causal bound trim the range); out-of-range tile slots are zero-filled,
//     never read, so the kernel does not rely on the pools' dead slots.
// Later work: wgmma/TMA for prefill chunks, split-K over long contexts for
// small decode batches, double-buffered tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeyTile = 32;          // keys per tile: one per lane
constexpr float kMasked = -1e30f;     // score of a masked key
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Vec;     // 16-byte loads converted to fp32
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float load_one(const float* p) { return *p; }
__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Shared-memory tile of kKeyTile keys: K rows padded to D+1 floats so that
// lane j reading key j's channel d hits bank (j + d) % 32 (no conflicts).
template <int D> struct Tile {
  float k[kKeyTile * (D + 1)];
  float v[kKeyTile * D];
  long long base[kKeyTile];           // element offset of each key, -1 = none
};

// Stage keys whose element offsets are in tile.base (set by the caller).
template <typename T, int D>
__device__ __forceinline__ void load_tile(Tile<D>& tile, const T* __restrict__ ksrc,
                          const T* __restrict__ vsrc) {
  constexpr int N = Vec<T>::N;
  constexpr int kChunks = D / N;
  for (int i = threadIdx.x; i < kKeyTile * kChunks; i += kThreads) {
    const int j = i / kChunks, c = i % kChunks;
    const long long base = tile.base[j];
    float kf[N], vf[N];
    if (base >= 0) {
      Vec<T>::load(ksrc + base + c * N, kf);
      Vec<T>::load(vsrc + base + c * N, vf);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) { kf[e] = 0.f; vf[e] = 0.f; }
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      tile.k[j * (D + 1) + c * N + e] = kf[e];
      tile.v[j * D + c * N + e] = vf[e];
    }
  }
}

template <int D, int RPW> struct RowState {
  static constexpr int kDpl = (D + 31) / 32;   // output channels per lane
  float m[RPW], l[RPW], o[RPW][kDpl];
};

// Fold one staged tile into the running softmax of this warp's rows. Key
// lane sits at absolute position kpos0 + lane; tile.base[lane] < 0 marks a
// key outside the range the caller asked for.
template <int D, int RPW>
__device__ __forceinline__ void fold_tile(const Tile<D>& tile, const float* __restrict__ q_s,
                          RowState<D, RPW>& st, const int* qpos,
                          const int* head, const bool* live, int kpos0,
                          int window, const float* __restrict__ slopes,
                          float scale) {
  constexpr int kDpl = RowState<D, RPW>::kDpl;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kpos = kpos0 + lane;
  const bool key_ok = tile.base[lane] >= 0;
  const float* krow = &tile.k[lane * (D + 1)];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (!live[r]) continue;                     // uniform across the warp
    const float* qrow = &q_s[(warp * RPW + r) * D];
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
    s *= scale;
    if (slopes != nullptr) s += slopes[head[r]] * (float)(kpos - qpos[r]);
    const bool ok = key_ok && kpos <= qpos[r] &&
                    (window <= 0 || qpos[r] - kpos < window);
    s = ok ? s : kMasked;
    const float tmax = warp_max(s);
    if (tmax == kMasked) continue;              // no visible key in tile
    const float m_new = fmaxf(st.m[r], tmax);
    const float corr = expf(st.m[r] - m_new);
    const float p = ok ? expf(s - m_new) : 0.f;
    st.l[r] = st.l[r] * corr + warp_sum(p);
    st.m[r] = m_new;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) st.o[r][i] *= corr;
#pragma unroll 8
    for (int j = 0; j < kKeyTile; ++j) {
      const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
      for (int i = 0; i < kDpl; ++i) {
        const int d = lane + 32 * i;
        if (d < D) st.o[r][i] = fmaf(pj, tile.v[j * D + d], st.o[r][i]);
      }
    }
  }
}

template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                       const T* __restrict__ v_new,
                       const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos0s,
                       const int* __restrict__ tlens,
                       const float* __restrict__ slopes, T* __restrict__ out,
                       int sq, int hq, int hkv, int nb, int bs,
                       int max_blocks, int window, float scale) {
  constexpr int R = kWarps * RPW;             // (query, head) rows / block
  constexpr int kDpl = RowState<D, RPW>::kDpl;
  __shared__ Tile<D> tile;
  __shared__ float q_s[R * D];

  const int b = blockIdx.x, g = blockIdx.y;
  const int rep = hq / hkv;
  const int rows = sq * rep;                  // flattened (query, head) rows
  const int row0 = blockIdx.z * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = pos0s[b], tl = tlens[b];

  // this warp's rows: flattened row gr -> query gr / rep, head g*rep + gr%rep
  int qi[RPW], qpos[RPW], head[RPW];
  bool live[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int gr = row0 + warp * RPW + r;
    qi[r] = gr / rep;
    qpos[r] = p0 + qi[r];
    head[r] = g * rep + gr % rep;
    live[r] = gr < rows && qi[r] < tl;
  }

  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int gr = row0 + i / D, d = i % D;
    const int qq = gr / rep, h = g * rep + gr % rep;
    q_s[i] = (gr < rows && qq < tl)
                 ? load_one(q + (((long long)b * sq + qq) * hq + h) * D + d)
                 : 0.f;
  }

  RowState<D, RPW> st;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    st.m[r] = kMasked;
    st.l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) st.o[r][i] = 0.f;
  }

  // live query range of the block (inclusive); empty when no row is live
  const int q_lo = row0 / rep;
  const int q_hi = min(min(row0 + R, rows) - 1, rep * min(sq, tl) - 1) / rep;
  const bool any_live = q_lo < min(sq, tl) && row0 < rows;

  // cached keys: positions [page_lo, page_hi); the window bounds the oldest
  // key the block's first query can see, and pages past the table are none
  int page_hi = any_live ? min(p0, max_blocks * bs) : 0;
  int page_lo = (window > 0) ? max(0, p0 + q_lo - window + 1) : 0;
  for (int t0 = page_lo; t0 < page_hi; t0 += kKeyTile) {
    __syncthreads();                          // previous tile consumed
    if (threadIdx.x < kKeyTile) {
      const int kp = t0 + threadIdx.x;
      long long base = -1;
      if (kp < page_hi) {
        int blk = tables[(long long)b * max_blocks + kp / bs];
        blk = min(max(blk, 0), nb - 1);
        base = (((long long)blk * bs + kp % bs) * hkv + g) * D;
      }
      tile.base[threadIdx.x] = base;
    }
    __syncthreads();
    load_tile<T, D>(tile, k_pool, v_pool);
    __syncthreads();
    fold_tile<D, RPW>(tile, q_s, st, qpos, head, live, t0, window, slopes,
                      scale);
  }

  // fresh chunk: key j at position p0 + j, j < true_len; causal, so no row
  // of this block sees j > q_hi. Folded even when the row has no pages.
  const int fresh_hi = any_live ? q_hi + 1 : 0;
  const int fresh_lo = (window > 0) ? max(0, q_lo - window + 1) : 0;
  for (int j0 = fresh_lo; j0 < fresh_hi; j0 += kKeyTile) {
    __syncthreads();
    if (threadIdx.x < kKeyTile) {
      const int j = j0 + threadIdx.x;
      tile.base[threadIdx.x] =
          j < fresh_hi ? (((long long)b * sq + j) * hkv + g) * D : -1;
    }
    __syncthreads();
    load_tile<T, D>(tile, k_new, v_new);
    __syncthreads();
    fold_tile<D, RPW>(tile, q_s, st, qpos, head, live, p0 + j0, window,
                      slopes, scale);
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int gr = row0 + warp * RPW + r;
    if (gr >= rows) continue;
    const float inv = live[r] ? 1.f / fmaxf(st.l[r], 1e-30f) : 0.f;
    T* dst = out + (((long long)b * sq + qi[r]) * hq + head[r]) * D;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) {
      const int d = lane + 32 * i;
      if (d < D) store_one(dst + d, live[r] ? st.o[r][i] * inv : 0.f);
    }
  }
}

template <typename T, int D, int RPW>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* k_pool, const void* v_pool, const void* tables,
                   const void* pos0, const void* true_len, const void* slopes,
                   void* out, int b, int sq, int hq, int hkv, int nb, int bs,
                   int max_blocks, int window, cudaStream_t stream) {
  constexpr int R = kWarps * RPW;
  const long long rows = (long long)sq * (hq / hkv);
  const long long zt = (rows + R - 1) / R;
  if (zt > 65535 || hkv > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(b, hkv, (unsigned)zt);
  paged_attention_kernel<T, D, RPW><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(pos0), static_cast<const int*>(true_len),
      static_cast<const float*>(slopes), static_cast<T*>(out), sq, hq, hkv,
      nb, bs, max_blocks, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_rows(int rows, const void* q, const void* k_new,
                          const void* v_new, const void* k_pool,
                          const void* v_pool, const void* tables,
                          const void* pos0, const void* true_len,
                          const void* slopes, void* out, int b, int sq, int hq,
                          int hkv, int nb, int bs, int max_blocks, int window,
                          cudaStream_t stream) {
  // decode (few rows: the GQA group of one query) wants small blocks so
  // no warp idles; prefill chunks share each K/V tile across 16 rows
  if (rows <= kWarps)
    return launch<T, D, 1>(q, k_new, v_new, k_pool, v_pool, tables, pos0,
                           true_len, slopes, out, b, sq, hq, hkv, nb, bs,
                           max_blocks, window, stream);
  if (rows <= 2 * kWarps)
    return launch<T, D, 2>(q, k_new, v_new, k_pool, v_pool, tables, pos0,
                           true_len, slopes, out, b, sq, hq, hkv, nb, bs,
                           max_blocks, window, stream);
  return launch<T, D, 4>(q, k_new, v_new, k_pool, v_pool, tables, pos0,
                         true_len, slopes, out, b, sq, hq, hkv, nb, bs,
                         max_blocks, window, stream);
}

template <typename T>
cudaError_t dispatch_dim(int d, int rows, const void* q, const void* k_new,
                         const void* v_new, const void* k_pool,
                         const void* v_pool, const void* tables,
                         const void* pos0, const void* true_len,
                         const void* slopes, void* out, int b, int sq, int hq,
                         int hkv, int nb, int bs, int max_blocks, int window,
                         cudaStream_t stream) {
#define DS_PA_DIM(DIM)                                                      \
  case DIM:                                                                 \
    return dispatch_rows<T, DIM>(rows, q, k_new, v_new, k_pool, v_pool,     \
                                 tables, pos0, true_len, slopes, out, b, sq, \
                                 hq, hkv, nb, bs, max_blocks, window, stream);
  switch (d) {
    DS_PA_DIM(16)
    DS_PA_DIM(32)
    DS_PA_DIM(64)
    DS_PA_DIM(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DS_PA_DIM
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// slopes may be null (no ALiBi); window <= 0 means no sliding window.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ds_paged_attention(const void* q, const void* k_new,
                                  const void* v_new, const void* k_pool,
                                  const void* v_pool, const void* tables,
                                  const void* pos0, const void* true_len,
                                  const void* slopes, void* out, int dtype,
                                  int b, int sq, int hq, int hkv, int d,
                                  int nb, int bs, int max_blocks, int window,
                                  void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || nb <= 0 || bs <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int rows = sq * (hq / hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dim<float>(d, rows, q, k_new, v_new, k_pool, v_pool,
                              tables, pos0, true_len, slopes, out, b, sq, hq,
                              hkv, nb, bs, max_blocks, window, s);
  else if (dtype == 1)
    err = dispatch_dim<__nv_bfloat16>(d, rows, q, k_new, v_new, k_pool,
                                      v_pool, tables, pos0, true_len, slopes,
                                      out, b, sq, hq, hkv, nb, bs, max_blocks,
                                      window, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// Message of a code returned by ds_paged_attention.
extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
