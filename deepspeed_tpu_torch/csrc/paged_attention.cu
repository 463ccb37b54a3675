// Paged (blocked-flash) attention over a block-table KV pool, for Hopper.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/inference/v2/paged.py:61
// `paged_attention_kernel`, in both its modes: fp pools, and quantized pools
// (int8 or fp8-e4m3 codes with per-vector f32 scales, :81-91, :150-165).
// Per batch row b and query row i it
// computes softmax(q k^T / sqrt(D) [+ alibi]) v over
//   * the row's cached keys at absolute positions [0, pos0[b]), read from
//     the pools through block_tables[b] (entries clamped to [0, nb-1]), and
//   * this chunk's fresh keys k_new/v_new at positions pos0[b] + j,
//     j < true_len[b], causal within the chunk,
// with an optional sliding window (qpos - kpos < window) and ALiBi slopes.
// Query rows >= true_len[b] are written as zeros. Scores, softmax and the
// output accumulate in fp32; the output is q's dtype.
//
// Quantized pools: the pool's storage type P is a template parameter apart
// from the compute type T of q, k_new, v_new and out. A pool key or value is
// its code times the scale of its (block, slot, head % Hs), Hs = Hkv (per
// head) or 1 (per token), read through the same clamped block-table offset.
// The fresh chunk is folded unquantized.
//
// Three kernels, chosen from the call's shapes by a table
// (ds_paged_attention_variant; never a retry). rows = Sq * Hq / Hkv, the
// flattened (query, head) rows one kv head serves:
//
// * "decode_split" (rows <= 16: the decode ticks; fp32, bf16 and fp16, any
//   pool).
//   What bounds it: bytes. A decode row reads 2 ctx Hkv D itemsize bytes of
//   KV a layer and does ~1 flop a byte. One thread block per (batch row, kv
//   head) walking the whole context would leave most of the 132 SMs idle
//   behind the longest row, so paged_decode_split_kernel cuts each row's
//   context into splits of K = 128 keys (64 for fp32 at D 256, whose K and
//   V of 128 keys would pass a block's shared memory: kSplitKeys) at fixed
//   positions [K s, K s + K), one block per (split, kv head, batch row);
//   the number of splits is ceil(max_blocks * bs / K), from the table's
//   shape, never from pos0's values, so the wrapper reads nothing back and
//   the call can be captured in a CUDA graph. A block issues all of its
//   split's K and V as 16-byte cp.async at once (K and V in two groups, so
//   the scores start while V is in flight), keeps them in the pool's type
//   in shared memory, and serves every (query, head) row of the GQA group
//   from each staged key on the CUDA cores (at ~1 flop a byte tensor cores
//   buy nothing): 256 / K threads a key for the scores (a share of its
//   channels each), the block's max and sum by shuffles, then p v with a
//   thread per (row, two channels) over the live keys. Everything stays
//   fp32. It writes the partials (m, l, o) to a
//   workspace the wrapper takes from PyTorch's allocator; a split past its
//   row's context writes an empty one (m = -1e30, l = 0, o = 0).
//   paged_decode_combine_kernel, one block per (kv head, batch row), folds
//   the partials in split order (no atomics: reruns give the same bits),
//   then this chunk's fresh keys, and writes the output.
// * "prefill_wgmma" (bf16 and fp16, rows > 16: prefill chunks and mixed
//   ticks).
//   What bounds it: at a prefill chunk's 16 queries x 4 heads a staged key
//   the products are ~64 flops a byte, so they must run on the tensor cores.
//   paged_prefill_tc_kernel: a block owns 128 flattened rows of one (b, kv
//   head), two warpgroups of 64 (wgmma's M) over Q loaded once into a
//   swizzled Tile<D> (hopper_tiles.cuh), so every staged K/V element serves
//   128 rows (half the K/V traffic a row of one warpgroup a block). The
//   keys stream in 64-key chunks (32 at D 256, where Q and three stages of
//   64-key K and V tiles would pass the 227 KiB a block may take:
//   kChunkOf) through a 3-stage cp.async ring, two chunks in flight while
//   one is multiplied: first the
//   cached keys the block's rows can see, gathered by 16-byte rows through
//   the block table (a block size under 64 fills a chunk from several
//   pages, one over a chunk is cut into chunk-row pieces; the swizzle
//   follows the row's place in the chunk), then the fresh keys. S = Q K^T by wgmma
//   (mma_ss), the position mask and ALiBi (a slope per row's q head), the
//   online softmax in registers, P rounded to q's type in registers (to_a,
//   where the JAX kernel rounds p to v's dtype, paged.py:218), O += P V by
//   wgmma (mma_rs). A block whose rows all lie at or past true_len writes
//   zeros and stops, and a warpgroup whose rows all do skips its products,
//   so a mixed tick's decode rows (true_len 1) cost one block each and the
//   products of one warpgroup.
//   Quantized pools: int8 and e4m3 codes convert to bf16 and fp16 exactly,
//   so the codes arrive by cp.async into a staging buffer and are converted
//   in the tile; each key's scale multiplies its column of S after the
//   product. bf16 folds each value's scale into P before P is rounded;
//   fp16 cannot (P times a scale of amax / 127 leaves fp16's normal range
//   for small values), so there the V tile holds code x scale, one fp32
//   product rounded once to fp16, which is as exact as the fp16 values the
//   codes were made from. The JAX kernel keeps p and the dequantized values
//   in fp32 there (paged.py:155-170): rounding P (and fp16's V tile) is
//   where this kernel rounds more than the reference.
//   Left for later: the softmax does not overlap the products (no warp
//   specialisation), and a mixed tick's decode row walks its whole context
//   in one block.
// * "cuda_cores" (fp32, rows > 16): paged_attention_kernel, exact fp32 FMAs
//   (a TF32 product keeps ~3 digits): one block per (batch row, kv head, 16
//   rows) walks 32-key tiles staged as fp32 in shared memory.
//
// Head dims: 16, 32, 64, 128, and 80, 96 and 256 for the model families
// that have them (Phi-2; Phi-3-mini and GPT-NeoX-20B; GPT-J-6B). The
// tensor-core tile of D 80 is five 16-column atoms, of D 96 three of 32
// (hopper_tiles.cuh Tile<D>).
//
// Every kernel zero-fills the tile slots outside the live range (cp.async
// source size 0) and never reads them: keys past pos0, outside the table,
// older than the window of every row of the block, past the chunk's causal
// bound. A wgmma P V over a slot holding NaN would poison its row even at
// p = 0, so the kernels do not rely on the pools' dead slots.

#include <cuda_fp8.h>
#include <limits.h>

#include <type_traits>

#include "hopper_tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;   // every kernel here: 128 threads
constexpr int kSplitRows = 16;          // rows the decode split takes
constexpr int kSplitThreads = 256;      // threads a split block
// keys a split: 128, or 64 for fp32 at D 256 (K and V of 128 keys, 256
// KiB, would pass a block's shared memory); by q's type, whatever the pool
template <typename T, int D>
constexpr int kSplitKeys = std::is_same<T, float>::value && D > 128 ? 64
                                                                     : 128;

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

template <> struct Vec<__half> {
  static constexpr int N = 8;
  __device__ static void load(const __half* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __half22float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  }
};

// quantized pool codes: 16 a load, converted exactly to fp32
template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void load(const int8_t* p, float* out) {
    int4 raw = *reinterpret_cast<const int4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(c[i]);
  }
};
// e4m3 is torch's float8_e4m3fn (finite, no inf); codes are never NaN
template <> struct Vec<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  __device__ static void load(const __nv_fp8_e4m3* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_fp8x2_e4m3* h = reinterpret_cast<const __nv_fp8x2_e4m3*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float2 f = static_cast<float2>(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  }
};

// Two neighbouring elements, converted exactly to fp32.
template <typename T> struct Pair;
template <> struct Pair<float> {
  __device__ static float2 load(const void* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};
template <> struct Pair<__nv_bfloat16> {
  __device__ static float2 load(const void* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};
template <> struct Pair<__half> {
  __device__ static float2 load(const void* p) {
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  }
};
template <> struct Pair<int8_t> {
  __device__ static float2 load(const void* p) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    return make_float2((float)c.x, (float)c.y);
  }
};
template <> struct Pair<__nv_fp8_e4m3> {
  __device__ static float2 load(const void* p) {
    return static_cast<float2>(*reinterpret_cast<const __nv_fp8x2_e4m3*>(p));
  }
};

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

// Division by the block size, by shifts when it is a power of two (the
// integer division of a key's position is the costliest step of locating
// it in the pool).
struct BlockDiv {
  int bs, sh = -1;                      // sh < 0: not a power of two
  __device__ explicit BlockDiv(int b) : bs(b) {
    if ((b & (b - 1)) == 0)
      for (sh = 0; (1 << sh) < b;) ++sh;
  }
  __device__ int div(int x) const { return sh >= 0 ? x >> sh : x / bs; }
  __device__ int mod(int x) const { return sh >= 0 ? x & (bs - 1) : x % bs; }
};

// The pool slot of cached key kp of batch row b: block-table entry clamped
// to [0, nb - 1], times the block size, plus the key's place in its block.
__device__ __forceinline__ long long pool_slot(const int* __restrict__ tables,
                                               int b, int kp, int nb,
                                               const BlockDiv& bd,
                                               int max_blocks) {
  int blk = tables[(long long)b * max_blocks + bd.div(kp)];
  blk = min(max(blk, 0), nb - 1);
  return (long long)blk * bd.bs + bd.mod(kp);
}

// ======================================= CUDA cores, fp32 (rows > 16)
constexpr int kKeyTile = 32;          // keys per tile: one per lane

// Shared-memory tile of kKeyTile keys: K rows padded to D+1 floats so that
// lane j reading key j's channel d hits bank (j + d) % 32 (no conflicts).
template <int D> struct KeyTile {
  float k[kKeyTile * (D + 1)];
  float v[kKeyTile * D];
  long long base[kKeyTile];           // element offset of each key, -1 = none
  float ks[kKeyTile], vs[kKeyTile];   // each key's scales (quantized pools)
};

// Stage keys whose element offsets are in tile.base (set by the caller);
// kScaled multiplies each key's row by its scales in tile.ks/vs.
template <typename P, int D, bool kScaled>
__device__ __forceinline__ void load_tile(KeyTile<D>& tile,
                                          const P* __restrict__ ksrc,
                                          const P* __restrict__ vsrc) {
  constexpr int N = Vec<P>::N;
  constexpr int kChunks = D / N;
  for (int i = threadIdx.x; i < kKeyTile * kChunks; i += kThreads) {
    const int j = i / kChunks, c = i % kChunks;
    const long long base = tile.base[j];
    float kf[N], vf[N];
    if (base >= 0) {
      Vec<P>::load(ksrc + base + c * N, kf);
      Vec<P>::load(vsrc + base + c * N, vf);
      if (kScaled) {
        // one rounded product, as the plain version's codes * scale
        const float sk = tile.ks[j], sv = tile.vs[j];
#pragma unroll
        for (int e = 0; e < N; ++e) { kf[e] *= sk; vf[e] *= sv; }
      }
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
__device__ __forceinline__ void fold_tile(const KeyTile<D>& tile,
                                          const float* __restrict__ q_s,
                                          RowState<D, RPW>& st,
                                          const int* qpos, const int* head,
                                          const bool* live, int kpos0,
                                          int window,
                                          const float* __restrict__ slopes,
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

// T: q/k_new/v_new/out; P: the pools (T, or int8/fp8 codes with scales)
template <typename T, typename P, int D, int RPW>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                       const T* __restrict__ v_new,
                       const P* __restrict__ k_pool,
                       const P* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos0s,
                       const int* __restrict__ tlens,
                       const float* __restrict__ slopes, T* __restrict__ out,
                       int sq, int hq, int hkv, int hs, int nb, int bs,
                       int max_blocks, int window, float scale) {
  constexpr bool kScaled = !std::is_same<P, T>::value;
  constexpr int R = kWarps * RPW;             // (query, head) rows / block
  constexpr int kDpl = RowState<D, RPW>::kDpl;
  // the key tile, then the block's q rows, in dynamic shared memory (at D
  // 256 they pass the 48 KiB a block may declare statically)
  extern __shared__ __align__(16) unsigned char smem_cc[];
  KeyTile<D>& tile = *reinterpret_cast<KeyTile<D>*>(smem_cc);
  float* const q_s = reinterpret_cast<float*>(smem_cc + sizeof(KeyTile<D>));

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
                 ? Num<T>::load(q + (((long long)b * sq + qq) * hq + h) * D +
                                d)
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
      float sk = 0.f, sv = 0.f;
      if (kp < page_hi) {
        const long long slot =
            pool_slot(tables, b, kp, nb, BlockDiv(bs), max_blocks);
        base = (slot * hkv + g) * D;
        if (kScaled) {
          sk = k_scale[slot * hs + g % hs];
          sv = v_scale[slot * hs + g % hs];
        }
      }
      tile.base[threadIdx.x] = base;
      tile.ks[threadIdx.x] = sk;
      tile.vs[threadIdx.x] = sv;
    }
    __syncthreads();
    load_tile<P, D, kScaled>(tile, k_pool, v_pool);
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
    load_tile<T, D, false>(tile, k_new, v_new);
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
      if (d < D) Num<T>::store(dst + d, live[r] ? st.o[r][i] * inv : 0.f);
    }
  }
}

// ======================= tensor cores, bf16/fp16 prefill (rows > 16)
constexpr int kRows = 64;             // rows a warpgroup: wgmma's M
// keys a chunk: the product's N; 32 at D 256, where Q (64 KiB) and three
// stages of 64-key K and V tiles (192 KiB) would pass the 227 KiB limit
template <int D> constexpr int kChunkOf = D > 128 ? 32 : 64;
constexpr int kPrefillWGs = 2;        // warpgroups a block, sharing K/V
constexpr int kPrefillStages = 3;     // chunks of the cp.async ring
// blocks an SM is to hold (launch bounds: 1 lets a thread take 255
// registers, for D 128's larger accumulators and the code conversion of
// quantized pools at D 64; 2 caps the others at 128)
template <typename T, typename P, int D>
constexpr int kPrefillBlocksPerSM =
    D > 64 || (D == 64 && !std::is_same<P, T>::value) ? 1 : 2;

// Eight int8 / e4m3 codes as eight T (16 bytes): each code times `scale`,
// one fp32 product rounded once to T. With kScale false the codes go over
// as they are: int8 and e4m3 codes are exact in bf16 and in fp16.
template <typename T, bool kScale>
__device__ __forceinline__ uint4 codes_to(uint2 raw, const int8_t*,
                                          float scale) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lo = (float)c[2 * i], hi = (float)c[2 * i + 1];
    if (kScale) { lo *= scale; hi *= scale; }
    o[i] = Num<T>::pack(lo, hi);
  }
  return out;
}
template <typename T, bool kScale>
__device__ __forceinline__ uint4 codes_to(uint2 raw, const __nv_fp8_e4m3*,
                                          float scale) {
  const __nv_fp8x2_e4m3* h = reinterpret_cast<const __nv_fp8x2_e4m3*>(&raw);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = static_cast<float2>(h[i]);
    if (kScale) { f.x *= scale; f.y *= scale; }
    o[i] = Num<T>::pack(f.x, f.y);
  }
  return out;
}

// The key stream of one block: chunks [0, nc) hold the cached keys at
// positions [page_lo, page_hi), kChunk a chunk; chunks [nc, n) the fresh
// keys j in [fresh_lo, fresh_hi). Slots past the range are dead.
template <int kChunk> struct Stream {
  int nc, n, page_lo, page_hi, fresh_lo, fresh_hi;
  __device__ int first(int j) const {
    return j < nc ? page_lo + kChunk * j : fresh_lo + kChunk * (j - nc);
  }
  __device__ int live(int j) const {
    return (j < nc ? page_hi : fresh_hi) - first(j);
  }
};

template <typename T, typename P, int D>
__host__ __device__ constexpr uint32_t prefill_smem() {
  // 1024 alignment slack, Q, the stages of K and V; quantized pools: two
  // staging buffers of K and V codes and the stages' scales
  constexpr int kChunk = kChunkOf<D>;
  return 1024 + Tile<D>::bytes(kPrefillWGs * kRows) +
         kPrefillStages * 2 * Tile<D>::bytes(kChunk) +
         (std::is_same<P, T>::value
              ? 0
              : 2 * 2 * kChunk * D + kPrefillStages * 2 * kChunk * 4);
}

template <typename T, typename P, int D>
__global__ void __launch_bounds__(kPrefillWGs * 128,
                                  kPrefillBlocksPerSM<T, P, D>)
paged_prefill_tc_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new,
                        const P* __restrict__ k_pool,
                        const P* __restrict__ v_pool,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ tables,
                        const int* __restrict__ pos0s,
                        const int* __restrict__ tlens,
                        const float* __restrict__ slopes, T* __restrict__ out,
                        int sq, int hq, int hkv, int hs, int nb, int bs,
                        int max_blocks, int window, float sc) {
  constexpr bool kQuant = !std::is_same<P, T>::value;
  constexpr int kChunk = kChunkOf<D>;
  // fp16 with quantized pools: the value scale goes into the V tile (code
  // x scale in fp32, rounded once to fp16), not into P, whose product with
  // a small scale would fall below fp16's normal range
  constexpr bool kVTile = kQuant && std::is_same<T, __half>::value;
  constexpr int kNT = kPrefillWGs * 128;           // threads
  constexpr int kQRows = kPrefillWGs * kRows;      // rows a block
  constexpr int kS = kPrefillStages;
  constexpr uint32_t kQB = Tile<D>::bytes(kQRows);
  constexpr uint32_t kTileB = Tile<D>::bytes(kChunk);
  constexpr int kC = D / 8;              // 16-byte chunks of T a row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (sQ - smem_u32(smem_raw));
  const uint32_t sKV = sQ + kQB;         // stage i: K, then V
  // quantized pools: codes of two chunks (K, then V), scales of the stages
  unsigned char* const raw = smem + kQB + kS * 2 * kTileB;
  float* const scales = reinterpret_cast<float*>(raw + 2 * 2 * kChunk * D);

  const int b = blockIdx.z, g = blockIdx.y;
  const int rep = hq / hkv, rows = sq * rep;
  const int row0 = blockIdx.x * kQRows;
  const int p0 = pos0s[b], tl = tlens[b];
  const int nq = min(sq, tl);            // live queries of the batch row
  const Frag f;
  const int wrow = kRows * f.wg;         // the warpgroup's first row
  // a warpgroup whose rows are all dead (a mixed tick's decode row) only
  // copies and waits at the barriers (where registers allow the branch)
  const bool wg_live = kPrefillBlocksPerSM<T, P, D> == 2 ||
                       row0 + wrow < rep * nq;

  // the block's live queries [q_lo, q_hi]; no live row: zeros, no reads
  const bool any_live = row0 < rep * nq;
  const int q_lo = row0 / rep;
  const int q_hi = (min(row0 + kQRows, rep * nq) - 1) / rep;
  Stream<kChunk> st{0, 0, 0, 0, 0, 0};
  if (any_live) {
    st.page_hi = min(p0, max_blocks * bs);
    st.page_lo = window > 0 ? max(0, p0 + q_lo - window + 1) : 0;
    st.fresh_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
    st.fresh_hi = q_hi + 1;
    st.nc = max(0, (st.page_hi - st.page_lo + kChunk - 1) / kChunk);
    st.n = st.nc + (st.fresh_hi - st.fresh_lo + kChunk - 1) / kChunk;
  }

  // chunk j's copies: cached keys gathered through the block table (codes
  // into a staging buffer when quantized), fresh keys from k_new/v_new;
  // dead slots zero-filled. A thread reads its rows' table entries (Src)
  // one chunk ahead of the copies that use them and does the arithmetic
  // on them only there, so the table's latency stays off the chunk's path.
  constexpr int kCq = D / 16;            // 16-code chunks a row
  constexpr int kItB = (kChunk * kC + kNT - 1) / kNT;
  constexpr int kItQ = (kChunk * kCq + kNT - 1) / kNT;
  constexpr int kIt = kItB > kItQ ? kItB : kItQ;
  struct Src {
    int blk[kIt], slot[kIt];             // entry as read, slot; -1: dead
    int sblk, sslot;                     // the scales of row threadIdx.x
  };
  // the table entry and slot of cached key k0 + r
  const BlockDiv bdiv(bs);
  auto locate = [&](int k0, int r, int& blk, int& slot) {
    blk = tables[(long long)b * max_blocks + bdiv.div(k0 + r)];
    slot = bdiv.mod(k0 + r);
  };
  auto offsets = [&](int j, Src& o) {
    const int k0 = st.first(j), live = st.live(j);
    const bool cached = j < st.nc, codes = kQuant && cached;
    const int per = codes ? kCq : kC;    // units a row
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = threadIdx.x + it * kNT, r = i / per;
      o.blk[it] = 0;
      o.slot[it] = i < kChunk * per && r < live ? r : -1;
      if (cached && o.slot[it] >= 0) locate(k0, r, o.blk[it], o.slot[it]);
    }
    const int r = threadIdx.x;
    o.sblk = 0;
    o.sslot = codes && r < kChunk && r < live ? r : -1;
    if (o.sslot >= 0) locate(k0, r, o.sblk, o.sslot);
  };
  // element offset of unit it's row in its source, -1 for a dead slot
  auto row_at = [&](int j, const Src& o, int it) -> long long {
    if (o.slot[it] < 0) return -1;
    const long long row =
        j < st.nc ? (long long)min(max(o.blk[it], 0), nb - 1) * bs +
                        o.slot[it]
                  : (long long)b * sq + st.first(j) + o.slot[it];
    return (row * hkv + g) * D;
  };
  auto issue = [&](int j, const Src& o) {
    const int st_i = j % kS;
    const uint32_t sK = sKV + st_i * 2 * kTileB, sV = sK + kTileB;
    const bool cached = j < st.nc;
    if constexpr (kQuant) {
      if (cached) {
        unsigned char* const rawj = raw + (j & 1) * 2 * kChunk * D;
#pragma unroll
        for (int it = 0; it < kItQ; ++it) {
          const int i = threadIdx.x + it * kNT;
          if (i >= kChunk * kCq) break;
          const int c = (i % kCq) * 16;
          const long long at = row_at(j, o, it);
          const bool ok = at >= 0;
          const long long src = ok ? at + c : 0;
          const uint32_t dst = smem_u32(rawj + (i / kCq) * D + c);
          cp_async16(dst, k_pool + src, ok ? 16 : 0);
          cp_async16(dst + kChunk * D, v_pool + src, ok ? 16 : 0);
        }
        const int r = threadIdx.x;
        if (r < kChunk) {
          float* sc_st = scales + st_i * 2 * kChunk;
          const bool ok = o.sslot >= 0;
          const long long src =
              ok ? ((long long)min(max(o.sblk, 0), nb - 1) * bs + o.sslot) *
                           hs + g % hs
                 : 0;
          cp_async4(smem_u32(sc_st + r), k_scale + src, ok ? 4 : 0);
          cp_async4(smem_u32(sc_st + kChunk + r), v_scale + src, ok ? 4 : 0);
        }
        return;
      }
    }
    const T* ksrc = k_new;
    const T* vsrc = v_new;
    if constexpr (!kQuant) {
      if (cached) {
        ksrc = k_pool;
        vsrc = v_pool;
      }
    }
#pragma unroll
    for (int it = 0; it < kItB; ++it) {
      const int i = threadIdx.x + it * kNT;
      if (i >= kChunk * kC) break;
      const int r = i / kC, c = (i % kC) * 8;
      const long long at = row_at(j, o, it);
      const bool ok = at >= 0;
      const long long src = ok ? at + c : 0;
      const uint32_t off = Tile<D>::offset(kChunk, r, c);
      cp_async16(sK + off, ksrc + src, ok ? 16 : 0);
      cp_async16(sV + off, vsrc + src, ok ? 16 : 0);
    }
  };

  // this thread's two fragment rows: query position, ALiBi slope
  int qpos[2];
  float slope[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = row0 + wrow + f.ra + 8 * r;
    qpos[r] = p0 + gr / rep;
    if (slopes != nullptr && gr < rows) slope[r] = slopes[g * rep + gr % rep];
  }

  Src nxt;                     // the table entries of the next chunk to issue
  if (st.n > 0) {
#pragma unroll
    for (int i = threadIdx.x; i < kQRows * kC; i += kNT) {
      const int r = i / kC, c = (i % kC) * 8, gr = row0 + r;
      const bool ok = gr < rows && gr / rep < nq;
      const long long at =
          ok ? (((long long)b * sq + gr / rep) * hq + g * rep + gr % rep) *
                       D + c
             : 0;
      cp_async16(sQ + Tile<D>::offset(kQRows, r, c), q + at, ok ? 16 : 0);
    }
    // the ring's first kS - 1 chunks (empty groups past the stream keep the
    // count of groups in flight the same at every step)
#pragma unroll
    for (int j = 0; j < kS - 1; ++j) {
      if (j < st.n) {
        offsets(j, nxt);
        issue(j, nxt);
      }
      cp_commit();
    }
    if (kS - 1 < st.n) offsets(kS - 1, nxt);
  }

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < st.n; ++j) {
    const int st_i = j % kS;
    const uint32_t sK = sKV + st_i * 2 * kTileB, sV = sK + kTileB;
    const bool cached = j < st.nc;
    const float* ks = scales + st_i * 2 * kChunk;
    const float* vs = ks + kChunk;
    cp_wait_sync<kS - 2>();              // chunk j has landed
    if constexpr (kQuant) {
      if (cached) {                      // its codes -> T in the tile
        const unsigned char* rawj = raw + (j & 1) * 2 * kChunk * D;
#pragma unroll
        for (int i = threadIdx.x; i < 2 * kChunk * kC; i += kNT) {
          const int kv = i / (kChunk * kC), r = (i / kC) % kChunk,
                    c = (i % kC) * 8;
          const uint2 codes = *reinterpret_cast<const uint2*>(
              rawj + kv * kChunk * D + r * D + c);
          *reinterpret_cast<uint4*>(smem + (sK - sQ) + kv * kTileB +
                                    Tile<D>::offset(kChunk, r, c)) =
              codes_to<T, kVTile>(codes, k_pool, kv ? vs[r] : 1.f);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
      }
    }
    if (j + kS - 1 < st.n) issue(j + kS - 1, nxt);   // flies meanwhile
    cp_commit();
    if (j + kS < st.n) offsets(j + kS, nxt);
    if (!wg_live) {
      __syncthreads();
      continue;
    }

    float s[kChunk / 2];
    fence_regs(s);
    wg_arrive();
    mma_ss<T, D, kChunk>(s, sQ, kQRows, wrow, sK, kChunk, 0);
    wg_commit();
    wg_wait();
    fence_regs(s);

    // scores: key scale (quantized), 1/sqrt(D), ALiBi; then the mask
    const int kbase = cached ? st.first(j) : p0 + st.first(j);
    const int live = st.live(j);
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) {
      const int col = f.col(i), r = Frag::row(i);
      float v = (kQuant && cached) ? s[i] * ks[col] : s[i];
      v *= sc;
      if (slopes != nullptr) v += slope[r] * (float)(kbase + col - qpos[r]);
      s[i] = v;
    }
    float corr[2];
    if (live < kChunk || !cached || window > 0) {
      uint32_t ok = 0;
#pragma unroll
      for (int i = 0; i < kChunk / 2; ++i) {
        const int col = f.col(i), r = Frag::row(i), kpos = kbase + col;
        ok |= (uint32_t)(col < live && kpos <= qpos[r] &&
                         (window <= 0 || qpos[r] - kpos < window))
              << i;
      }
      softmax_step<true>(s, ok, 1.f, m, l, corr);
    } else {
      softmax_step<false>(s, 0u, 1.f, m, l, corr);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[Frag::row(i)];
    if (kQuant && !kVTile && cached) {   // the value scale, before rounding
#pragma unroll
      for (int i = 0; i < kChunk / 2; ++i) s[i] *= vs[f.col(i)];
    }
    uint32_t pa[kChunk / 16][4];         // P rounded to T
    to_a<T, kChunk>(s, pa);
    fence_regs(acc);
    fence_regs(pa);
    wg_arrive();
    mma_rs<T, D, kChunk>(acc, pa, sV, kChunk);
    wg_commit();
    wg_wait();
    fence_regs(acc);
    fence_regs(pa);
    __syncthreads();                     // the stage is free for reuse
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = row0 + wrow + f.ra + 8 * r;
    if (gr >= rows) continue;
    const int qi = gr / rep;
    const bool live = qi < tl;
    const float inv = live ? 1.f / fmaxf(l[r], 1e-30f) : 0.f;
    T* dst = out + (((long long)b * sq + qi) * hq + g * rep + gr % rep) * D +
             f.cq;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      store2(dst + 8 * jj, live ? acc[4 * jj + 2 * r] * inv : 0.f,
             live ? acc[4 * jj + 2 * r + 1] * inv : 0.f);
  }
}

// =========================== decode: split the context (rows <= 16)
// The workspace of one call: o [B, Hkv, S, rows, D] then (m, l) [B, Hkv, S,
// rows, 2], fp32; part = ((b * hkv + g) * S + s) * rows + r.

// Shared-memory place (in 16-byte units) of unit c of key k in a [keys, C]
// array of 16-byte units: the 128-byte line's units XOR-ed with the key (C
// a multiple of 8: whole lines a key) or with the line (any other C, D 80
// and 96 among them: a key's units may share lines with the next key's),
// so the eight 16-byte reads of a quarter warp land on distinct bank groups.
template <int C>
__device__ __forceinline__ int unit_of(int k, int c) {
  if (C % 8 == 0) return k * C + (c ^ (k & 7));
  const int u = k * C + c, line = u / 8;
  return line * 8 + ((u % 8) ^ (line % 8));
}

template <typename T, typename P, int D, int R>
struct SplitSmem {
  static constexpr int K = kSplitKeys<T, D>;        // keys a split
  static constexpr int kParts = kSplitThreads / K;  // threads a key
  static constexpr int E = Vec<P>::N;               // elements a unit
  static constexpr int C = D / E;                   // units a key
  static constexpr uint32_t kKV = K * D * sizeof(P);
  // K, V, their scales, each key's pool offset, q, p (and the dots of a
  // key's later parts), the reductions
  static constexpr uint32_t bytes =
      2 * kKV + 2 * K * 4 + K * 8 + R * D * 4 + (kParts - 1) * R * K * 4 +
      2 * kWarps * R * 4;
};

template <typename T, typename P, int D, int R>
__global__ void __launch_bounds__(kSplitThreads, 1)
paged_decode_split_kernel(const T* __restrict__ q,
                          const P* __restrict__ k_pool,
                          const P* __restrict__ v_pool,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ tables,
                          const int* __restrict__ pos0s,
                          const int* __restrict__ tlens,
                          const float* __restrict__ slopes,
                          float* __restrict__ ws, int sq, int hq, int hkv,
                          int hs, int nb, int bs, int max_blocks, int window,
                          float sc) {
  constexpr bool kQuant = !std::is_same<P, T>::value;
  using L = SplitSmem<T, P, D, R>;
  constexpr int K = L::K, kParts = L::kParts, E = L::E, C = L::C;
  constexpr int kNT = kSplitThreads;
  constexpr int Cp = (C + kParts - 1) / kParts;     // units a part
  constexpr int kKeyWarps = K / 32;      // warps of the keys' first parts
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const sK = smem;
  unsigned char* const sV = smem + L::kKV;
  float* const ks = reinterpret_cast<float*>(smem + 2 * L::kKV);
  float* const vs = ks + K;
  long long* const base = reinterpret_cast<long long*>(vs + K);
  float* const q_s = reinterpret_cast<float*>(base + K);
  float* const p_s = q_s + R * D;        // p; first the later parts' dots
  float* const red = p_s + (kParts - 1) * R * K;     // [2][kWarps][R]

  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int rep = hq / hkv, rows = sq * rep;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int p0 = pos0s[b], nq = min(sq, tlens[b]);
  const long long part0 = ((long long)(b * hkv + g) * splits + s) * rows;
  float* const o_ws = ws + part0 * D;
  float* const ml_ws =
      ws + (long long)gridDim.z * hkv * splits * rows * D + part0 * 2;

  // the split's live keys [lo, hi): below pos0 and the table's end, not
  // older than the window of the first query
  const int k0 = s * K;
  const int lo = max(k0, window > 0 ? p0 - window + 1 : 0);
  const int hi = nq > 0 ? min(min(p0, max_blocks * bs), k0 + K) : 0;
  if (lo >= hi) {                        // an empty partial
    for (int i = t; i < rows * D; i += kNT) o_ws[i] = 0.f;
    for (int r = t; r < rows; r += kNT) {
      ml_ws[2 * r] = kMasked;
      ml_ws[2 * r + 1] = 0.f;
    }
    return;
  }

  // each key's pool offset and scales (a thread a key) and the q rows in
  // fp32 (rows past true_len as zeros), then every K and V unit in flight
  // (K with the scales in one group, V in a second)
  if (t < K) {
    const int kp = k0 + t;
    const bool ok = kp >= lo && kp < hi;
    const long long slot =
        ok ? pool_slot(tables, b, kp, nb, BlockDiv(bs), max_blocks) : 0;
    base[t] = ok ? (slot * hkv + g) * D : -1;
    if (kQuant) {
      cp_async4(smem_u32(ks + t), k_scale + slot * hs + g % hs, ok ? 4 : 0);
      cp_async4(smem_u32(vs + t), v_scale + slot * hs + g % hs, ok ? 4 : 0);
    }
  }
  for (int i = t; i < rows * D; i += kNT) {
    const int r = i / D, d = i % D, qi = r / rep;
    q_s[i] = qi < nq ? Num<T>::load(q + (((long long)b * sq + qi) * hq +
                                         g * rep + r % rep) * D + d)
                     : 0.f;
  }
  __syncthreads();
  {
    constexpr int kIt = (K * C + kNT - 1) / kNT;
    long long at[kIt];                   // this thread's units: k = i / C
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = t + it * kNT;
      const long long kb = i < K * C ? base[i / C] : -1;
      at[it] = kb >= 0 ? kb + (i % C) * E : -1;
    }
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = t + it * kNT;
      if (i < K * C)
        cp_async16(smem_u32(sK + 16 * unit_of<C>(i / C, i % C)),
                   k_pool + (at[it] >= 0 ? at[it] : 0), at[it] >= 0 ? 16 : 0);
    }
    cp_commit();
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = t + it * kNT;
      if (i < K * C)
        cp_async16(smem_u32(sV + 16 * unit_of<C>(i / C, i % C)),
                   v_pool + (at[it] >= 0 ? at[it] : 0), at[it] >= 0 ? 16 : 0);
    }
    cp_commit();
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();                       // K and the scales are in

  // scores: threads t, t + K, ... own key k0 + t % K, part t / K of its
  // units each; the later parts' dots go through p_s
  const int kk = t % K, part = t / K;
  const int kp = k0 + kk;
  const bool key_ok = kp >= lo && kp < hi;
  float sc_r[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sc_r[r] = 0.f;
  if (key_ok) {
    auto unit = [&](int c) {
      float kf[E];
      Vec<P>::load(reinterpret_cast<const P*>(sK + 16 * unit_of<C>(kk, c)),
                   kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rows) break;
        const float4* qr = reinterpret_cast<const float4*>(q_s + r * D + c * E);
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 qv = qr[e / 4];
          sc_r[r] = fmaf(qv.x, kf[e], sc_r[r]);
          sc_r[r] = fmaf(qv.y, kf[e + 1], sc_r[r]);
          sc_r[r] = fmaf(qv.z, kf[e + 2], sc_r[r]);
          sc_r[r] = fmaf(qv.w, kf[e + 3], sc_r[r]);
        }
      }
    };
    const int c1 = min(C, (part + 1) * Cp);
    if constexpr (R <= 4) {
#pragma unroll 4
      for (int c = part * Cp; c < c1; ++c) unit(c);
    } else {
#pragma unroll 1
      for (int c = part * Cp; c < c1; ++c) unit(c);
    }
  }
  if (part > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      p_s[((part - 1) * R + r) * K + kk] = sc_r[r];
  }
  __syncthreads();
  // the block's max, p and sum over the keys, by the first K threads
  float* const red_l = red + kWarps * R;
  const float kscale = kQuant ? ks[kk] : 1.f;
  if (part == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = r / rep, qpos = p0 + qi;
      const bool ok = key_ok && r < rows && qi < nq &&
                      (window <= 0 || qpos - kp < window);
      float dot = sc_r[r];
#pragma unroll
      for (int j = 1; j < kParts; ++j) dot += p_s[((j - 1) * R + r) * K + kk];
      float v = dot * kscale * sc;
      if (slopes != nullptr && r < rows)
        v += slopes[g * rep + r % rep] * (float)(kp - qpos);
      sc_r[r] = ok ? v : kMasked;
      const float wm = warp_max(sc_r[r]);
      if (lane == 0) red[warp * R + r] = wm;
    }
  }
  __syncthreads();
  if (part == 0) {
    const float vscale = kQuant ? vs[kk] : 1.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float m_r = red[r];
#pragma unroll
      for (int w = 1; w < kKeyWarps; ++w) m_r = fmaxf(m_r, red[w * R + r]);
      const float p = sc_r[r] == kMasked ? 0.f : expf(sc_r[r] - m_r);
      p_s[r * K + kk] = p * vscale;
      const float sum = warp_sum(p);
      if (lane == 0) red_l[warp * R + r] = sum;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();                       // V and every p are in
  if (t < rows) {
    float m_r = red[t], l_r = red_l[t];
#pragma unroll
    for (int w = 1; w < kKeyWarps; ++w) {
      m_r = fmaxf(m_r, red[w * R + t]);
      l_r += red_l[w * R + t];
    }
    ml_ws[2 * t] = m_r;
    ml_ws[2 * t + 1] = l_r;
  }

  // o[r] = sum_k p[r, k] v[k]: a thread owns two channels of a row and
  // walks the live keys (a warp reads 64 channels of one key: no bank
  // conflicts, p broadcast); rows x D / 2 pairs over the block's threads
  const int klo = lo - k0, khi = hi - k0;
  for (int i = t; i < rows * (D / 2); i += kNT) {
    const int r = i / (D / 2), e0 = 2 * (i % (D / 2));
    const unsigned char* col = sV + (e0 % E) * sizeof(P);
    const float* pr = p_s + r * K;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int k = klo; k < khi; ++k) {
      const float2 v =
          Pair<P>::load(col + 16 * unit_of<C>(k, e0 / E));
      a0 = fmaf(pr[k], v.x, a0);
      a1 = fmaf(pr[k], v.y, a1);
    }
    *reinterpret_cast<float2*>(o_ws + r * D + e0) = make_float2(a0, a1);
  }
}

// One block per (kv head, batch row): warp w folds rows w, w + 4, ...: the
// partials of every split in split order (each scaled to the largest m of
// the row's non-empty partials), then the fresh keys j <= its query (j >
// query - window), then writes o / l, or zeros past true_len. Lane i owns
// channels [kCL i, kCL i + kCL), kCL = 4 (D 256: 8; D under 128: lanes past
// D / 4 repeat a lane's channels, add nothing to the dot products and
// store nothing).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(const T* __restrict__ q,
                            const T* __restrict__ k_new,
                            const T* __restrict__ v_new,
                            const float* __restrict__ ws,
                            const int* __restrict__ tlens,
                            const float* __restrict__ slopes,
                            T* __restrict__ out, int sq, int hq, int hkv,
                            int splits, int window, float sc) {
  constexpr int kCL = D > 128 ? D / 32 : 4;     // channels a lane
  const int g = blockIdx.x, b = blockIdx.y;
  const int rep = hq / hkv, rows = sq * rep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = (kCL * lane) % D;
  const bool mine = kCL * lane < D;      // this lane's channels
  const int nq = min(sq, tlens[b]);
  const long long part0 = (long long)(b * hkv + g) * splits * rows;
  const float* const ml_ws =
      ws + (long long)gridDim.y * hkv * splits * rows * D;
  for (int r = warp; r < rows; r += kWarps) {
    const int qi = r / rep, h = g * rep + r % rep;
    T* dst = out + (((long long)b * sq + qi) * hq + h) * D + c;
    float o[kCL];
#pragma unroll
    for (int e = 0; e < kCL; ++e) o[e] = 0.f;
    if (qi >= nq) {
      if (mine)
#pragma unroll
        for (int e = 0; e < kCL; ++e) Num<T>::store(dst + e, 0.f);
      continue;
    }
    float m = kMasked;
    for (int s = lane; s < splits; s += 32) {
      const float2 ml = *reinterpret_cast<const float2*>(
          ml_ws + 2 * (part0 + (long long)s * rows + r));
      if (ml.y > 0.f) m = fmaxf(m, ml.x);
    }
    m = warp_max(m);
    float l = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const long long part = part0 + (long long)s * rows + r;
      const float2 ml =
          *reinterpret_cast<const float2*>(ml_ws + 2 * part);
      const float w = ml.y > 0.f ? expf(ml.x - m) : 0.f;
      l += ml.y * w;
#pragma unroll
      for (int e = 0; e < kCL; e += 4) {
        const float4 os =
            *reinterpret_cast<const float4*>(ws + part * D + c + e);
        o[e] += w * os.x; o[e + 1] += w * os.y; o[e + 2] += w * os.z;
        o[e + 3] += w * os.w;
      }
    }
    // the fresh keys, one at a time
    float qv[kCL];
    const long long qrow = (((long long)b * sq + qi) * hq + h) * D + c;
#pragma unroll
    for (int e = 0; e < kCL; ++e) qv[e] = Num<T>::load(q + qrow + e);
    const float slope = slopes != nullptr ? slopes[h] : 0.f;
    for (int j = window > 0 ? max(0, qi - window + 1) : 0; j <= qi; ++j) {
      const long long kv = (((long long)b * sq + j) * hkv + g) * D + c;
      float dot = 0.f, vv[kCL];
#pragma unroll
      for (int e = 0; e < kCL; ++e) {
        dot = fmaf(qv[e], Num<T>::load(k_new + kv + e), dot);
        vv[e] = Num<T>::load(v_new + kv + e);
      }
      const float sj =
          warp_sum(mine ? dot : 0.f) * sc + slope * (float)(j - qi);
      const float m_new = fmaxf(m, sj);
      const float corr = expf(m - m_new), p = expf(sj - m_new);
      l = l * corr + p;
#pragma unroll
      for (int e = 0; e < kCL; ++e) o[e] = o[e] * corr + p * vv[e];
      m = m_new;
    }
    // l >= 1 (the row's own key): the fast reciprocal is exact to 1 ulp
    const float inv = __fdividef(1.f, l);
    if (mine)
#pragma unroll
      for (int e = 0; e < kCL; ++e) Num<T>::store(dst + e, o[e] * inv);
  }
}

// ================================================================ launch
// Every argument of one call, passed down the dispatch chain.
struct Args {
  const void *q, *k_new, *v_new, *k_pool, *v_pool, *k_scale, *v_scale;
  const void *tables, *pos0, *true_len, *slopes;
  void *out, *ws;
  int b, sq, hq, hkv, hs, nb, bs, max_blocks, window, splits;
  cudaStream_t stream;
};

#define DS_PTRS(T, P)                                                      \
  static_cast<const P*>(a.k_pool), static_cast<const P*>(a.v_pool),        \
      static_cast<const float*>(a.k_scale),                                \
      static_cast<const float*>(a.v_scale),                                \
      static_cast<const int*>(a.tables), static_cast<const int*>(a.pos0),  \
      static_cast<const int*>(a.true_len),                                 \
      static_cast<const float*>(a.slopes)

// the CUDA-core kernel's rows a block, and its dynamic shared memory
constexpr int kCoreRows = kWarps * 4;
template <int D>
constexpr uint32_t core_smem() {
  return sizeof(KeyTile<D>) + kCoreRows * D * 4;
}

template <typename T, typename P, int D>
cudaError_t launch_cuda_cores(const Args& a) {
  constexpr int R = kCoreRows;
  const long long zt = ((long long)a.sq * (a.hq / a.hkv) + R - 1) / R;
  if (zt > 65535 || a.hkv > 65535) return cudaErrorInvalidConfiguration;
  constexpr uint32_t smem = core_smem<D>();
  cudaError_t e = allow_smem(paged_attention_kernel<T, P, D, 4>, smem);
  if (e != cudaSuccess) return e;
  paged_attention_kernel<T, P, D, 4>
      <<<dim3(a.b, a.hkv, (unsigned)zt), kThreads, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k_new),
          static_cast<const T*>(a.v_new), DS_PTRS(T, P),
          static_cast<T*>(a.out), a.sq, a.hq, a.hkv, a.hs, a.nb, a.bs,
          a.max_blocks, a.window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, typename P, int D>
cudaError_t launch_prefill_tc(const Args& a) {
  constexpr int kQRows = kPrefillWGs * kRows;
  const long long zt = ((long long)a.sq * (a.hq / a.hkv) + kQRows - 1) /
                       kQRows;
  if (zt > INT_MAX || a.hkv > 65535 || a.b > 65535)
    return cudaErrorInvalidConfiguration;
  constexpr uint32_t smem = prefill_smem<T, P, D>();
  cudaError_t e = allow_smem(paged_prefill_tc_kernel<T, P, D>, smem);
  if (e != cudaSuccess) return e;
  paged_prefill_tc_kernel<T, P, D>
      <<<dim3((unsigned)zt, a.hkv, a.b), kPrefillWGs * 128, smem,
         a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k_new),
          static_cast<const T*>(a.v_new), DS_PTRS(T, P),
          static_cast<T*>(a.out), a.sq, a.hq, a.hkv, a.hs, a.nb, a.bs,
          a.max_blocks, a.window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, typename P, int D, int R>
cudaError_t launch_split(const Args& a) {
  if (a.hkv > 65535 || a.b > 65535) return cudaErrorInvalidConfiguration;
  constexpr uint32_t smem = SplitSmem<T, P, D, R>::bytes;
  const float sc = 1.0f / sqrtf((float)D);
  cudaError_t e = allow_smem(paged_decode_split_kernel<T, P, D, R>, smem);
  if (e != cudaSuccess) return e;
  paged_decode_split_kernel<T, P, D, R>
      <<<dim3(a.splits, a.hkv, a.b), kSplitThreads, smem, a.stream>>>(
          static_cast<const T*>(a.q), DS_PTRS(T, P), static_cast<float*>(a.ws),
          a.sq, a.hq, a.hkv, a.hs, a.nb, a.bs, a.max_blocks, a.window, sc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_decode_combine_kernel<T, D><<<dim3(a.hkv, a.b), kThreads, 0,
                                      a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_new),
      static_cast<const T*>(a.v_new), static_cast<const float*>(a.ws),
      static_cast<const int*>(a.true_len), static_cast<const float*>(a.slopes),
      static_cast<T*>(a.out), a.sq, a.hq, a.hkv, a.splits, a.window, sc);
  return cudaGetLastError();
}

#undef DS_PTRS

bool dim_ok(int d) {
  return d == 16 || d == 32 || d == 64 || d == 80 || d == 96 || d == 128 ||
         d == 256;
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16
bool dtype_ok(int dtype) { return dtype >= 0 && dtype <= 2; }

// variant: 0 cuda_cores (fp32), 1 prefill_wgmma (bf16, fp16), 2
// decode_split
int variant_of(int dtype, int d, long long rows) {
  if (!dim_ok(d) || !dtype_ok(dtype) || rows <= 0) return -1;
  if (rows <= kSplitRows) return 2;
  return dtype == 0 ? 0 : 1;
}

template <typename T, typename P, int D>
cudaError_t dispatch_variant(int variant, const Args& a) {
  const int rows = a.sq * (a.hq / a.hkv);
  if (variant == 2)
    return rows <= 4 ? launch_split<T, P, D, 4>(a)
                     : launch_split<T, P, D, kSplitRows>(a);
  if constexpr (std::is_same<T, float>::value) {
    if (variant == 0) return launch_cuda_cores<T, P, D>(a);
  } else {
    if (variant == 1) return launch_prefill_tc<T, P, D>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename P>
cudaError_t dispatch_dim(int variant, int d, const Args& a) {
  switch (d) {
    case 16: return dispatch_variant<T, P, 16>(variant, a);
    case 32: return dispatch_variant<T, P, 32>(variant, a);
    case 64: return dispatch_variant<T, P, 64>(variant, a);
    case 80: return dispatch_variant<T, P, 80>(variant, a);
    case 96: return dispatch_variant<T, P, 96>(variant, a);
    case 128: return dispatch_variant<T, P, 128>(variant, a);
    case 256: return dispatch_variant<T, P, 256>(variant, a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_pool(int variant, int pool, int d, const Args& a) {
  switch (pool) {
    case 0: return dispatch_dim<T, T>(variant, d, a);
    case 1: return dispatch_dim<T, int8_t>(variant, d, a);
    case 2: return dispatch_dim<T, __nv_fp8_e4m3>(variant, d, a);
    default: return cudaErrorInvalidValue;
  }
}

// the decode split's keys a split (kSplitKeys) by dtype code and head dim
int split_keys(int dtype, int d) { return dtype == 0 && d > 128 ? 64 : 128; }

long long split_count(int dtype, int d, int max_blocks, int bs) {
  const int k = split_keys(dtype, d);
  return ((long long)max_blocks * bs + k - 1) / k;
}

}  // namespace

// Which kernel a call takes, from its shapes alone: 0 = "cuda_cores" (fp32
// prefill), 1 = "prefill_wgmma" (bf16 and fp16 prefill), 2 = "decode_split"
// (rows = sq * hq / hkv <= 16, any dtype), -1 = none. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16.
extern "C" int ds_paged_attention_variant(int dtype, int d, int sq, int hq,
                                          int hkv) {
  if (sq <= 0 || hkv <= 0 || hq % hkv != 0) return -1;
  return variant_of(dtype, d, (long long)sq * (hq / hkv));
}

// The decode split's keys a split for a dtype and head dim: 128, or 64
// for fp32 at D 256; -1 where no kernel takes them.
extern "C" int ds_paged_attention_split_keys(int dtype, int d) {
  return dim_ok(d) && dtype_ok(dtype) ? split_keys(dtype, d) : -1;
}

// The decode split's number of splits: the table's keys over the keys a
// split.
extern "C" long long ds_paged_attention_splits(int dtype, int d,
                                               int max_blocks, int bs) {
  return split_count(dtype, d, max_blocks, bs);
}

// Dynamic shared memory (bytes) of one block of kernel `which` (1 the
// tensor-core prefill, 2 the decode split at 16 rows, 0 the CUDA-core
// kernel) for a dtype, pool code and head dim; -1 where no kernel is
// compiled for them.
extern "C" long long ds_paged_attention_smem(int which, int dtype, int pool,
                                             int d) {
  if (!dim_ok(d) || pool < 0 || pool > 2 || !dtype_ok(dtype)) return -1;
  if (which == 0) {
    if (dtype != 0) return -1;
    switch (d) {
      case 16: return core_smem<16>();
      case 32: return core_smem<32>();
      case 64: return core_smem<64>();
      case 80: return core_smem<80>();
      case 96: return core_smem<96>();
      case 128: return core_smem<128>();
      default: return core_smem<256>();
    }
  }
#define DS_SMEM(T, P, D)                                                   \
  if (d == D)                                                              \
    return which == 1 ? (!std::is_same<T, float>::value                    \
                             ? (long long)prefill_smem<T, P, D>()          \
                             : -1)                                         \
                      : (long long)SplitSmem<T, P, D, kSplitRows>::bytes;
#define DS_SMEM_D(T, P)                                     \
  DS_SMEM(T, P, 16) DS_SMEM(T, P, 32) DS_SMEM(T, P, 64) \
  DS_SMEM(T, P, 80) DS_SMEM(T, P, 96) DS_SMEM(T, P, 128)  \
  DS_SMEM(T, P, 256)
#define DS_SMEM_P(T)                                  \
  if (pool == 0) { DS_SMEM_D(T, T) }                  \
  if (pool == 1) { DS_SMEM_D(T, int8_t) }             \
  if (pool == 2) { DS_SMEM_D(T, __nv_fp8_e4m3) }
  if (which != 1 && which != 2) return -1;
  if (dtype == 2) { DS_SMEM_P(__half) }
  if (dtype == 1) { DS_SMEM_P(__nv_bfloat16) }
  if (dtype == 0) { DS_SMEM_P(float) }
#undef DS_SMEM_P
#undef DS_SMEM_D
#undef DS_SMEM
  return -1;
}

// C entry point, bound with ctypes. dtype (q, k_new, v_new, out): 0 =
// float32, 1 = bfloat16, 2 = float16. pool: 0 = the pools are of dtype
// and k_scale, v_scale are null; 1 = int8, 2 = float8 e4m3 codes with f32
// scales [nb, bs, hs], hs = hkv or 1. slopes may be null (no ALiBi);
// window <= 0 means no sliding window. The decode split
// (ds_paged_attention_variant 2) takes splits =
// ds_paged_attention_splits(dtype, d, max_blocks, bs) and an fp32
// workspace of b *
// hkv * splits * sq * (hq / hkv) * (d + 2) values; other variants take
// splits 0 and a null workspace. Tensors contiguous, the
// pools, k_new, v_new and the scales 16-byte aligned. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int ds_paged_attention(const void* q, const void* k_new,
                                  const void* v_new, const void* k_pool,
                                  const void* v_pool, const void* k_scale,
                                  const void* v_scale, const void* tables,
                                  const void* pos0, const void* true_len,
                                  const void* slopes, void* out,
                                  void* workspace, int dtype, int pool, int b,
                                  int sq, int hq, int hkv, int d, int nb,
                                  int bs, int hs, int max_blocks, int window,
                                  int splits, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || nb <= 0 || bs <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const bool scaled = k_scale != nullptr && v_scale != nullptr;
  if ((pool != 0) != scaled || (scaled && hs != hkv && hs != 1) ||
      (pool == 0 && (k_scale != nullptr || v_scale != nullptr)))
    return (int)cudaErrorInvalidValue;
  const int variant = ds_paged_attention_variant(dtype, d, sq, hq, hkv);
  if (variant < 0 ||
      (variant == 2) != (workspace != nullptr) ||
      splits != (variant == 2 ? split_count(dtype, d, max_blocks, bs) : 0) ||
      !aligned16(k_new) || !aligned16(v_new) || !aligned16(k_pool) ||
      !aligned16(v_pool) || (scaled && (!aligned16(k_scale) ||
                                        !aligned16(v_scale))))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, tables,
               pos0, true_len, slopes, out, workspace, b, sq, hq, hkv, hs,
               nb, bs, max_blocks, window, splits,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_pool<float>(variant, pool, d, a);
  else if (dtype == 1)
    err = dispatch_pool<__nv_bfloat16>(variant, pool, d, a);
  else
    err = dispatch_pool<__half>(variant, pool, d, a);
  return (int)err;
}

// Message of a code returned by ds_paged_attention.
extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
