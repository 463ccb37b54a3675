// Flash attention, forward and backward, for Hopper.
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
// Two kernel sets, chosen by dtype in the C entry points below (a table, see
// ds_flash_attention_variant; never a retry): bf16 and fp16 take the
// tensor-core kernels ("wgmma"), fp32 the CUDA-core kernels ("cuda_cores"),
// whose products stay exact fp32 FMAs (a TF32 tensor-core product keeps ~3
// decimal digits, too few for the fp32 training path's parity bounds).
//
// What bounds them on an H100: at GPT-2 125M's shapes (B 24, S 1024, 12 heads
// of 64, causal, bf16) the forward moves 152 MB and does 38.7 GFLOP: 0.0454 ms
// by bytes against 0.039 ms by operations at 989 TFLOP/s; the backward's five
// products, 96.7 GFLOP, give 0.0978 ms by operations. Both are near the
// ridge, so the products must run on the tensor cores and the tiles must
// reach shared memory without stalling them.
//
// Tensor-core design (bf16/fp16):
//   * tiles are [rows, D] in shared memory in wgmma's canonical swizzled
//     layout (Tile<D>): column atoms of W elements, W the widest of 64, 32
//     and 16 that divides D (D 80: five atoms of 16, D 96: three of 32,
//     the others min(D, 64)), each row 2W bytes, the 16-byte chunks of a
//     row XOR-ed with the row's place in its 8-row group (the 128/64/32-
//     byte swizzle for W = 64/32/16). The same
//     bytes serve as a K-major operand (rows are M or N, D is K: q, k, do,
//     v in S = q k^T and dp = do v^T) and an MN-major one (rows are K, D is
//     N: v in o += p v, k in dq += ds k, q and do in dk/dv), whose
//     products run one wgmma of N = W a column atom;
//   * the tiles arrive by 16-byte cp.async with zero-fill past S (ragged
//     tiles read as zeros), through a 2-stage ring: the next tile's copies
//     are in flight while the current one is multiplied;
//   * products are wgmma.mma_async m64nNk16 with fp32 accumulators, a
//     warpgroup (128 threads) owning 64 rows. Scores come back in the
//     accumulator fragment; the softmax (or p and ds in the backward) works
//     on it in registers, rounds to the input dtype and feeds the second
//     product as its register A operand, so p and ds never touch shared
//     memory;
//   * forward: one block of two warpgroups per (b*Hq, 128-row q tile),
//     longest causal tiles first, walking 64-key tiles from the window's
//     first live tile to the diagonal. A warpgroup skips a tile none of its
//     rows sees (skipping changes no bit: the rescale would be by 1) and
//     evaluates the mask only on boundary tiles;
//   * backward: two launches and no atomics, so a recompute gives the same
//     bits (the remat policies rely on it). The dq kernel, one block per
//     (b*Hq, 128-row q tile), first writes delta for its rows, then forms
//     s = q k^T and dp = do v^T, ds, dq += ds k. The dk/dv kernel, one block
//     per (b*Hkv, 128-key tile), walks the GQA group's q heads and their q
//     tiles: s^T = k q^T and dp^T = v do^T land p^T and ds^T in the
//     accumulator layout, the A operands of dv += p^T do and dk += ds^T q.
//   * D 256 (GPT-J's heads) would not fit as above: the dq pass's Q and dO
//     (2 x 64 KiB) and four 64-key K/V stages pass the 227 KiB a block may
//     hold, and a warpgroup's dk and dv accumulators over 64 keys would
//     be 256 fp32 registers a thread. So the dq pass streams 32-key
//     stages (kDqKeys, 194 KiB), and the dk/dv pass takes 64 keys a
//     block whose two warpgroups each own half of D's columns of dk and
//     dv (kSplitCols: 128 accumulator registers a thread); each
//     warpgroup forms the same s^T and dp^T over the whole of D, so that
//     pass does 1.5x the products of the D <= 128 design. The forward
//     keeps 64-key stages (193 KiB).
// The blocks index (b, h) in blockIdx.x together with the tile, so any batch
// x heads is taken.
// Next: warp specialisation (a producer warp issuing TMA copies, consumer
// warpgroups with setmaxnreg), the ping-pong of two consumer warpgroups so
// one's softmax hides under the other's products, a persistent grid.
//
// CUDA-core design (fp32): [64, D] query tiles and [KN, D] key tiles staged
// as fp32 in shared memory (row stride D+1), KN = 64 (32 at D 256, so four
// tiles of 257 floats a row fit the block's shared memory), 256 threads as
// a 16 x 16 grid each owning a 4 x KN/16 block of scores and 4 rows x D/16
// channels of every accumulator; the same two-launch backward, whose dk/dv
// pass walks q rows KN at a time.

#include <limits.h>

#include "hopper_tiles.cuh"

namespace {

constexpr int kThreads = 256;          // a 16 x 16 grid of threads
constexpr int kTile = 64;              // query rows a tile (dk/dv: keys)
// keys a tile (forward, dq) and q rows a step (dk/dv) of the CUDA-core
// kernels: at D 256 four [64, 257] fp32 tiles would pass the 227 KiB a
// block may hold
template <int D> constexpr int kCoreKeys = D > 128 ? 32 : 64;

__device__ __forceinline__ bool visible(int qi, int kj, int S, int causal,
                                        int window) {
  return qi < S && kj < S && (!causal || kj <= qi) &&
         (window <= 0 || qi - kj < window);
}

// Rows [r0, r0 + R) of head h of a [B, S, H, D] tensor into dst[R][D+1] as
// fp32; rows past S are zeros.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const T* __restrict__ src, int b,
                                          int h, int H, int S, int r0) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
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

// Key tiles [lo, hi) the query rows [q0, q0 + rows) must visit; lo is a
// multiple of the key tile kn.
__device__ __forceinline__ void key_range(int q0, int rows, int kn, int S,
                                          int causal, int window, int& lo,
                                          int& hi) {
  const int q_last = min(q0 + rows, S) - 1;
  hi = causal ? q_last + 1 : S;
  lo = window > 0 ? max(0, q0 - window + 1) / kn * kn : 0;
}

// ------------------------------------------------------- fp32: forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int Hq, int Hkv, int causal,
                 int window, float sc, int n_bh, int tiles) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  constexpr int KN = kCoreKeys<D>, KJ = KN / 16, KP = KN + 1;
  extern __shared__ float smem[];
  float* qs = smem;                    // [64][D+1]
  float* ks = qs + kTile * LD;         // [KN][D+1]
  float* vs = ks + KN * LD;            // [KN][D+1]
  float* ps = vs + KN * LD;            // [64][KN+1] p, rounded to T

  const int bh = blockIdx.x % n_bh, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  // causal: the last q tiles have the most keys, so they start first
  const int q0 = (tiles - 1 - (int)(blockIdx.x / n_bh)) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<T, D, kTile>(qs, q, b, h, Hq, S, q0);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  key_range(q0, kTile, KN, S, causal, window, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += KN) {
    __syncthreads();                   // the previous tile is consumed
    load_rows<T, D, KN>(ks, k, b, hk, Hkv, S, k0);
    load_rows<T, D, KN>(vs, v, b, hk, Hkv, S, k0);
    __syncthreads();
    float s[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
    mm_nt<D, KJ>(s, qs, LD, ks, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float tmax = kMasked;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const bool ok = visible(qi, k0 + tx + 16 * j, S, causal, window);
        s[i][j] = ok ? s[i][j] * sc : kMasked;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const bool ok = visible(qi, k0 + tx + 16 * j, S, causal, window);
        const float p = ok ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        ps[(ty + 16 * i) * KP + tx + 16 * j] = Num<T>::round(p);
      }
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    mm_nn<KN, NJ>(acc, ps, KP, vs, LD, ty, tx);
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

// ------------------------------------------------------ fp32 backward: dq
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int S,
                    int Hq, int Hkv, int causal, int window, float sc,
                    int n_bh, int tiles) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  constexpr int KN = kCoreKeys<D>, KJ = KN / 16, KP = KN + 1;
  extern __shared__ float smem[];
  float* qs = smem;                    // [64][D+1]
  float* dos = qs + kTile * LD;        // [64][D+1]
  float* ks = dos + kTile * LD;        // [KN][D+1]
  float* vs = ks + KN * LD;            // [KN][D+1]
  float* dss = vs + KN * LD;           // [64][KN+1] ds, rounded to T
  float* lse_s = dss + kTile * KP;     // [64]
  float* delta_s = lse_s + kTile;      // [64]

  const int bh = blockIdx.x % n_bh, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (tiles - 1 - (int)(blockIdx.x / n_bh)) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<T, D, kTile>(qs, q, b, h, Hq, S, q0);
  load_rows<T, D, kTile>(dos, dout, b, h, Hq, S, q0);
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
  key_range(q0, kTile, KN, S, causal, window, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += KN) {
    __syncthreads();
    load_rows<T, D, KN>(ks, k, b, hk, Hkv, S, k0);
    load_rows<T, D, KN>(vs, v, b, hk, Hkv, S, k0);
    __syncthreads();
    float s[4][KJ], dp[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_nt<D, KJ>(s, qs, LD, ks, LD, ty, tx);
    mm_nt<D, KJ>(dp, dos, LD, vs, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const bool ok = visible(q0 + r, k0 + tx + 16 * j, S, causal, window);
        const float p = ok ? Num<T>::round(expf(s[i][j] * sc - lse_s[r])) : 0.f;
        dss[r * KP + tx + 16 * j] = Num<T>::round(p * (dp[i][j] - delta_s[r]));
      }
    }
    __syncthreads();
    mm_nn<KN, NJ>(acc, dss, KP, ks, LD, ty, tx);
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

// --------------------------------------------------- fp32 backward: dk, dv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Hq, int Hkv, int causal,
                     int window, float sc, int n_bhk) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  constexpr int QN = kCoreKeys<D>, QJ = QN / 16, QP = QN + 1;
  extern __shared__ float smem[];
  float* ks = smem;                    // [64][D+1]
  float* vs = ks + kTile * LD;         // [64][D+1]
  float* qs = vs + kTile * LD;         // [QN][D+1]
  float* dos = qs + QN * LD;           // [QN][D+1]
  float* ps = dos + QN * LD;           // [64 keys][QN+1] p^T, rounded to T
  float* dss = ps + kTile * QP;        // [64 keys][QN+1] ds^T, rounded to T
  float* lse_s = dss + kTile * QP;     // [QN]
  float* delta_s = lse_s + QN;         // [QN]

  const int bhk = blockIdx.x % n_bhk, b = bhk / Hkv, g = bhk % Hkv;
  const int rep = Hq / Hkv;
  // causal: low kv tiles have most rows
  const int k0 = (int)(blockIdx.x / n_bhk) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<T, D, kTile>(ks, k, b, g, Hkv, S, k0);
  load_rows<T, D, kTile>(vs, v, b, g, Hkv, S, k0);

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
    for (int q0 = q_lo; q0 < q_hi; q0 += QN) {
      __syncthreads();
      load_rows<T, D, QN>(qs, q, b, h, Hq, S, q0);
      load_rows<T, D, QN>(dos, dout, b, h, Hq, S, q0);
      if (threadIdx.x < QN) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < S ? lse[(long long)bh * S + qi] : 0.f;
        delta_s[threadIdx.x] = qi < S ? delta[(long long)bh * S + qi] : 0.f;
      }
      __syncthreads();
      float st[4][QJ], dpt[4][QJ];     // [key i][row j]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) st[i][j] = dpt[i][j] = 0.f;
      mm_nt<D, QJ>(st, ks, LD, qs, LD, ty, tx);
      mm_nt<D, QJ>(dpt, vs, LD, dos, LD, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          const int r = tx + 16 * j;
          const bool ok = visible(q0 + r, k0 + key, S, causal, window);
          const float p =
              ok ? Num<T>::round(expf(st[i][j] * sc - lse_s[r])) : 0.f;
          ps[key * QP + r] = p;
          dss[key * QP + r] = Num<T>::round(p * (dpt[i][j] - delta_s[r]));
        }
      }
      __syncthreads();
      mm_nn<QN, NJ>(dv_acc, ps, QP, dos, LD, ty, tx);
      mm_nn<QN, NJ>(dk_acc, dss, QP, qs, LD, ty, tx);
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

// ================ tensor cores (building blocks in hopper_tiles.cuh)
// Rows [r0, r0 + R) of head h of a [B, S, H, D] tensor into a Tile<D> at
// dst; rows past S read as zeros.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const T* __restrict__ src, int b,
                                          int h, int H, int S, int r0) {
  constexpr int kChunks = D / 8;       // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8, s = r0 + r;
    const bool ok = s < S;
    cp_async16(dst + Tile<D>::offset(R, r, c),
               src + (((long long)b * S + (ok ? s : 0)) * H + h) * D + c,
               ok ? 16 : 0);
  }
}

// n fp32 values row[r0 .. r0 + n) into shared memory at dst (zeros past S).
__device__ __forceinline__ void load_vec(uint32_t dst,
                                         const float* __restrict__ row,
                                         int r0, int S, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool ok = r0 + i < S;
    cp_async4(dst + 4 * i, row + (ok ? r0 + i : 0), ok ? 4 : 0);
  }
}

constexpr int kBM = 128;               // query rows a block (2 warpgroups)
constexpr int kBQ = 32;                // q rows a dk/dv step
constexpr int kBN = 64;                // keys a K/V stage of the forward
// keys a K/V stage of the dq pass (its Q and dO tiles leave room for
// 32-key stages only at D 256)
template <int D> constexpr int kDqKeys = D > 128 ? 32 : 64;
// dk/dv: at D 256 a block's two warpgroups share its 64 keys, each owning
// half of D's columns; below, each owns 64 of the block's 128 keys and
// every column
template <int D> constexpr bool kSplitCols = D > 128;
template <int D> constexpr int kDkvKeys = kSplitCols<D> ? 64 : 128;
// blocks of each tensor-core kernel an SM is to hold (launch bounds: 2 caps
// a thread at 128 registers, so two blocks' four warpgroups share the SM)
template <int D> constexpr int kBlocksPerSM = D > 64 ? 1 : 2;

// Bit i set where accumulator element i (row `rows[Frag::row(i)]`, column
// col0 + f.col(i)) is a visible (query, key) pair; rows are queries, or
// keys when kKeyRows.
template <int NE, bool kKeyRows>
__device__ __forceinline__ uint32_t mask_bits(const Frag& f,
                                              const int (&rows)[2], int col0,
                                              int S, int causal, int window) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    const int a = rows[Frag::row(i)], c = col0 + f.col(i);
    bits |= (uint32_t)(kKeyRows ? visible(c, a, S, causal, window)
                                : visible(a, c, S, causal, window))
            << i;
  }
  return bits;
}

// ------------------------------------------------ tensor cores: forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<D>)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int S, int Hq, int Hkv,
                    int causal, int window, float sc, int n_bh, int tiles) {
  using L = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + L::bytes(kBM);   // stage i: K, then V
  constexpr uint32_t kStage = 2 * L::bytes(kBN);

  const int bh = blockIdx.x % n_bh, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (tiles - 1 - (int)(blockIdx.x / n_bh)) * kBM;
  const Frag f;
  const int qw0 = q0 + 64 * f.wg, qw_last = min(qw0 + 63, S - 1);
  const int qrow[2] = {qw0 + f.ra, qw0 + f.ra + 8};

  int lo, hi;
  key_range(q0, kBM, kBN, S, causal, window, lo, hi);
  const int n = hi > lo ? (hi - lo + kBN - 1) / kBN : 0;

  load_tile<T, D, kBM>(sQ, q, b, h, Hq, S, q0);
  if (n > 0) {
    load_tile<T, D, kBN>(sKV, k, b, hk, Hkv, S, lo);
    load_tile<T, D, kBN>(sKV + L::bytes(kBN), v, b, hk, Hkv, S, lo);
  }
  cp_commit();

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n; ++j) {
    const int k0 = lo + j * kBN;
    const uint32_t sK = sKV + (j & 1) * kStage, sV = sK + L::bytes(kBN);
    if (j + 1 < n) {
      const uint32_t nK = sKV + ((j + 1) & 1) * kStage;
      load_tile<T, D, kBN>(nK, k, b, hk, Hkv, S, k0 + kBN);
      load_tile<T, D, kBN>(nK + L::bytes(kBN), v, b, hk, Hkv, S, k0 + kBN);
      cp_commit();
      cp_wait_sync<1>();
    } else {
      cp_wait_sync<0>();
    }
    // warpgroup-uniform: does any row of this warpgroup see a key here?
    const bool live = qw0 < S && (!causal || k0 <= qw_last) &&
                      (window <= 0 || k0 + kBN - 1 > qw0 - window);
    if (live) {
      const bool edge = (causal && k0 + kBN - 1 > qw0) ||
                        (window > 0 && qw_last - k0 >= window) ||
                        k0 + kBN > S || qw0 + 64 > S;
      float s[kBN / 2];
      fence_regs(s);
      wg_arrive();
      mma_ss<T, D, kBN>(s, sQ, kBM, 64 * f.wg, sK);
      wg_commit();
      wg_wait();
      fence_regs(s);
      float corr[2];
      if (edge)
        softmax_step<true>(s, mask_bits<kBN / 2, false>(f, qrow, k0, S, causal,
                                                        window),
                           sc, m, l, corr);
      else
        softmax_step<false>(s, 0u, sc, m, l, corr);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[Frag::row(i)];
      uint32_t pa[kBN / 16][4];        // p rounded to T
      to_a<T, kBN>(s, pa);
      fence_regs(acc);
      fence_regs(pa);
      wg_arrive();
      mma_rs<T, D, kBN>(acc, pa, sV, kBN);
      wg_commit();
      wg_wait();
      fence_regs(acc);
      fence_regs(pa);
    }
    __syncthreads();                   // the stage is free for the next copy
  }

  if (qw0 >= S) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qrow[r];
    if (qi >= S) continue;
    const float lv = fmaxf(l[r], 1e-30f);
    T* dst = o + (((long long)b * S + qi) * Hq + h) * D + f.cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dst + 8 * j, acc[4 * j + 2 * r] / lv, acc[4 * j + 2 * r + 1] / lv);
    if (f.lane % 4 == 0) lse[(long long)bh * S + qi] = m[r] + logf(lv);
  }
}

// -------------------------------------------- tensor cores: backward, dq
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<D>)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ o,
                       const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, T* __restrict__ dq, int S,
                       int Hq, int Hkv, int causal, int window, float sc,
                       int n_bh, int tiles) {
  using L = Tile<D>;
  constexpr int kKN = kDqKeys<D>;      // keys a K/V stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + L::bytes(kBM);
  const uint32_t sKV = sdO + L::bytes(kBM);  // stage i: K, then V
  constexpr uint32_t kStage = 2 * L::bytes(kKN);
  float* lse_s = reinterpret_cast<float*>(
      smem_raw + (sKV + 2 * kStage - smem_u32(smem_raw)));   // [128]
  float* delta_s = lse_s + kBM;                              // [128]

  const int bh = blockIdx.x % n_bh, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (tiles - 1 - (int)(blockIdx.x / n_bh)) * kBM;
  const Frag f;
  const int qw0 = q0 + 64 * f.wg, qw_last = min(qw0 + 63, S - 1);
  const int qrow[2] = {qw0 + f.ra, qw0 + f.ra + 8};

  int lo, hi;
  key_range(q0, kBM, kKN, S, causal, window, lo, hi);
  const int n = hi > lo ? (hi - lo + kKN - 1) / kKN : 0;

  load_tile<T, D, kBM>(sQ, q, b, h, Hq, S, q0);
  load_tile<T, D, kBM>(sdO, dout, b, h, Hq, S, q0);
  if (n > 0) {
    load_tile<T, D, kKN>(sKV, k, b, hk, Hkv, S, lo);
    load_tile<T, D, kKN>(sKV + L::bytes(kKN), v, b, hk, Hkv, S, lo);
  }
  cp_commit();

  // delta = rowsum(do * o) in fp32 from the stored (dtype-rounded) o and the
  // rows' lse: warp w takes rows w, w + 8, ...
  const int warp = threadIdx.x / 32;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int qi = q0 + r;
    float part = 0.f;
    if (qi < S) {
      const long long row = (((long long)b * S + qi) * Hq + h) * D;
      for (int c = f.lane; c < D; c += 32)
        part += Num<T>::load(dout + row + c) * Num<T>::load(o + row + c);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
    if (f.lane == 0) {
      delta_s[r] = part;
      lse_s[r] = qi < S ? lse[(long long)bh * S + qi] : 0.f;
      if (qi < S) delta[(long long)bh * S + qi] = part;
    }
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n; ++j) {
    const int k0 = lo + j * kKN;
    const uint32_t sK = sKV + (j & 1) * kStage, sV = sK + L::bytes(kKN);
    if (j + 1 < n) {
      const uint32_t nK = sKV + ((j + 1) & 1) * kStage;
      load_tile<T, D, kKN>(nK, k, b, hk, Hkv, S, k0 + kKN);
      load_tile<T, D, kKN>(nK + L::bytes(kKN), v, b, hk, Hkv, S, k0 + kKN);
      cp_commit();
      cp_wait_sync<1>();
    } else {
      cp_wait_sync<0>();
    }
    const bool live = qw0 < S && (!causal || k0 <= qw_last) &&
                      (window <= 0 || k0 + kKN - 1 > qw0 - window);
    if (live) {
      const bool edge = (causal && k0 + kKN - 1 > qw0) ||
                        (window > 0 && qw_last - k0 >= window) ||
                        k0 + kKN > S || qw0 + 64 > S;
      float s[kKN / 2], dp[kKN / 2];
      fence_regs(s);
      fence_regs(dp);
      wg_arrive();
      mma_ss<T, D, kKN>(s, sQ, kBM, 64 * f.wg, sK);
      mma_ss<T, D, kKN>(dp, sdO, kBM, 64 * f.wg, sV);
      wg_commit();
      wg_wait();
      fence_regs(s);
      fence_regs(dp);
      const int r0 = 64 * f.wg + f.ra;
      const float lr[2] = {lse_s[r0], lse_s[r0 + 8]};
      const float dr[2] = {delta_s[r0], delta_s[r0 + 8]};
      if (edge)
        probs<T, true, false>(s, mask_bits<kKN / 2, false>(f, qrow, k0, S,
                                                          causal, window),
                              sc, lr, nullptr, f);
      else
        probs<T, false, false>(s, 0u, sc, lr, nullptr, f);
#pragma unroll
      for (int i = 0; i < kKN / 2; ++i)     // ds, rounded to T by to_a
        s[i] = s[i] * (dp[i] - dr[Frag::row(i)]);
      uint32_t da[kKN / 16][4];
      to_a<T, kKN>(s, da);
      fence_regs(acc);
      fence_regs(da);
      wg_arrive();
      mma_rs<T, D, kKN>(acc, da, sK, kKN);
      wg_commit();
      wg_wait();
      fence_regs(acc);
      fence_regs(da);
    }
    __syncthreads();
  }

  if (qw0 >= S) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qrow[r];
    if (qi >= S) continue;
    T* dst = dq + (((long long)b * S + qi) * Hq + h) * D + f.cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dst + 8 * j, acc[4 * j + 2 * r] * sc, acc[4 * j + 2 * r + 1] * sc);
  }
}

// --------------------------------------- tensor cores: backward, dk, dv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<D>)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int S, int Hq, int Hkv,
                        int causal, int window, float sc, int n_bhk) {
  using L = Tile<D>;
  constexpr int kBK = kDkvKeys<D>;
  constexpr int NC = kSplitCols<D> ? D / 2 : D;   // dk/dv columns a warpgroup
  // stage: q tile, do tile, lse[kBQ], delta[kBQ] (padded to 1024 bytes)
  constexpr uint32_t kStage = 2 * L::bytes(kBQ) + 1024;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + L::bytes(kBK);
  const uint32_t sRing = sV + L::bytes(kBK);
  const float* ring = reinterpret_cast<const float*>(
      smem_raw + (sRing - smem_u32(smem_raw)));

  const int bhk = blockIdx.x % n_bhk, b = bhk / Hkv, g = bhk % Hkv;
  const int rep = Hq / Hkv;
  // causal: low kv tiles have most rows
  const int k0 = (int)(blockIdx.x / n_bhk) * kBK;
  const Frag f;
  // this warpgroup's 64 key rows of the block, and its first column of dk
  // and dv
  const int kr0 = kSplitCols<D> ? 0 : 64 * f.wg;
  const int col0 = kSplitCols<D> ? NC * f.wg : 0;
  const int kw0 = k0 + kr0, kw_last = min(kw0 + 63, S - 1);
  const int krow[2] = {kw0 + f.ra, kw0 + f.ra + 8};

  // query rows that see some key of [k0, k_last], in kBQ-row steps, for each
  // q head of the group
  const int k_last = min(k0 + kBK, S) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k_last + window) : S;
  const int nq = q_hi > q_lo ? (q_hi - q_lo + kBQ - 1) / kBQ : 0;
  const int n = rep * nq;

  auto load_step = [&](int it, uint32_t dst) {
    const int h = g * rep + it / nq, q0 = q_lo + (it % nq) * kBQ;
    const long long row = ((long long)b * Hq + h) * S;
    load_tile<T, D, kBQ>(dst, q, b, h, Hq, S, q0);
    load_tile<T, D, kBQ>(dst + L::bytes(kBQ), dout, b, h, Hq, S, q0);
    load_vec(dst + 2 * L::bytes(kBQ), lse + row, q0, S, kBQ);
    load_vec(dst + 2 * L::bytes(kBQ) + 4 * kBQ, delta + row, q0, S, kBQ);
  };

  load_tile<T, D, kBK>(sK, k, b, g, Hkv, S, k0);
  load_tile<T, D, kBK>(sV, v, b, g, Hkv, S, k0);
  if (n > 0) load_step(0, sRing);
  cp_commit();

  float dk_acc[NC / 2], dv_acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int q0 = q_lo + (it % nq) * kBQ;
    const uint32_t sQ = sRing + (it & 1) * kStage, sdO = sQ + L::bytes(kBQ);
    const float* lse_s = ring + (it & 1) * (kStage / 4) + 2 * L::bytes(kBQ) / 4;
    const float* delta_s = lse_s + kBQ;
    if (it + 1 < n) {
      load_step(it + 1, sRing + ((it + 1) & 1) * kStage);
      cp_commit();
      cp_wait_sync<1>();
    } else {
      cp_wait_sync<0>();
    }
    const bool live = kw0 < S && (!causal || q0 + kBQ - 1 >= kw0) &&
                      (window <= 0 || q0 <= kw_last + window - 1);
    if (live) {
      const bool edge = (causal && kw0 + 63 > q0) ||
                        (window > 0 && q0 + kBQ - 1 - kw0 >= window) ||
                        q0 + kBQ > S || kw0 + 64 > S;
      // p^T [keys, q rows], rounded to T
      float st[kBQ / 2];
      fence_regs(st);
      wg_arrive();
      mma_ss<T, D, kBQ>(st, sK, kBK, kr0, sQ);
      wg_commit();
      wg_wait();
      fence_regs(st);
      const float none[2] = {0.f, 0.f};
      if (edge)
        probs<T, true, true>(st, mask_bits<kBQ / 2, true>(f, krow, q0, S,
                                                        causal, window),
                             sc, none, lse_s, f);
      else
        probs<T, false, true>(st, 0u, sc, none, lse_s, f);
      uint32_t pa[kBQ / 16][4];
      to_a<T, kBQ>(st, pa);
      // dv += p^T do; dp^T = v do^T
      float dpt[kBQ / 2];
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(dpt);
      wg_arrive();
      mma_rs<T, D, kBQ, NC>(dv_acc, pa, sdO, kBQ, col0);
      mma_ss<T, D, kBQ>(dpt, sV, kBK, kr0, sdO);
      wg_commit();
      wg_wait();
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(dpt);
      // ds^T = p^T (dp^T - delta), rounded to T; dk += ds^T q
#pragma unroll
      for (int i = 0; i < kBQ / 2; ++i)
        dpt[i] = st[i] * (dpt[i] - delta_s[f.col(i)]);
      uint32_t da[kBQ / 16][4];
      to_a<T, kBQ>(dpt, da);
      fence_regs(dk_acc);
      fence_regs(da);
      wg_arrive();
      mma_rs<T, D, kBQ, NC>(dk_acc, da, sQ, kBQ, col0);
      wg_commit();
      wg_wait();
      fence_regs(dk_acc);
      fence_regs(da);
    }
    __syncthreads();
  }

  if (kw0 >= S) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = krow[r];
    if (kj >= S) continue;
    const long long base =
        (((long long)b * S + kj) * Hkv + g) * D + col0 + f.cq;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      store2(dk + base + 8 * j, dk_acc[4 * j + 2 * r] * sc,
             dk_acc[4 * j + 2 * r + 1] * sc);
      store2(dv + base + 8 * j, dv_acc[4 * j + 2 * r],
             dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------ host
// an fp32 tile of R rows of D (+1 padding) floats
constexpr size_t tile_bytes(int rows, int d) {
  return (size_t)rows * (d + 1) * 4;
}

// dynamic shared memory of each kernel (1024 bytes of it align the tiles)
template <int D> constexpr size_t fwd_tc_smem() {
  return 1024 + Tile<D>::bytes(kBM) + 4 * Tile<D>::bytes(kBN);
}
template <int D> constexpr size_t dq_tc_smem() {
  return 1024 + 2 * Tile<D>::bytes(kBM) + 4 * Tile<D>::bytes(kDqKeys<D>) +
         2 * kBM * 4;
}
template <int D> constexpr size_t dkv_tc_smem() {
  return 1024 + 2 * Tile<D>::bytes(kDkvKeys<D>) +
         2 * (2 * Tile<D>::bytes(kBQ) + 1024);
}
template <int D> constexpr size_t fwd_smem() {
  constexpr int KN = kCoreKeys<D>;
  return tile_bytes(kTile, D) + 2 * tile_bytes(KN, D) +
         tile_bytes(kTile, KN);
}
template <int D> constexpr size_t dq_smem() {
  constexpr int KN = kCoreKeys<D>;
  return 2 * tile_bytes(kTile, D) + 2 * tile_bytes(KN, D) +
         tile_bytes(kTile, KN) + 2 * kTile * 4;
}
template <int D> constexpr size_t dkv_smem() {
  constexpr int QN = kCoreKeys<D>;
  return 2 * tile_bytes(kTile, D) + 2 * tile_bytes(QN, D) +
         2 * tile_bytes(kTile, QN) + 2 * QN * 4;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// fp32: the CUDA-core kernels
template <int D>
cudaError_t fwd_fp32(const void* q, const void* k, const void* v, void* o,
                     void* lse, int b, int s, int hq, int hkv, int causal,
                     int window, cudaStream_t stream) {
  cudaError_t e = allow_smem(flash_fwd_kernel<float, D>, fwd_smem<D>());
  if (e != cudaSuccess) return e;
  const int tiles = ceil_div(s, kTile), n_bh = b * hq;
  flash_fwd_kernel<float, D><<<tiles * n_bh, kThreads, fwd_smem<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), s, hq, hkv, causal, window,
      1.0f / sqrtf((float)D), n_bh, tiles);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_fp32(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* delta, void* dq, void* dk, void* dv, int b, int s,
                     int hq, int hkv, int causal, int window,
                     cudaStream_t stream) {
  const float sc = 1.0f / sqrtf((float)D);
  const int tiles = ceil_div(s, kTile);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<float, D>, dq_smem<D>());
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<float, D>
      <<<tiles * b * hq, kThreads, dq_smem<D>(), stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(o),
          static_cast<const float*>(dout), static_cast<const float*>(lse),
          static_cast<float*>(delta), static_cast<float*>(dq), s, hq, hkv,
          causal, window, sc, b * hq, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_bwd_dkv_kernel<float, D>, dkv_smem<D>());
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<float, D>
      <<<tiles * b * hkv, kThreads, dkv_smem<D>(), stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<float*>(dk), static_cast<float*>(dv), s, hq, hkv,
          causal, window, sc, b * hkv);
  return cudaGetLastError();
}

// bf16 / fp16: the tensor-core kernels
template <typename T, int D>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int s, int hq, int hkv, int causal,
                   int window, cudaStream_t stream) {
  cudaError_t e = allow_smem(flash_fwd_tc_kernel<T, D>, fwd_tc_smem<D>());
  if (e != cudaSuccess) return e;
  const int tiles = ceil_div(s, kBM), n_bh = b * hq;
  flash_fwd_tc_kernel<T, D>
      <<<tiles * n_bh, kThreads, fwd_tc_smem<D>(), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o),
          static_cast<float*>(lse), s, hq, hkv, causal, window,
          1.0f / sqrtf((float)D), n_bh, tiles);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_tc(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv, int b, int s,
                   int hq, int hkv, int causal, int window,
                   cudaStream_t stream) {
  const float sc = 1.0f / sqrtf((float)D);
  const int tiles = ceil_div(s, kBM);
  cudaError_t e = allow_smem(flash_bwd_dq_tc_kernel<T, D>, dq_tc_smem<D>());
  if (e != cudaSuccess) return e;
  flash_bwd_dq_tc_kernel<T, D>
      <<<tiles * b * hq, kThreads, dq_tc_smem<D>(), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(o),
          static_cast<const T*>(dout), static_cast<const float*>(lse),
          static_cast<float*>(delta), static_cast<T*>(dq), s, hq, hkv,
          causal, window, sc, b * hq, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_bwd_dkv_tc_kernel<T, D>, dkv_tc_smem<D>());
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_tc_kernel<T, D>
      <<<ceil_div(s, kDkvKeys<D>) * b * hkv, kThreads, dkv_tc_smem<D>(),
        stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dk), static_cast<T*>(dv), s, hq, hkv, causal,
          window, sc, b * hkv);
  return cudaGetLastError();
}

// Blocks of the largest launch (64-row tiles) must fit one grid dimension.
bool shape_ok(int b, int s, int hq, int hkv) {
  return b > 0 && s > 0 && hkv > 0 && hq % hkv == 0 &&
         (long long)ceil_div(s, kTile) * b * hq <= INT_MAX;
}

// The head dims the kernels are built for (the model families' 80, 96 and
// 256 beside the powers of two).
#define DS_FLASH_DIMS(X) X(16) X(32) X(64) X(80) X(96) X(128) X(256)

bool kernel_dim(int d) {
#define DS_IS(D) d == D ||
  return DS_FLASH_DIMS(DS_IS) false;
#undef DS_IS
}

}  // namespace

// Which kernels a call takes: 1 = the tensor-core kernels (bf16, fp16),
// 0 = the CUDA-core kernels (fp32), -1 = none (a dtype or head dim the
// kernels do not take). dtype: 0 = float32, 1 = bfloat16, 2 = float16.
extern "C" int ds_flash_attention_variant(int dtype, int d) {
  if (!kernel_dim(d)) return -1;
  return dtype == 0 ? 0 : dtype == 1 || dtype == 2 ? 1 : -1;
}

// Dynamic shared memory (bytes) a block of kernel `which` takes: 0 the
// forward, 1 the dq pass, 2 the dk/dv pass; -1 where the variant is none.
extern "C" long long ds_flash_attention_smem(int which, int dtype, int d) {
  const int variant = ds_flash_attention_variant(dtype, d);
#define DS_SMEM(D)                                                        \
  if (d == D)                                                             \
    return (long long)(variant == 1                                       \
                           ? (which == 0   ? fwd_tc_smem<D>()             \
                              : which == 1 ? dq_tc_smem<D>()              \
                                           : dkv_tc_smem<D>())            \
                           : (which == 0   ? fwd_smem<D>()                \
                              : which == 1 ? dq_smem<D>()                 \
                                           : dkv_smem<D>()));
  if (variant >= 0 && which >= 0 && which <= 2) {
    DS_FLASH_DIMS(DS_SMEM)
  }
#undef DS_SMEM
  return -1;
}

// C entry points, bound with ctypes. dtype as above; d one of
// DS_FLASH_DIMS; window <= 0 means none. Tensors contiguous and 16-byte
// aligned. Each returns cudaGetLastError() after its launches (0 =
// launched).
extern "C" int ds_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int dtype, int b, int s, int hq,
                                      int hkv, int d, int causal, int window,
                                      void* stream) {
  if (!shape_ok(b, s, hq, hkv) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_FWD(D)                                                          \
  if (d == D) {                                                            \
    if (dtype == 0)                                                        \
      return (int)fwd_fp32<D>(q, k, v, o, lse, b, s, hq, hkv, causal,      \
                              window, st);                                 \
    if (dtype == 1)                                                        \
      return (int)fwd_tc<__nv_bfloat16, D>(q, k, v, o, lse, b, s, hq, hkv, \
                                           causal, window, st);            \
    if (dtype == 2)                                                        \
      return (int)fwd_tc<__half, D>(q, k, v, o, lse, b, s, hq, hkv,        \
                                    causal, window, st);                   \
  }
  DS_FLASH_DIMS(DS_FWD)
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
  if (!shape_ok(b, s, hq, hkv) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o) || !aligned16(dout) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_BWD(D)                                                           \
  if (d == D) {                                                             \
    if (dtype == 0)                                                         \
      return (int)bwd_fp32<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, b,  \
                              s, hq, hkv, causal, window, st);              \
    if (dtype == 1)                                                         \
      return (int)bwd_tc<__nv_bfloat16, D>(q, k, v, o, dout, lse, delta,    \
                                           dq, dk, dv, b, s, hq, hkv,       \
                                           causal, window, st);             \
    if (dtype == 2)                                                         \
      return (int)bwd_tc<__half, D>(q, k, v, o, dout, lse, delta, dq, dk,   \
                                    dv, b, s, hq, hkv, causal, window, st); \
  }
  DS_FLASH_DIMS(DS_BWD)
#undef DS_BWD
  return (int)cudaErrorInvalidValue;
}

// Message of a code returned above.
extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
