// Block-sparse attention, forward and backward, for Hopper.
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
// Two kernel sets, chosen by dtype in the C entry points below (a table,
// ds_block_sparse_attention_variant; never a retry): bf16 and fp16 take the
// tensor-core kernels ("wgmma"), fp32 the CUDA-core kernels ("cuda_cores"),
// whose products stay exact fp32 FMAs.
//
// What bounds them on an H100: at DeepSpeed's "fixed" example layout (block
// 16, 4 local blocks and 1 global a window, 26% of the blocks live at S 4096)
// with B 8 and 12 heads of 64 in bf16, the live blocks need 107.9 GFLOP
// forward and 269.8 backward (its five products) against ~0.2 and ~0.4 GB
// moved: 0.109 and 0.273 ms at 989 TFLOP/s, about twice the bytes' time.
// So the products must run on the tensor cores, in tiles that waste few of
// their rows and columns on dead pairs.
//
// Tensor-core design (bf16/fp16; building blocks in hopper_tiles.cuh):
//   * tile groups, built on the host (kernels.py `tile_groups`): the q
//     blocks of a head whose live-block lists (jmap rows) are identical, at
//     most 64 / block of them (a block over 64 rows split into 64-row tiles
//     that share its list), make one group of 64 rows that walks one shared
//     key stream; the k blocks with identical imap rows likewise for dk/dv.
//     At the layout above a local window's 4 q blocks share a list, as do
//     the 64 global k blocks of a head and a window's 3 local k blocks, so
//     98.5% of the issued products are live (BigBird's random blocks: 17-47%,
//     kernels.py `tile_fill`);
//   * a warpgroup (128 threads, one a CTA) owns a group's 64 rows, gathered
//     by 16-byte cp.async (each row's address from its block index) into a
//     swizzled Tile<DP> (the swizzle follows the row's place in the tile,
//     never its source row); the group's stream (the list's blocks: entry t
//     is row t % block of block list[t / block]) is walked in chunks of 64
//     entries gathered the same way through a 2-stage ring, so the next
//     chunk's copies fly while the current one is multiplied. Pad rows and
//     entries past the stream's end read as zeros, and the stream's last
//     chunk is masked so those entries give p = 0 exactly;
//   * forward: s = q k^T (wgmma m64n64k16), online softmax in registers, p
//     rounded to the dtype as the register A operand of o += p v;
//   * backward, two launches and no atomics (every output row belongs to
//     exactly one group, so a rerun gives the same bits): the dq kernel
//     writes delta for its rows first, then forms s = q k^T, dp = do v^T,
//     ds and dq += ds k; the dk/dv kernel takes its stream of query rows 32
//     at a time (registers): s^T = k q^T and dp^T = v do^T land p^T and
//     ds^T in the A-operand layout of dv += p^T do and dk += ds^T q, the
//     rows' lse and delta arriving by 4-byte cp.async beside them;
//   * (b, group) rides blockIdx.x, the groups ordered longest stream first
//     across all heads, so the heaviest CTAs start first and any batch x
//     heads under 2^31 - 1 blocks is taken;
//   * head_dim D a multiple of 8 up to 128 runs at DP in {16, 32, 64, 128}:
//     channels past D are zero-filled (cp.async source size 0) and only D
//     are stored. The tensors must be 16-byte aligned.
//
// CUDA-core design (fp32):
//   * a row's live k blocks are read as one stream of count * block keys,
//     staged in chunks of 64 keys in shared memory as fp32 (row stride D+1:
//     conflict-free column walks), so any block size that is a multiple of 8
//     runs the same code and a block of 16 does not leave 16-key tiles idle;
//   * a thread block owns a tile of TY query rows of one q block (TY = 16,
//     or 8 when the block is not a multiple of 16), 16 threads per row: a
//     thread owns 4 keys of each chunk's scores and D/16 channels of the
//     row's accumulators, in registers; row max/sum are 16-lane shuffles;
//   * the same two-launch backward, one block per (b*H, key tile) in the
//     dk/dv pass: a key tile of a global column walks every q block while a
//     local one walks a few (256 against 4 at the layout above), a known
//     imbalance of this fp32 path;
//   * head_dim up to 128: the kernels are compiled for 16, 32, 64 and 128
//     channels and a smaller multiple of 8 is zero-padded in shared memory.

#include <limits.h>

#include "hopper_tiles.cuh"

namespace {

constexpr int kChunk = 64;             // keys (or query rows) per staged chunk
constexpr int kPad = kChunk + 1;       // row stride of a [TY, 64] smem tile

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
              int L, float sc, int n_bh) {
  constexpr int NT = TY * 16, NJ = DP / 16, LD = DP + 1;
  extern __shared__ float smem[];
  float* qs = smem;                    // [TY][LD]
  float* ks = qs + TY * LD;            // [64][LD]
  float* vs = ks + kChunk * LD;        // [64][LD]
  float* ps = vs + kChunk * LD;        // [TY][65] p, rounded to T

  const int bh = blockIdx.x % n_bh, h = bh % H, nq = S / block;
  const int r0 = (int)(blockIdx.x / n_bh) * TY, qb = r0 / block;
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
                 int H, int S, int D, int block, int L, float sc, int n_bh) {
  constexpr int NT = TY * 16, NJ = DP / 16, LD = DP + 1;
  extern __shared__ float smem[];
  float* qs = smem;                    // [TY][LD]
  float* dos = qs + TY * LD;           // [TY][LD]
  float* ks = dos + TY * LD;           // [64][LD]
  float* vs = ks + kChunk * LD;        // [64][LD]
  float* dss = vs + kChunk * LD;       // [TY][65] ds, rounded to T
  float* lse_s = dss + TY * kPad;      // [TY]
  float* delta_s = lse_s + TY;         // [TY]

  const int bh = blockIdx.x % n_bh, h = bh % H, nq = S / block;
  const int r0 = (int)(blockIdx.x / n_bh) * TY, qb = r0 / block;
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
                  int block, int LT, float sc, int n_bh) {
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

  const int bh = blockIdx.x % n_bh, h = bh % H, nk = S / block;
  const int k0 = (int)(blockIdx.x / n_bh) * TY, kb = k0 / block;
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

// ======================== tensor cores (building blocks in hopper_tiles.cuh)
constexpr int kWG = 128;               // threads a CTA: one warpgroup
constexpr int kRows = 64;              // rows a group (the warpgroup's M)
constexpr int kGroupCols = 2 + kRows;  // a group: head, list's block, rows
constexpr int kHalf = 32;              // query entries a dk/dv step
// blocks of each tensor-core kernel an SM is to hold (launch bounds: 4 cap
// a thread at 128 registers, 2 at 255 for D 128's larger accumulators)
template <int DP> constexpr int kTcBlocksPerSM = DP > 64 ? 2 : 4;

// The group of this CTA (blockIdx.x = group * B + b, groups [G, kGroupCols]
// int32: head, the block whose list the group walks, then the source row of
// each of the 64 slots or -1): its rows, and its stream of n entries through
// the live blocks `live` of that list (entry t: row t % block of block
// live[t / block]).
struct Group {
  int b, h, n, block;
  const int* rows;
  const int* live;
  __device__ Group(const int* __restrict__ groups,
                   const int* __restrict__ lists,
                   const int* __restrict__ counts, int B, int nb, int L,
                   int blk)
      : b((int)(blockIdx.x % B)), block(blk) {
    const int* g = groups + (long long)(blockIdx.x / B) * kGroupCols;
    h = g[0];
    rows = g + 2;
    const long long at = (long long)h * nb + g[1];
    n = counts[at] * blk;
    live = lists + at * L;
  }
  __device__ int stream_row(int t) const {
    return t < n ? live[t / block] * block + t % block : -1;
  }
};

// A 64-row tile gathered into Tile<DP>s at dst0 (from src0) and, kTwo,
// dst1 (from src1): slot r takes row row_of(r) of the [S, D] slabs, zeros
// where row_of(r) < 0 and in channels D..DP-1. A thread copies one 16-byte
// chunk column of every kWG / (DP / 8)-th row.
template <typename T, int DP, bool kTwo, typename RowOf>
__device__ __forceinline__ void gather(uint32_t dst0,
                                       const T* __restrict__ src0,
                                       uint32_t dst1,
                                       const T* __restrict__ src1, int D,
                                       RowOf row_of) {
  constexpr int kC = DP / 8, kStep = kWG / kC;
  const int c = (threadIdx.x % kC) * 8;
#pragma unroll
  for (int j = 0; j < kRows / kStep; ++j) {
    const int r = threadIdx.x / kC + j * kStep, row = row_of(r);
    const bool ok = row >= 0 && c < D;
    const long long at = ok ? (long long)row * D + c : 0;
    const uint32_t off = Tile<DP>::offset(kRows, r, c);
    cp_async16(dst0 + off, src0 + at, ok ? 16 : 0);
    if (kTwo) cp_async16(dst1 + off, src1 + at, ok ? 16 : 0);
  }
}

// Bit i set where accumulator element i lies in the first `valid` columns.
template <int NE>
__device__ __forceinline__ uint32_t tail_bits(const Frag& f, int valid) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < NE; ++i) bits |= (uint32_t)(f.col(i) < valid) << i;
  return bits;
}

// ------------------------------------------------ tensor cores: forward
template <typename T, int DP>
__global__ void __launch_bounds__(kWG, kTcBlocksPerSM<DP>)
bs_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ jmap,
                 const int* __restrict__ counts,
                 const int* __restrict__ groups, int B, int H, int S, int D,
                 int block, int L, float sc) {
  constexpr uint32_t kTileB = Tile<DP>::bytes(kRows);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + kTileB;      // stage i: K, then V

  const Group g(groups, jmap, counts, B, S / block, L, block);
  const long long bh = (long long)g.b * H + g.h;
  const T* qs = q + bh * S * D;
  const T* ks = k + bh * S * D;
  const T* vs = v + bh * S * D;
  const int chunks = (g.n + kChunk - 1) / kChunk;
  const Frag f;

  if (chunks > 0) {                    // a dead group only writes o = 0
    gather<T, DP, false>(sQ, qs, sQ, qs, D,
                         [&](int r) { return g.rows[r]; });
    gather<T, DP, true>(sKV, ks, sKV + kTileB, vs, D,
                        [&](int r) { return g.stream_row(r); });
    cp_commit();
  }

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < chunks; ++j) {
    const int t0 = j * kChunk;
    const uint32_t sK = sKV + (j & 1) * 2 * kTileB, sV = sK + kTileB;
    if (j + 1 < chunks) {
      const uint32_t nK = sKV + ((j + 1) & 1) * 2 * kTileB;
      gather<T, DP, true>(nK, ks, nK + kTileB, vs, D, [&](int r) {
        return g.stream_row(t0 + kChunk + r);
      });
      cp_commit();
      cp_wait_sync<1>();
    } else {
      cp_wait_sync<0>();
    }
    float s[kChunk / 2];
    fence_regs(s);
    wg_arrive();
    mma_ss<T, DP, kChunk>(s, sQ, kRows, 0, sK);
    wg_commit();
    wg_wait();
    fence_regs(s);
    float corr[2];
    if (t0 + kChunk > g.n)             // the stream's last, partial chunk
      softmax_step<true>(s, tail_bits<kChunk / 2>(f, g.n - t0), sc, m, l,
                         corr);
    else
      softmax_step<false>(s, 0u, sc, m, l, corr);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[Frag::row(i)];
    uint32_t pa[kChunk / 16][4];       // p rounded to T
    to_a<T, kChunk>(s, pa);
    fence_regs(acc);
    fence_regs(pa);
    wg_arrive();
    mma_rs<T, DP, kChunk>(acc, pa, sV, kChunk);
    wg_commit();
    wg_wait();
    fence_regs(acc);
    fence_regs(pa);
    __syncthreads();                   // the stage is free for the next copy
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g.rows[f.ra + 8 * r];
    if (row < 0) continue;
    const float lv = fmaxf(l[r], 1e-30f);   // a dead row: acc = 0, so o = 0
    T* dst = o + (bh * S + row) * D + f.cq;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        store2(dst + 8 * j, acc[4 * j + 2 * r] / lv,
               acc[4 * j + 2 * r + 1] / lv);
    if (f.lane % 4 == 0) lse[bh * S + row] = m[r] + logf(lv);
  }
}

// -------------------------------------------- tensor cores: backward, dq
template <typename T, int DP>
__global__ void __launch_bounds__(kWG, kTcBlocksPerSM<DP>)
bs_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq,
                    const int* __restrict__ jmap,
                    const int* __restrict__ counts,
                    const int* __restrict__ groups, int B, int H, int S,
                    int D, int block, int L, float sc) {
  constexpr uint32_t kTileB = Tile<DP>::bytes(kRows);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + kTileB;
  const uint32_t sKV = sdO + kTileB;     // stage i: K, then V
  float* lse_s = reinterpret_cast<float*>(
      smem_raw + (sKV + 4 * kTileB - smem_u32(smem_raw)));   // [64]
  float* delta_s = lse_s + kRows;                            // [64]

  const Group g(groups, jmap, counts, B, S / block, L, block);
  const long long bh = (long long)g.b * H + g.h;
  const long long base = bh * S * D;
  const int chunks = (g.n + kChunk - 1) / kChunk;
  const Frag f;

  if (chunks > 0) {
    gather<T, DP, true>(sQ, q + base, sdO, dout + base, D,
                        [&](int r) { return g.rows[r]; });
    gather<T, DP, true>(sKV, k + base, sKV + kTileB, v + base, D,
                        [&](int r) { return g.stream_row(r); });
    cp_commit();
  }

  // delta = rowsum(do * o) in fp32 from the stored (dtype-rounded) o and the
  // rows' lse: warp w takes slots w, w + 4, ...
  for (int r = threadIdx.x / 32; r < kRows; r += kWG / 32) {
    const int row = g.rows[r];
    float part = 0.f;
    if (row >= 0) {
      const long long at = base + (long long)row * D;
      for (int c = f.lane; c < D; c += 32)
        part += Num<T>::load(dout + at + c) * Num<T>::load(o + at + c);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
    if (f.lane == 0) {
      delta_s[r] = part;
      lse_s[r] = row >= 0 ? lse[bh * S + row] : 0.f;
      if (row >= 0) delta[bh * S + row] = part;
    }
  }

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < chunks; ++j) {
    const int t0 = j * kChunk;
    const uint32_t sK = sKV + (j & 1) * 2 * kTileB, sV = sK + kTileB;
    if (j + 1 < chunks) {
      const uint32_t nK = sKV + ((j + 1) & 1) * 2 * kTileB;
      gather<T, DP, true>(nK, k + base, nK + kTileB, v + base, D, [&](int r) {
        return g.stream_row(t0 + kChunk + r);
      });
      cp_commit();
      cp_wait_sync<1>();
    } else {
      cp_wait_sync<0>();
    }
    float s[kChunk / 2], dp[kChunk / 2];
    fence_regs(s);
    fence_regs(dp);
    wg_arrive();
    mma_ss<T, DP, kChunk>(s, sQ, kRows, 0, sK);
    mma_ss<T, DP, kChunk>(dp, sdO, kRows, 0, sV);
    wg_commit();
    wg_wait();
    fence_regs(s);
    fence_regs(dp);
    const float lr[2] = {lse_s[f.ra], lse_s[f.ra + 8]};
    const float dr[2] = {delta_s[f.ra], delta_s[f.ra + 8]};
    if (t0 + kChunk > g.n)
      probs<T, true, false>(s, tail_bits<kChunk / 2>(f, g.n - t0), sc, lr,
                            nullptr, f);
    else
      probs<T, false, false>(s, 0u, sc, lr, nullptr, f);
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i)    // ds, rounded to T by to_a
      s[i] = s[i] * (dp[i] - dr[Frag::row(i)]);
    uint32_t da[kChunk / 16][4];
    to_a<T, kChunk>(s, da);
    fence_regs(acc);
    fence_regs(da);
    wg_arrive();
    mma_rs<T, DP, kChunk>(acc, da, sK, kChunk);
    wg_commit();
    wg_wait();
    fence_regs(acc);
    fence_regs(da);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g.rows[f.ra + 8 * r];
    if (row < 0) continue;
    T* dst = dq + base + (long long)row * D + f.cq;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        store2(dst + 8 * j, acc[4 * j + 2 * r] * sc,
               acc[4 * j + 2 * r + 1] * sc);
  }
}

// --------------------------------------- tensor cores: backward, dk, dv
template <typename T, int DP>
__global__ void __launch_bounds__(kWG, kTcBlocksPerSM<DP>)
bs_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, const int* __restrict__ imap,
                     const int* __restrict__ countsT,
                     const int* __restrict__ groups, int B, int H, int S,
                     int D, int block, int LT, float sc) {
  using Lt = Tile<DP>;
  constexpr uint32_t kTileB = Lt::bytes(kRows);
  // stage: q chunk, do chunk, lse[64] and delta[64] of its query rows
  // (padded to 1024 bytes)
  constexpr uint32_t kStage = 2 * kTileB + 1024;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + kTileB;
  const uint32_t sRing = sV + kTileB;
  const float* ring = reinterpret_cast<const float*>(
      smem_raw + (sRing - smem_u32(smem_raw)));

  const Group g(groups, imap, countsT, B, S / block, LT, block);
  const long long bh = (long long)g.b * H + g.h;
  const long long base = bh * S * D;
  const int chunks = (g.n + kChunk - 1) / kChunk;
  const Frag f;

  auto load_stage = [&](int t0, uint32_t dst) {
    gather<T, DP, true>(dst, q + base, dst + kTileB, dout + base, D,
                        [&](int r) { return g.stream_row(t0 + r); });
    // threads 0-63 copy the chunk's lse, 64-127 its delta
    const int row = g.stream_row(t0 + threadIdx.x % kChunk);
    const float* vec = (threadIdx.x < kChunk ? lse : delta) + bh * S;
    cp_async4(dst + 2 * kTileB + 4 * threadIdx.x, vec + (row >= 0 ? row : 0),
              row >= 0 ? 4 : 0);
  };

  if (chunks > 0) {
    gather<T, DP, true>(sK, k + base, sV, v + base, D,
                        [&](int r) { return g.rows[r]; });
    load_stage(0, sRing);
    cp_commit();
  }

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int j = 0; j < chunks; ++j) {
    const int t0 = j * kChunk;
    const uint32_t sQc = sRing + (j & 1) * kStage, sdOc = sQc + kTileB;
    const float* lse_s = ring + (j & 1) * (kStage / 4) + 2 * kTileB / 4;
    const float* delta_s = lse_s + kChunk;
    if (j + 1 < chunks) {
      load_stage(t0 + kChunk, sRing + ((j + 1) & 1) * kStage);
      cp_commit();
      cp_wait_sync<1>();
    } else {
      cp_wait_sync<0>();
    }
#pragma unroll
    for (int half = 0; half < kChunk / kHalf; ++half) {
      const int th = t0 + half * kHalf;
      if (th >= g.n) continue;         // past the stream's end (uniform)
      // p^T [keys, query entries], rounded to T
      float st[kHalf / 2];
      fence_regs(st);
      wg_arrive();
      mma_ss<T, DP, kHalf>(st, sK, kRows, 0, sQc, kChunk, half * kHalf);
      wg_commit();
      wg_wait();
      fence_regs(st);
      const float none[2] = {0.f, 0.f};
      if (th + kHalf > g.n)
        probs<T, true, true>(st, tail_bits<kHalf / 2>(f, g.n - th), sc, none,
                             lse_s + half * kHalf, f);
      else
        probs<T, false, true>(st, 0u, sc, none, lse_s + half * kHalf, f);
      uint32_t pa[kHalf / 16][4];
      to_a<T, kHalf>(st, pa);
      // dv += p^T do; dp^T = v do^T
      float dpt[kHalf / 2];
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(dpt);
      wg_arrive();
      mma_rs<T, DP, kHalf>(dv_acc, pa, sdOc + half * kHalf * Lt::kRow,
                           kChunk);
      mma_ss<T, DP, kHalf>(dpt, sV, kRows, 0, sdOc, kChunk, half * kHalf);
      wg_commit();
      wg_wait();
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(dpt);
      // ds^T = p^T (dp^T - delta), rounded to T; dk += ds^T q
#pragma unroll
      for (int i = 0; i < kHalf / 2; ++i)
        dpt[i] = st[i] * (dpt[i] - delta_s[half * kHalf + f.col(i)]);
      uint32_t da[kHalf / 16][4];
      to_a<T, kHalf>(dpt, da);
      fence_regs(dk_acc);
      fence_regs(da);
      wg_arrive();
      mma_rs<T, DP, kHalf>(dk_acc, da, sQc + half * kHalf * Lt::kRow,
                           kChunk);
      wg_commit();
      wg_wait();
      fence_regs(dk_acc);
      fence_regs(da);
    }
    __syncthreads();                   // the stage is free for the next copy
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g.rows[f.ra + 8 * r];
    if (row < 0) continue;
    const long long at = base + (long long)row * D + f.cq;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j >= D) continue;
      store2(dk + at + 8 * j, dk_acc[4 * j + 2 * r] * sc,
             dk_acc[4 * j + 2 * r + 1] * sc);
      store2(dv + at + 8 * j, dv_acc[4 * j + 2 * r],
             dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------ host
constexpr size_t rows_bytes(int rows, int dp) {
  return (size_t)rows * (dp + 1) * 4;
}

// dynamic shared memory of each kernel (1024 bytes of the tensor-core ones'
// align their tiles)
template <int DP, int TY> constexpr size_t fwd_smem() {
  return rows_bytes(TY, DP) + 2 * rows_bytes(kChunk, DP) +
         (size_t)TY * kPad * 4;
}
template <int DP, int TY> constexpr size_t dq_smem() {
  return 2 * rows_bytes(TY, DP) + 2 * rows_bytes(kChunk, DP) +
         (size_t)TY * kPad * 4 + 2 * TY * 4;
}
template <int DP, int TY> constexpr size_t dkv_smem() {
  return 2 * rows_bytes(TY, DP) + 2 * rows_bytes(kChunk, DP) +
         2 * (size_t)TY * kPad * 4 + 2 * kChunk * 4;
}
template <int DP> constexpr size_t fwd_tc_smem() {
  return 1024 + 5 * (size_t)Tile<DP>::bytes(kRows);
}
template <int DP> constexpr size_t dq_tc_smem() {
  return 1024 + 6 * (size_t)Tile<DP>::bytes(kRows) + 2 * kRows * 4;
}
template <int DP> constexpr size_t dkv_tc_smem() {
  return 1024 + 2 * (size_t)Tile<DP>::bytes(kRows) +
         2 * (2 * (size_t)Tile<DP>::bytes(kRows) + 1024);
}

// fp32: the CUDA-core kernels, one block per (b*h, TY-row tile)
template <typename T, int DP, int TY>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, const int* jmap, const int* counts, int b, int h,
                int s, int d, int block, int L, cudaStream_t stream) {
  const size_t smem = fwd_smem<DP, TY>();
  cudaError_t e = allow_smem(bs_fwd_kernel<T, DP, TY>, smem);
  if (e != cudaSuccess) return e;
  bs_fwd_kernel<T, DP, TY><<<(s / TY) * b * h, TY * 16, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      jmap, counts, h, s, d, block, L, 1.0f / sqrtf((float)d), b * h);
  return cudaGetLastError();
}

template <typename T, int DP, int TY>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, const int* jmap, const int* counts,
                int L, const int* imap, const int* countsT, int LT, int b,
                int h, int s, int d, int block, cudaStream_t stream) {
  const float sc = 1.0f / sqrtf((float)d);
  const int grid = (s / TY) * b * h;
  const size_t smem_dq = dq_smem<DP, TY>();
  cudaError_t e = allow_smem(bs_bwd_dq_kernel<T, DP, TY>, smem_dq);
  if (e != cudaSuccess) return e;
  bs_bwd_dq_kernel<T, DP, TY><<<grid, TY * 16, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), jmap, counts, h, s, d,
      block, L, sc, b * h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem_kv = dkv_smem<DP, TY>();
  e = allow_smem(bs_bwd_dkv_kernel<T, DP, TY>, smem_kv);
  if (e != cudaSuccess) return e;
  bs_bwd_dkv_kernel<T, DP, TY><<<grid, TY * 16, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), imap, countsT, h, s, d, block,
      LT, sc, b * h);
  return cudaGetLastError();
}

// bf16 / fp16: the tensor-core kernels, one block per (group, b)
template <typename T, int DP>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* o,
                   void* lse, const int* jmap, const int* counts, int L,
                   const int* groups, int n_groups, int b, int h, int s,
                   int d, int block, cudaStream_t stream) {
  cudaError_t e = allow_smem(bs_fwd_tc_kernel<T, DP>, fwd_tc_smem<DP>());
  if (e != cudaSuccess) return e;
  bs_fwd_tc_kernel<T, DP><<<n_groups * b, kWG, fwd_tc_smem<DP>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      jmap, counts, groups, b, h, s, d, block, L, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t bwd_tc(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv,
                   const int* jmap, const int* counts, int L,
                   const int* groups, int n_groups, const int* imap,
                   const int* countsT, int LT, const int* groupsT,
                   int n_groupsT, int b, int h, int s, int d, int block,
                   cudaStream_t stream) {
  const float sc = 1.0f / sqrtf((float)d);
  cudaError_t e = allow_smem(bs_bwd_dq_tc_kernel<T, DP>, dq_tc_smem<DP>());
  if (e != cudaSuccess) return e;
  bs_bwd_dq_tc_kernel<T, DP>
      <<<n_groups * b, kWG, dq_tc_smem<DP>(), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(o),
          static_cast<const T*>(dout), static_cast<const float*>(lse),
          static_cast<float*>(delta), static_cast<T*>(dq), jmap, counts,
          groups, b, h, s, d, block, L, sc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = allow_smem(bs_bwd_dkv_tc_kernel<T, DP>, dkv_tc_smem<DP>());
  if (e != cudaSuccess) return e;
  bs_bwd_dkv_tc_kernel<T, DP>
      <<<n_groupsT * b, kWG, dkv_tc_smem<DP>(), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dk), static_cast<T*>(dv), imap, countsT, groupsT,
          b, h, s, d, block, LT, sc);
  return cudaGetLastError();
}

bool shape_ok(int b, int h, int s, int d, int block) {
  return b > 0 && h > 0 && block >= 8 && block % 8 == 0 && s % block == 0 &&
         d > 0 && d % 8 == 0 && d <= 128;
}

// The channel count the kernels are compiled for: the least of 16, 32, 64,
// 128 that holds d.
int padded_dim(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

}  // namespace

// Which kernels a call takes: 1 = the tensor-core kernels (bf16, fp16),
// 0 = the CUDA-core kernels (fp32), -1 = none (a dtype or head dim the
// kernels do not take). dtype: 0 = float32, 1 = bfloat16, 2 = float16.
extern "C" int ds_block_sparse_attention_variant(int dtype, int d) {
  if (d <= 0 || d % 8 != 0 || d > 128) return -1;
  return dtype == 0 ? 0 : dtype == 1 || dtype == 2 ? 1 : -1;
}

// Dynamic shared memory (bytes) a block of kernel `which` takes: 0 the
// forward, 1 the dq pass, 2 the dk/dv pass (the CUDA-core kernels at a
// block size that is a multiple of 16); -1 where the variant is none.
extern "C" long long ds_block_sparse_attention_smem(int which, int dtype,
                                                    int d) {
  const int variant = ds_block_sparse_attention_variant(dtype, d);
  if (variant < 0 || which < 0 || which > 2) return -1;
#define DS_SMEM(DP)                                                        \
  if (padded_dim(d) == DP)                                                 \
    return (long long)(variant == 1                                        \
                           ? (which == 0   ? fwd_tc_smem<DP>()             \
                              : which == 1 ? dq_tc_smem<DP>()              \
                                           : dkv_tc_smem<DP>())            \
                           : (which == 0   ? fwd_smem<DP, 16>()            \
                              : which == 1 ? dq_smem<DP, 16>()             \
                                           : dkv_smem<DP, 16>()));
  DS_SMEM(16) DS_SMEM(32) DS_SMEM(64) DS_SMEM(128)
#undef DS_SMEM
  return -1;
}

// Calls F(DP, TY) for the CUDA-core kernels (fp32) at the padded channel
// count and the query tile (16 when block is a multiple of 16, else 8), or
// F(T, DP) for the tensor-core kernels of the dtype code.
#define DS_FP32_TY(F, DP) \
  if (block % 16 == 0) F(DP, 16); \
  F(DP, 8)
#define DS_FP32(F)                                     \
  if (dtype == 0) {                                    \
    if (dp == 16) { DS_FP32_TY(F, 16); }               \
    if (dp == 32) { DS_FP32_TY(F, 32); }               \
    if (dp == 64) { DS_FP32_TY(F, 64); }               \
    DS_FP32_TY(F, 128);                                \
  }
#define DS_TC_DP(F, T)                                 \
  if (dp == 16) F(T, 16);                              \
  if (dp == 32) F(T, 32);                              \
  if (dp == 64) F(T, 64);                              \
  F(T, 128)
#define DS_TC(F)                                       \
  if (dtype == 1) { DS_TC_DP(F, __nv_bfloat16); }      \
  if (dtype == 2) { DS_TC_DP(F, __half); }             \
  return (int)cudaErrorInvalidValue

// C entry points, bound with ctypes. Each returns cudaGetLastError() after
// its launches (0 = launched). block: a multiple of 8 dividing s; d: a
// multiple of 8 up to 128; L: the length of a jmap row; groups: the tile
// groups over the jmap lists ([n_groups, 66] int32, see Group), read by the
// tensor-core kernels. Tensors contiguous and 16-byte aligned.
extern "C" int ds_block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* jmap, const void* counts, int L, const void* groups,
    int n_groups, int dtype, int b, int h, int s, int d, int block,
    void* stream) {
  if (!shape_ok(b, h, s, d, block) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  const int variant = ds_block_sparse_attention_variant(dtype, d);
  const long long blocks =
      variant == 0 ? (long long)(s / 8) * b * h : (long long)n_groups * b;
  if (variant < 0 || n_groups <= 0 || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* jm = static_cast<const int*>(jmap);
  const int* ct = static_cast<const int*>(counts);
  const int* gr = static_cast<const int*>(groups);
  const int dp = padded_dim(d);
#define DS_FWD(DP, TY) \
  return (int)fwd<float, DP, TY>(q, k, v, o, lse, jm, ct, b, h, s, d, block, \
                                 L, st)
  DS_FP32(DS_FWD);
#undef DS_FWD
#define DS_FWD(T, DP)                                                        \
  return (int)fwd_tc<T, DP>(q, k, v, o, lse, jm, ct, L, gr, n_groups, b, h, \
                            s, d, block, st)
  DS_TC(DS_FWD);
#undef DS_FWD
}

// delta: [B, H, S] fp32 scratch, written by the dq pass, read by dk/dv.
// LT: the length of an imap row; groupsT: the tile groups over the imap
// lists.
extern "C" int ds_block_sparse_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const void* jmap, const void* counts, int L,
    const void* groups, int n_groups, const void* imap, const void* countsT,
    int LT, const void* groupsT, int n_groupsT, int dtype, int b, int h,
    int s, int d, int block, void* stream) {
  if (!shape_ok(b, h, s, d, block) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o) || !aligned16(dout) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  const int variant = ds_block_sparse_attention_variant(dtype, d);
  const long long blocks =
      variant == 0 ? (long long)(s / 8) * b * h
                   : (long long)(n_groups > n_groupsT ? n_groups : n_groupsT) *
                         b;
  if (variant < 0 || n_groups <= 0 || n_groupsT <= 0 || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* jm = static_cast<const int*>(jmap);
  const int* ct = static_cast<const int*>(counts);
  const int* gr = static_cast<const int*>(groups);
  const int* im = static_cast<const int*>(imap);
  const int* ctT = static_cast<const int*>(countsT);
  const int* grT = static_cast<const int*>(groupsT);
  const int dp = padded_dim(d);
#define DS_BWD(DP, TY)                                                      \
  return (int)bwd<float, DP, TY>(q, k, v, o, dout, lse, delta, dq, dk, dv, \
                                 jm, ct, L, im, ctT, LT, b, h, s, d, block, \
                                 st)
  DS_FP32(DS_BWD);
#undef DS_BWD
#define DS_BWD(T, DP)                                                        \
  return (int)bwd_tc<T, DP>(q, k, v, o, dout, lse, delta, dq, dk, dv, jm,   \
                            ct, L, gr, n_groups, im, ctT, LT, grT,         \
                            n_groupsT, b, h, s, d, block, st)
  DS_TC(DS_BWD);
#undef DS_BWD
}

#undef DS_TC
#undef DS_TC_DP
#undef DS_FP32
#undef DS_FP32_TY

// Message of a code returned above.
extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
