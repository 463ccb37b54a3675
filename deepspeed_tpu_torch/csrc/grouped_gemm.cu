// Grouped matrix product over expert-sorted rows, for Hopper:
//   out[r, :] = x[r, :] @ w[e(r)]      e(r): the group whose rows hold r
// x [R, K] (the rows sorted by expert), w [E, K, N], offsets [E] int32 the
// groups' cumulative ends (offsets[E-1] == R; an empty group repeats the
// previous end), out [R, N]; bf16, fp16 or fp32, every sum in fp32, the
// result rounded once to the input's type.
//
// It replaces no Pallas kernel: the JAX package computes this with XLA's
// `lax.ragged_dot` (deepspeed_tpu/moe/sharded_moe.py:163-177, the serving
// MoE's sort-by-expert form). The port needs a product that reads the group
// offsets on the device, so that no group size comes back to the host and
// a CUDA graph captures the MoE layer (deepspeed_tpu_torch/moe/
// sharded_moe.py `moe_ffn_grouped`).
//
// The schedule: the grid's x walks N in 64-column tiles; its y walks the
// groups' 64-row tiles, ceil(R / 64) + min(E, R) slots (an upper bound of
// sum_e ceil(size_e / 64)). A block's first thread finds its group and row
// tile from the offsets (a scan over E ints, L2-resident); a block past the
// last tile exits. Each tile lies inside one group, so it reads one expert's
// weight; rows past the group's end load as zeros and are not stored.
//
// What bounds it on an H100: at a decode step (16-32 rows) bytes, the
// weights of every expert that holds a row read once a column tile; at a
// prefill tick (thousands of rows) operations. bf16/fp16 run on the tensor
// cores (WMMA 16x16x16 fragments with fp32 accumulators, four warps a 64 x
// 64 tile, 32-deep K steps through shared memory, the next step's tile
// loaded into registers while the current one multiplies); fp32 runs on the
// CUDA cores (exact fp32 products, no TF32: the MoE families are held in
// fp32 against the CPU), 256 threads a 64 x 64 tile, 4 x 4 outputs each.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;

// The block's group and first row: (-1, 0, 0) past the last tile.
struct TileOf {
  int group, row0, rows;
};

__device__ __forceinline__ TileOf find_tile(const int* offsets, int groups,
                                            long long total_rows) {
  __shared__ TileOf tile;
  if (threadIdx.x == 0) {
    int slot = blockIdx.y;
    int start = 0;
    tile.group = -1;
    tile.row0 = 0;
    tile.rows = 0;
    for (int e = 0; e < groups; ++e) {
      int end = offsets[e];
      if (end > total_rows) end = (int)total_rows;
      int size = end - start;
      int tiles = size > 0 ? (size + kTileM - 1) / kTileM : 0;
      if (slot < tiles) {
        tile.group = e;
        tile.row0 = start + slot * kTileM;
        int left = end - tile.row0;
        tile.rows = left < kTileM ? left : kTileM;
        break;
      }
      slot -= tiles;
      if (end > start) start = end;
    }
  }
  __syncthreads();
  return tile;
}

template <typename T> struct Num;
template <> struct Num<__nv_bfloat16> {
  __device__ static __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16(0.f); }
};
template <> struct Num<__half> {
  __device__ static __half from(float v) { return __float2half(v); }
  __device__ static __half zero() { return __float2half(0.f); }
};

// ------------------------------------------------------------ tensor cores
constexpr int kTcThreads = 128;   // four warps, 32 x 32 of the tile each
constexpr int kTcK = 32;          // K depth of a step
constexpr int kPadA = kTcK + 8;   // row pitch of the A tile (elements)
constexpr int kPadB = kTileN + 8;  // row pitch of the B tile
constexpr int kPadC = kTileN + 4;  // row pitch of the fp32 result tile

// Loads 8 consecutive elements starting at column `col` of a row of
// length `len` (elements) into `dst`, zero past it; `kVec`: the row and
// `len` allow a 16-byte load when the 8 lie inside.
template <typename T, bool kVec>
__device__ __forceinline__ void load8(const T* row, long long col,
                                      long long len, bool live, uint4& dst) {
  if (live && kVec && col + 8 <= len) {
    dst = *reinterpret_cast<const uint4*>(row + col);
    return;
  }
  T* e = reinterpret_cast<T*>(&dst);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = (live && col + i < len) ? row[col + i] : Num<T>::zero();
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kTcThreads)
grouped_mm_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const int* __restrict__ offsets, T* __restrict__ out,
                     long long total_rows, int K, int N, int groups) {
  using namespace nvcuda;
  const TileOf tile = find_tile(offsets, groups, total_rows);
  if (tile.group < 0) return;
  const int n0 = blockIdx.x * kTileN;
  const T* wg = w + (long long)tile.group * K * N;

  // 16-bit storage (T's constructor stays out of a __shared__ array)
  __shared__ __align__(32) uint16_t sa_bits[kTileM * kPadA];
  __shared__ __align__(32) uint16_t sb_bits[kTcK * kPadB];
  __shared__ __align__(32) float sc[kTileM * kPadC];
  T* sa = reinterpret_cast<T*>(sa_bits);
  T* sb = reinterpret_cast<T*>(sb_bits);

  // each thread stages two 8-element pieces of A (64 x 32) and two of B
  // (32 x 64) a step, 16 bytes each
  const int t = threadIdx.x;
  uint4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      int piece = t + p * kTcThreads;          // 0..255
      int ar = piece / (kTcK / 8), ac = (piece % (kTcK / 8)) * 8;
      bool alive = ar < tile.rows;
      load8<T, kVec>(x + (long long)(tile.row0 + (alive ? ar : 0)) * K,
                     k0 + ac, K, alive, ra[p]);
      int br = piece / (kTileN / 8), bc = (piece % (kTileN / 8)) * 8;
      bool blive = k0 + br < K;
      load8<T, kVec>(wg + (long long)(blive ? k0 + br : 0) * N, n0 + bc, N,
                     blive, rb[p]);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      int piece = t + p * kTcThreads;
      int ar = piece / (kTcK / 8), ac = (piece % (kTcK / 8)) * 8;
      int br = piece / (kTileN / 8), bc = (piece % (kTileN / 8)) * 8;
      // row pitches of 80 and 144 bytes keep every piece 16-byte aligned
      *reinterpret_cast<uint4*>(sa + ar * kPadA + ac) = ra[p];
      *reinterpret_cast<uint4*>(sb + br * kPadB + bc) = rb[p];
    }
  };

  const int warp = t / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kTcK) {
    __syncthreads();              // the last step's reads of sa/sb are done
    stage();
    __syncthreads();
    if (k0 + kTcK < K) fetch(k0 + kTcK);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sa + (wm + 16 * i) * kPadA + kk, kPadA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sb + kk * kPadB + wn + 16 * j, kPadB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sc + (wm + 16 * i) * kPadC + wn + 16 * j,
                              acc[i][j], kPadC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = t; idx < kTileM * kTileN; idx += kTcThreads) {
    int r = idx / kTileN, c = idx % kTileN;
    if (r < tile.rows && n0 + c < N)
      out[(long long)(tile.row0 + r) * N + n0 + c] =
          Num<T>::from(sc[r * kPadC + c]);
  }
}

// ------------------------------------------------------------- CUDA cores
constexpr int kFpThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kFpK = 16;

__global__ void __launch_bounds__(kFpThreads)
grouped_mm_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const int* __restrict__ offsets, float* __restrict__ out,
                       long long total_rows, int K, int N, int groups) {
  const TileOf tile = find_tile(offsets, groups, total_rows);
  if (tile.group < 0) return;
  const int n0 = blockIdx.x * kTileN;
  const float* wg = w + (long long)tile.group * K * N;
  __shared__ float sa[kFpK][kTileM + 4];   // A transposed: k-major
  __shared__ float sb[kFpK][kTileN];
  const int t = threadIdx.x;
  const int tr = (t / 16) * 4, tc = (t % 16) * 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFpK) {
    for (int idx = t; idx < kTileM * kFpK; idx += kFpThreads) {
      int r = idx / kFpK, k = idx % kFpK;
      sa[k][r] = (r < tile.rows && k0 + k < K)
                     ? x[(long long)(tile.row0 + r) * K + k0 + k] : 0.f;
    }
    for (int idx = t; idx < kFpK * kTileN; idx += kFpThreads) {
      int k = idx / kTileN, c = idx % kTileN;
      sb[k][c] = (k0 + k < K && n0 + c < N)
                     ? wg[(long long)(k0 + k) * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFpK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sa[k][tr + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sb[k][tc + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (tr + i < tile.rows && n0 + tc + j < N)
        out[(long long)(tile.row0 + tr + i) * N + n0 + tc + j] = acc[i][j];
}

// Row-tile slots of the grid's y: an upper bound of sum_e ceil(size_e / 64)
long long tile_slots(long long rows, int groups) {
  return (rows + kTileM - 1) / kTileM + (groups < rows ? groups : rows);
}

template <typename T>
cudaError_t launch_tc(const void* x, const void* w, const int* offsets,
                      void* out, long long rows, int K, int N, int groups,
                      bool vec, cudaStream_t st) {
  dim3 grid((N + kTileN - 1) / kTileN, (unsigned)tile_slots(rows, groups));
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (vec)
    grouped_mm_tc_kernel<T, true><<<grid, kTcThreads, 0, st>>>(
        xt, wt, offsets, ot, rows, K, N, groups);
  else
    grouped_mm_tc_kernel<T, false><<<grid, kTcThreads, 0, st>>>(
        xt, wt, offsets, ot, rows, K, N, groups);
  return cudaGetLastError();
}

}  // namespace

// out [rows, N] = the grouped product of x [rows, K] and w [groups, K, N]
// over the groups' cumulative ends `offsets` [groups] (int32, on the card);
// dtype codes 0 fp32 (the CUDA-core kernel), 1 bf16, 2 fp16 (tensor cores).
// `vec`: K and N multiples of 8 and x, w 16-byte aligned (bf16/fp16 take
// 16-byte loads). Returns a CUDA error code (0: launched).
extern "C" int ds_grouped_mm(const void* x, const void* w, const void* offsets,
                             void* out, int dtype, long long rows, int K,
                             int N, int groups, int vec, void* stream) {
  if (rows <= 0 || N <= 0) return 0;
  if (K <= 0 || groups <= 0 || tile_slots(rows, groups) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* offs = static_cast<const int*>(offsets);
  if (dtype == 1)
    return (int)launch_tc<__nv_bfloat16>(x, w, offs, out, rows, K, N, groups,
                                         vec != 0, st);
  if (dtype == 2)
    return (int)launch_tc<__half>(x, w, offs, out, rows, K, N, groups,
                                  vec != 0, st);
  if (dtype == 0) {
    dim3 grid((N + kTileN - 1) / kTileN, (unsigned)tile_slots(rows, groups));
    grouped_mm_fp32_kernel<<<grid, kFpThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), offs,
        static_cast<float*>(out), rows, K, N, groups);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// Message of a code returned above.
extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
