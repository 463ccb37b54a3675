// Grouped matrix product over expert-sorted rows, for Hopper:
//   out[r, :] = x[r, :] @ w[e(r)]      e(r): the group whose rows hold r
// x [R, K] (the rows sorted by expert), w [E, K, N], offsets [E] int32 the
// groups' cumulative ends (offsets[E-1] == R; an empty group repeats the
// previous end), out [R, N]; bf16, fp16 or fp32, every sum in fp32, the
// result rounded once to the input's type. w may instead be int8 codes with
// per-column scales [E, 1, N] (fp32, bf16 or fp16): each weight value is
// then formed as ops/quantization.py `dequantize_weight` forms it (the scale
// rounded to x's type, the fp32 product of code and scale rounded once to
// x's type), so the products see the bits of the dequantized tensor.
//
// It replaces no Pallas kernel: the JAX package computes this with XLA's
// `lax.ragged_dot` (deepspeed_tpu/moe/sharded_moe.py:163-177, the serving
// MoE's sort-by-expert form), into whose operand read XLA fuses the int8
// experts' dequantization (`dequantize_experts`). The port needs a product
// that reads the group offsets on the device, so that no group size comes
// back to the host and a CUDA graph captures the MoE layer, and that reads
// the int8 experts itself, so that no dequantized copy is written
// (deepspeed_tpu_torch/moe/sharded_moe.py `moe_ffn_grouped`).
//
// What bounds it on an H100, and the design. Two forms, picked on the host
// from R, E, K and N alone (ops/grouped_gemm.py `kernel_plan`: the decode
// form while the groups hold at most 16 rows on average, a switch measured
// by chip_smoke.py's form sweep):
//
// * "decode" (a few rows a group, as at a decode step): bytes. Every weight
//   of every expert that holds a row has to come from HBM once, and the rows
//   are too few to keep the tensor cores busy. The operands are swapped: the
//   expert's weight columns are wgmma's 64-row A operand (MN-major, 128
//   columns a tile) and the group's rows its N (8, 16 or 32 rows a tile),
//   out^T = w^T x^T, so each weight byte is read once a row tile and no
//   fragment is mostly zeros. The consumers take two stages a step (half
//   the barrier waits and fences a stage); a ring of ten stages (twelve for
//   int8) keeps 80-200 KB of weights in flight a block.
// * "prefill" (many rows a group): operations. Tiles of 128 rows x 256
//   columns (x the K-major A operand, w the MN-major B operand), two
//   consumer warpgroups of 64 rows each, m64n256k16 products into 128 fp32
//   accumulators a thread (registers moved to them from the producer
//   warpgroup with setmaxnreg), a four-stage ring. A tile's row tiles share
//   a column slab, so the slab is read from HBM about once and from L2
//   after. The epilogue goes through shared memory: a warpgroup writes 64
//   columns of its 64 rows at a time into a swizzled staging tile and
//   stores whole 16-byte chunks, a warp's stores covering whole rows (the
//   fragment's own 4-byte stores took a quarter of a short tile's time).
//
// Both forms: a persistent grid of one block an SM walks the list of
// (group, column tile, row tile) tiles, the row tiles of a column slab next
// to each other. Each block builds the list from the device offsets first
// (a warp's scans over E <= 256 groups into shared memory: each group's
// first row, end and first tile), so nothing is read back to the host and a
// graph captures the call. A producer thread keeps the ring in flight with
// TMA (tensor maps over x [R, K] and w [E, K, N], 64-deep K steps, 128-byte
// swizzle, zero fill past R, K and N) and mbarriers (full: complete_tx;
// empty: one arrival a consumer warpgroup); the consumers wait on a stage,
// issue its four k16 wgmma products, keep one step's products in flight
// and release the step before. Rows of a tile past its group's end are
// loaded (they belong to the next group or lie past R, zeros) and never
// stored.
//
// int8 weights: the ring's stage holds the codes (1 byte an element, the
// whole saving in HBM bytes), and the consumers convert each stage into a
// 2-byte operand tile in shared memory, which wgmma reads as it reads a
// 2-byte stage. The conversion is in shared memory and not in registers
// because it serves both forms with one code path: the prefill form's
// weights are wgmma's B operand, which only shared memory can hold, and
// the decode form's swapped A operand would need a transposing gather of
// single bytes to build register fragments. A thread converts 16 columns
// of two or four rows a stage (their 16 scales, rounded to x's type, kept
// in registers for the tile): one 16-byte load; the codes made exact
// 2-byte values by magic numbers (fp16: the byte under a 1024 exponent,
// less 1152, one byte permute and one half2 subtraction for two codes;
// bf16: the fp32 2^23 trick, whose exact integer's top half is its bf16);
// one half2 / bfloat162 product a pair, rounded once; two 16-byte stores
// into the swizzled tile, without bank conflicts on either side (eight
// neighbouring threads take eight rows of one 16-byte column). In the
// decode form each consumer warpgroup converts the 64 columns it
// multiplies (two warpgroups, so twice the threads convert a stage), and
// waits on its own warps only.
//
// fp32 stays on the CUDA cores (exact fp32 products, no TF32: the MoE
// families are held in fp32 against the CPU): 256 threads a 64 x 64 tile,
// 4 x 4 outputs each, a block a (row tile, column tile) found from the
// offsets by a scan. bf16 and fp16 take the same kernel where the shapes
// do not allow TMA (K or N not a multiple of 8, or of 16 for int8 N; an
// operand off a 16-byte boundary) or the groups are more than 256.

#include <cuda.h>
#include <type_traits>

#include "hopper_tiles.cuh"

namespace {

constexpr int kBK = 64;                 // K depth of a stage: 128 B of x
constexpr int kAtomBytes = kBK * 128;   // a [64-row x 128-byte] swizzle column
constexpr int kMaxGroups = 256;

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of `parity` to complete. A wait past kHangCycles
// (seconds) traps, so a stage that never arrives fails the launch instead
// of holding the card.
constexpr long long kHangCycles = 1LL << 35;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_test(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_test(bar, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// TMA tile loads into shared memory, completing on `bar`
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// a named barrier of the consumer warps (ids 1..3; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// MN-major operand of swizzle columns (atoms) of [64 K rows x 64 elements]
// kAtomBytes apart: 8-row K groups 1024 bytes apart (SBO), atoms along MN
// kAtomBytes apart (LBO); `addr` the first atom advanced 2048 bytes a k16
// slice.
__device__ __forceinline__ uint64_t desc_mn_atoms(uint32_t addr) {
  return make_desc(addr, kAtomBytes, 1024, 1);
}

// The operands of wgmma m64nNk16 for N = 8, 16, 32, 256: the N / 2
// fp32 accumulators of a thread (GG_D, GG_REGS), then the descriptors of
// A and B and the scale-d flag (GG_TAIL, GG_SETP).
#define GG_F8(o)                                                    \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),    \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define GG_D8 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define GG_D16 GG_F8(0)
#define GG_D32 GG_F8(0), GG_F8(8)
#define GG_D256 \
  GG_F8(0), GG_F8(8), GG_F8(16), GG_F8(24), \
  GG_F8(32), GG_F8(40), GG_F8(48), GG_F8(56), \
  GG_F8(64), GG_F8(72), GG_F8(80), GG_F8(88), \
  GG_F8(96), GG_F8(104), GG_F8(112), GG_F8(120)
#define GG_REGS8 \
  "{%0, %1, %2, %3}"
#define GG_TAIL8 ", %4, %5, p, 1, 1, "
#define GG_SETP8 "setp.ne.b32 p, %6, 0;\n"
#define GG_REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define GG_TAIL16 ", %8, %9, p, 1, 1, "
#define GG_SETP16 "setp.ne.b32 p, %10, 0;\n"
#define GG_REGS32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15}"
#define GG_TAIL32 ", %16, %17, p, 1, 1, "
#define GG_SETP32 "setp.ne.b32 p, %18, 0;\n"
#define GG_REGS256 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define GG_TAIL256 ", %128, %129, p, 1, 1, "
#define GG_SETP256 "setp.ne.b32 p, %130, 0;\n"

// D[64, N] (+)= A[64, 16] B[16, N], both operands in shared memory; TA, TB:
// A, B MN-major (1) or K-major (0); scale_d 0 overwrites D.
template <int N, typename T, int TA, int TB> struct Mma;

#define GG_MMA(N, TYPE, TS, TA, TB)                                          \
  template <> struct Mma<N, TYPE, TA, TB> {                                  \
    __device__ static __forceinline__ void ss(float* d, uint64_t a,          \
                                              uint64_t b, int scale_d) {     \
      asm volatile("{\n.reg .pred p;\n" GG_SETP##N                           \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TS      \
                   "." TS " " GG_REGS##N GG_TAIL##N #TA ", " #TB ";\n}\n"    \
                   : GG_D##N                                                 \
                   : "l"(a), "l"(b), "r"(scale_d));                          \
    }                                                                        \
  };
#define GG_MMA_TYPE(TYPE, TS)                                                \
  GG_MMA(8, TYPE, TS, 1, 0)                                                  \
  GG_MMA(16, TYPE, TS, 1, 0)                                                 \
  GG_MMA(32, TYPE, TS, 1, 0)                                                 \
  GG_MMA(256, TYPE, TS, 0, 1)
GG_MMA_TYPE(__nv_bfloat16, "bf16")
GG_MMA_TYPE(__half, "f16")

// ------------------------------------------------------- the tile list
// Group e holds rows [row_start[e], row_end[e]) and tiles [tiles_before[e],
// tiles_before[e + 1]) of the list; tiles_before[E] is the list's length.
struct Schedule {
  int tiles_before[kMaxGroups + 1];
  int row_start[kMaxGroups];
  int row_end[kMaxGroups];
};

// Warp 0 fills the schedule from the device offsets: each group's end
// clamped to [0, R], its start the largest end before it (so a decreasing
// offset makes an empty group), ceil(rows / tile_rows) row tiles times
// col_tiles column tiles. Lane l takes groups [l per, l per + per).
__device__ void build_schedule(Schedule& s, const int* offsets, int groups,
                               long long total_rows, int tile_rows,
                               int col_tiles) {
  const int lane = threadIdx.x % 32;
  const int per = (groups + 31) / 32;
  const int e0 = lane * per;
  int ends[8];
  int lane_max = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = e0 + i;
    long long end = 0;
    if (i < per && e < groups) {
      end = offsets[e];
      end = end < 0 ? 0 : end > total_rows ? total_rows : end;
    }
    ends[i] = (int)end;
    lane_max = max(lane_max, ends[i]);
  }
  int run = lane_max;      // inclusive max over lanes 0..lane
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, run, o);
    if (lane >= o) run = max(run, v);
  }
  int start = __shfl_up_sync(kFull, run, 1);
  if (lane == 0) start = 0;
  int starts[8], tiles[8];
  int lane_tiles = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    starts[i] = start;
    const int size = max(ends[i] - start, 0);
    tiles[i] = (size + tile_rows - 1) / tile_rows * col_tiles;
    lane_tiles += tiles[i];
    start = max(start, ends[i]);
  }
  int sum = lane_tiles;    // inclusive sum over lanes 0..lane
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, sum, o);
    if (lane >= o) sum += v;
  }
  int before = sum - lane_tiles;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = e0 + i;
    if (i < per && e < groups) {
      s.tiles_before[e] = before;
      s.row_start[e] = starts[i];
      s.row_end[e] = starts[i] + max(ends[i] - starts[i], 0);
      before += tiles[i];
    }
  }
  if (lane == 31) s.tiles_before[groups] = sum;
}

struct TileAt {
  int group, row0, rows, col0;
};

// Tile t of the list (t < its length): the group by a binary search (the
// last group whose first tile is at or before t: the one with tiles), then
// its column tile and row tile, the row tiles of a column next to each
// other.
__device__ __forceinline__ TileAt tile_at(const Schedule& s, int groups,
                                          int t, int tile_rows,
                                          int tile_cols) {
  int lo = 0, hi = groups - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s.tiles_before[mid] <= t) lo = mid;
    else hi = mid - 1;
  }
  TileAt r;
  r.group = lo;
  const int start = s.row_start[lo], end = s.row_end[lo];
  const int row_tiles = (end - start + tile_rows - 1) / tile_rows;
  const int local = t - s.tiles_before[lo];
  const int ct = local / row_tiles, rt = local - ct * row_tiles;
  r.row0 = start + rt * tile_rows;
  r.rows = min(tile_rows, end - r.row0);
  r.col0 = ct * tile_cols;
  return r;
}

// ----------------------------------------------------- the wgmma kernel
// kDecode: the swapped decode form (kRowsTile 8/16/32 rows, kBN weight
// columns split over kWGs warpgroups) or the prefill form (kRowsTile = 64
// kWGs rows, kBN columns a warpgroup). kW8: int8 weights with scales.
// The prefill form's epilogue goes through shared memory: a warpgroup
// writes its 64 rows kEpCols columns at a time (16-byte chunks XOR-swizzled
// by row, so the fragment's scattered 4-byte writes meet no bank twice),
// then stores whole 16-byte chunks, a warp's stores covering whole rows.
template <bool kW8, bool kDecode, int kRowsTile, int kBN, int kStages,
          int kWGs>
struct Cfg {
  static constexpr int kThreads = 128 * (kWGs + 1);
  static constexpr int kConsumers = 128 * kWGs;
  static constexpr int kXBytes = kRowsTile * 128;     // [rows x 64] 2-byte x
  static constexpr int kWBytes = kW8 ? kBN * kBK : kBN * kBK * 2;
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kBoxCols = kW8 ? 128 : 64;     // columns a TMA box
  static constexpr int kConvBytes = kBN * kBK * 2;    // a 2-byte weight tile
  // the decode form takes two stages a step (half the waits, barriers
  // and fences a stage; the conversions of two stages overlap)
  static constexpr int kPer = kDecode ? 2 : 1;
  // 2-byte weight tiles the conversion writes in turn: a tile is written
  // again two steps later, after the wgmma wait of the step between (the
  // decode form's warpgroups each convert their own columns) or, where the
  // two prefill warpgroups share the tile, three
  static constexpr int kConvs = kW8 ? (kDecode ? 2 * kPer : 3) : 0;
  static constexpr int kEpCols = kDecode ? 0 : 64;
  static constexpr int kEpBytes = kDecode ? 0 : kWGs * 64 * kEpCols * 2;
  static constexpr int kHeader =
      (2 * kStages * 8 + (int)sizeof(Schedule) + 1023) / 1024 * 1024;
  static constexpr int kSmem = 1024 + kHeader + kStages * kStageBytes +
                               kConvs * kConvBytes + kEpBytes;
  static constexpr int kParts = kDecode ? kBN / kWGs / 64 : 1;
  static constexpr int kAcc = kDecode ? kParts * kRowsTile / 2 : kBN / 2;
  // two consumer warpgroups of 128 accumulators a thread: registers moved
  // from the producer warpgroup (40 a thread) to them (232)
  static constexpr bool kRebalance = kWGs == 2 && kAcc >= 128;
  // int8 conversion: 16-column units, kRowLanes threads a unit. In the
  // decode form each warpgroup converts the 64 columns it multiplies, so
  // it waits on its own warps only (named barrier 1 + warpgroup)
  static constexpr int kUnits = kBN / 16;
  static constexpr int kRowLanes = kConsumers / kUnits;
  static constexpr int kSyncThreads = kDecode ? 128 : kConsumers;
  static_assert(kRowsTile % 8 == 0 && kBN % kBoxCols == 0, "tile shape");
  static_assert(!kW8 || (kRowLanes % 8 == 0 && kBK % kRowLanes == 0),
                "the conversion's thread layout");
  static_assert(!kW8 || !kDecode || kParts == 1,
                "a decode warpgroup converts the columns it multiplies");
  static_assert(kSmem <= 232448, "shared memory of a block");
};

// Scales of columns n0 .. n0 + 15 of group e, each rounded to T, packed
// in pairs (0 past N).
template <typename T>
__device__ __forceinline__ void load_scales(uint32_t (&sc)[8],
                                            const void* scales, int type,
                                            int e, int n0, int N) {
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const long long idx = (long long)e * N + n0 + i;
    v[i] = 0.f;
    if (n0 + i < N && type == 0)
      v[i] = static_cast<const float*>(scales)[idx];
    else if (n0 + i < N && type == 1)
      v[i] = __bfloat162float(static_cast<const __nv_bfloat16*>(scales)[idx]);
    else if (n0 + i < N)
      v[i] = __half2float(static_cast<const __half*>(scales)[idx]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) sc[i] = Num<T>::pack(v[2 * i], v[2 * i + 1]);
}

// Two values of T in a register, multiplied (each product rounded once)
template <typename T>
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  using T2 = typename std::conditional<std::is_same<T, __half>::value,
                                       __half2, __nv_bfloat162>::type;
  T2 r = __hmul2(*reinterpret_cast<const T2*>(&a),
                 *reinterpret_cast<const T2*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Four int8 codes (one register) as two pairs of exact T values: fp16 by
// the byte under a 1024 exponent (0x64 high byte: 1024 + code + 128) less
// 1152; bf16 through the fp32 2^23 magic, whose exact integer's top half
// is its bf16.
template <typename T>
__device__ __forceinline__ void codes4(uint32_t word, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t v = word ^ 0x80808080u;           // code + 128, unsigned
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 bias = __halves2half2(__ushort_as_half(0x6480),
                                        __ushort_as_half(0x6480));
    const uint32_t pa = __byte_perm(v, 0x64646464u, 0x4140);
    const uint32_t pb = __byte_perm(v, 0x64646464u, 0x4342);
    const __half2 a = __hsub2(*reinterpret_cast<const __half2*>(&pa), bias);
    const __half2 b = __hsub2(*reinterpret_cast<const __half2*>(&pb), bias);
    lo = *reinterpret_cast<const uint32_t*>(&a);
    hi = *reinterpret_cast<const uint32_t*>(&b);
  } else {
    uint32_t f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __float_as_uint(
          __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440u + b)) -
          8388736.f);
    lo = __byte_perm(f[0], f[1], 0x7632);
    hi = __byte_perm(f[2], f[3], 0x7632);
  }
}

// One stage's int8 weight tile [64 x kBN] (128-column swizzled atoms at
// `src`) into the 2-byte tile at `dst` (64-column swizzled atoms, the
// layout TMA gives a 2-byte stage): this thread's 16-column unit, rows
// lane_row + kRowLanes i; each value the code times its column's scale
// (both exact in T), rounded once.
template <typename T, int kRowLanes>
__device__ __forceinline__ void convert_stage(const uint8_t* src,
                                              uint8_t* dst,
                                              const uint32_t (&sc)[8],
                                              int unit, int lane_row) {
  const int a_src = unit / 8, c_src = unit % 8;
  const int a_dst = unit / 4, c_dst = 2 * (unit % 4);
  constexpr int kRows = kBK / kRowLanes;
  uint4 q[kRows];       // every row's codes first: the loads overlap
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = lane_row + i * kRowLanes;
    q[i] = *reinterpret_cast<const uint4*>(src + a_src * kAtomBytes +
                                           r * 128 + ((c_src ^ (r % 8)) << 4));
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = lane_row + i * kRowLanes;
    const int x8 = r % 8;
    const uint32_t words[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
    uint32_t packed[8];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t lo, hi;
      codes4<T>(words[w], lo, hi);
      packed[2 * w] = mul2<T>(lo, sc[2 * w]);
      packed[2 * w + 1] = mul2<T>(hi, sc[2 * w + 1]);
    }
    uint8_t* row = dst + a_dst * kAtomBytes + r * 128;
    *reinterpret_cast<uint4*>(row + ((c_dst ^ x8) << 4)) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
    *reinterpret_cast<uint4*>(row + (((c_dst + 1) ^ x8) << 4)) =
        make_uint4(packed[4], packed[5], packed[6], packed[7]);
  }
}

// The four k16 products of a stage: x tile at `xs`, 2-byte weight tile at
// `wt`; scale-d 0 on the tile's first product.
template <typename T, bool kDecode, int kRowsTile, int kBN, int kParts,
          int kAcc>
__device__ __forceinline__ void mma_stage(float (&acc)[kAcc], uint32_t xs,
                                          uint32_t wt, int wg,
                                          bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const int scale_d = (accumulate || kk > 0) ? 1 : 0;
    if constexpr (kDecode) {
      const uint64_t b = desc_k<64>(xs, kRowsTile, 0, kk);
#pragma unroll
      for (int p = 0; p < kParts; ++p)
        Mma<kRowsTile, T, 1, 0>::ss(
            acc + p * (kRowsTile / 2),
            desc_mn_atoms(wt + (wg * kParts + p) * kAtomBytes + kk * 2048),
            b, scale_d);
    } else {
      Mma<kBN, T, 0, 1>::ss(acc, desc_k<64>(xs, kRowsTile, 64 * wg, kk),
                            desc_mn_atoms(wt + kk * 2048), scale_d);
    }
  }
}

// The prefill form's stores of one warpgroup's 64 rows of a tile (from
// row `row0`; the first `rows` of them stored, columns past N not) through
// its staging area `ep`, kEpCols columns a pass. The swizzle of a row
// depends on it modulo 8 only, which each thread's rows share, so every
// address is a fixed offset from one base a thread.
template <typename T, int kBN, int kEpCols, int kAcc>
__device__ __forceinline__ void store_tile(const float (&acc)[kAcc],
                                           uint8_t* ep, int warp, int lane,
                                           T* out, long long row0, int rows,
                                           int col0, int N) {
  constexpr int kChunks = kEpCols / 8;             // 16-byte chunks a row
  constexpr int kRowBytes = kEpCols * 2;
  constexpr int kRowsPerLine = 128 / kRowBytes;
  constexpr int kStep = 128 / kChunks;             // rows between reads
  const int t = threadIdx.x % 128;
  const int bar = 3 + threadIdx.x / 128;           // 4 + the warpgroup
  // writes: fragment rows wr and wr + 8, 4 bytes at column pair lane % 4
  const int wr = 16 * warp + lane / 4;
  const int wx = (wr / kRowsPerLine) % kChunks;
  uint8_t* const wbase = ep + wr * kRowBytes + 4 * (lane % 4);
  // reads: rows rr + kStep k, 16-byte chunk rc
  const int rr = t / kChunks, rc = t % kChunks;
  const int rx = (rr / kRowsPerLine) % kChunks;
  const uint8_t* const rbase = ep + rr * kRowBytes + ((rc ^ rx) << 4);
  T* const gbase = out + (row0 + rr) * N + col0 + 8 * rc;
  const long long gstep = (long long)kStep * N;
  // one loop over the accumulator (constant indices once unrolled), each
  // pass's stores after its last write
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    constexpr int kPerPass = kEpCols / 2;          // accumulators a pass
    const int pass = i / kPerPass;
    const int j = (i >> 2) - pass * kChunks;
    *reinterpret_cast<uint32_t*>(wbase + ((i >> 1) & 1) * 8 * kRowBytes +
                                 ((j ^ wx) << 4)) =
        Num<T>::pack(acc[i], acc[i + 1]);
    if (i % kPerPass == kPerPass - 2) {
      consumers_sync(bar, 128);
      const bool col_ok = col0 + pass * kEpCols + 8 * rc < N;
#pragma unroll
      for (int k = 0; k < 64 / kStep; ++k)
        if (col_ok && rr + kStep * k < rows)
          *reinterpret_cast<uint4*>(gbase + k * gstep + pass * kEpCols) =
              *reinterpret_cast<const uint4*>(rbase + k * kStep * kRowBytes);
      consumers_sync(bar, 128);       // read before the next pass writes
    }
  }
}

template <typename T, bool kW8, bool kDecode, int kRowsTile, int kBN,
          int kStages, int kWGs>
__global__ void __launch_bounds__(128 * (kWGs + 1), 1)
grouped_mm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_w,
                        const int* __restrict__ offsets,
                        const void* __restrict__ scales, int scale_type,
                        T* __restrict__ out, long long total_rows, int K,
                        int N, int groups) {
  using C = Cfg<kW8, kDecode, kRowsTile, kBN, kStages, kWGs>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  Schedule& sched = *reinterpret_cast<Schedule*>(gbase + 2 * kStages * 8);
  const uint32_t full0 = base, empty0 = base + kStages * 8;
  const uint32_t ring = base + C::kHeader;
  const uint32_t conv = ring + kStages * C::kStageBytes;
  uint8_t* const gring = gbase + C::kHeader;
  uint8_t* const gconv = gring + kStages * C::kStageBytes;
  uint8_t* const gep = gconv + C::kConvs * C::kConvBytes;
  const int col_tiles = (N + kBN - 1) / kBN;

  if (threadIdx.x < 32)
    build_schedule(sched, offsets, groups, total_rows, kRowsTile, col_tiles);
  if (threadIdx.x == 32) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total = sched.tiles_before[groups];
  // stages a tile, a whole number of steps (a stage past K loads zeros)
  const int nk = (K + kBK * C::kPer - 1) / (kBK * C::kPer) * C::kPer;

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues the stages' TMA loads
    if constexpr (C::kRebalance)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const TileAt tl = tile_at(sched, groups, t, kRowsTile, kBN);
        for (int kb = 0; kb < nk; ++kb) {
          const uint32_t full = full0 + 8 * stage;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect(full, C::kStageBytes);
          const uint32_t xs = ring + stage * C::kStageBytes;
          tma_2d(xs, &map_x, kb * kBK, tl.row0, full);
#pragma unroll
          for (int b = 0; b < kBN / C::kBoxCols; ++b)
            tma_3d(xs + C::kXBytes + b * kAtomBytes, &map_w,
                   tl.col0 + b * C::kBoxCols, kb * kBK, tl.group, full);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups
    if constexpr (C::kRebalance)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ct = threadIdx.x - 128;
    const int wg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
    const int unit = ct / C::kRowLanes, lane_row = ct % C::kRowLanes;
    int stage = 0, conv_i = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const TileAt tl = tile_at(sched, groups, t, kRowsTile, kBN);
      uint32_t sc[8];
      if constexpr (kW8)
        load_scales<T>(sc, scales, scale_type, tl.group,
                       tl.col0 + 16 * unit, N);
      float acc[C::kAcc];
      int held[C::kPer];    // the last step's stages, products in flight
      for (int kb = 0; kb < nk; kb += C::kPer) {
        uint32_t xs[C::kPer], wt[C::kPer];
        int cur[C::kPer];
#pragma unroll
        for (int u = 0; u < C::kPer; ++u) {
          cur[u] = stage;
          xs[u] = ring + stage * C::kStageBytes;
          wt[u] = xs[u] + C::kXBytes;
          mbar_wait(full0 + 8 * stage, phase);
          if constexpr (kW8) {
            convert_stage<T, C::kRowLanes>(
                gring + stage * C::kStageBytes + C::kXBytes,
                gconv + conv_i * C::kConvBytes, sc, unit, lane_row);
            wt[u] = conv + conv_i * C::kConvBytes;
            conv_i = conv_i == C::kConvs - 1 ? 0 : conv_i + 1;
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        if constexpr (kW8) {
          proxy_fence();
          consumers_sync(kDecode ? 1 + wg : 1, C::kSyncThreads);
        }
        wg_arrive();
#pragma unroll
        for (int u = 0; u < C::kPer; ++u)
          mma_stage<T, kDecode, kRowsTile, kBN, C::kParts, C::kAcc>(
              acc, xs[u], wt[u], wg, kb + u > 0);
        wg_commit();
        wg_wait_n<1>();
        // the last step's products are done: release its stages
#pragma unroll
        for (int u = 0; u < C::kPer; ++u) {
          if (kb > 0 && ct % 128 == 0) mbar_arrive(empty0 + 8 * held[u]);
          held[u] = cur[u];
        }
      }
      wg_wait_n<0>();
      fence_regs(acc);
#pragma unroll
      for (int u = 0; u < C::kPer; ++u)
        if (ct % 128 == 0) mbar_arrive(empty0 + 8 * held[u]);
      if constexpr (kDecode) {
        // acc[p][i]: weight column 64 (wg kParts + p) + m, tile row rr
        constexpr int kPer = kRowsTile / 2;
        const int mbase = 16 * warp + lane / 4;
#pragma unroll
        for (int p = 0; p < C::kParts; ++p)
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int m = mbase + 8 * ((i >> 1) & 1);
            const int rr = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
            const int c = tl.col0 + (wg * C::kParts + p) * 64 + m;
            if (rr < tl.rows && c < N)
              Num<T>::store(out + (long long)(tl.row0 + rr) * N + c,
                            acc[p * kPer + i]);
          }
      } else {
        // a warpgroup whose rows all lie past the group's end (a group's
        // last row tile) stores nothing
        if (64 * wg < tl.rows)
          store_tile<T, kBN, C::kEpCols, C::kAcc>(
              acc, gep + wg * (64 * C::kEpCols * 2), warp, lane, out,
              tl.row0 + 64 * wg, tl.rows - 64 * wg, tl.col0, N);
      }
    }
  }
}

// ------------------------------------------------------------- CUDA cores
constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kFpThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kFpK = 16;

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

// Element (k, n) of group e's weight as a float: T itself, or an int8 code
// times its column's scale, each rounded as dequantize_weight rounds them.
template <typename T, bool kW8>
__device__ __forceinline__ float weight_at(const void* w, const void* scales,
                                           int scale_type, long long at,
                                           long long scale_at) {
  if constexpr (kW8) {
    const float s =
        scale_type == 0 ? static_cast<const float*>(scales)[scale_at]
        : scale_type == 1
            ? __bfloat162float(
                  static_cast<const __nv_bfloat16*>(scales)[scale_at])
            : __half2float(static_cast<const __half*>(scales)[scale_at]);
    return Num<T>::round((float)static_cast<const int8_t*>(w)[at] *
                         Num<T>::round(s));
  } else {
    return Num<T>::load(static_cast<const T*>(w) + at);
  }
}

template <typename T, bool kW8>
__global__ void __launch_bounds__(kFpThreads)
grouped_mm_cuda_cores_kernel(const T* __restrict__ x,
                             const void* __restrict__ w,
                             const int* __restrict__ offsets,
                             const void* __restrict__ scales, int scale_type,
                             T* __restrict__ out, long long total_rows, int K,
                             int N, int groups) {
  const TileOf tile = find_tile(offsets, groups, total_rows);
  if (tile.group < 0) return;
  const int n0 = blockIdx.x * kTileN;
  const long long wg = (long long)tile.group * K * N;
  __shared__ float sa[kFpK][kTileM + 4];   // A transposed: k-major
  __shared__ float sb[kFpK][kTileN];
  const int t = threadIdx.x;
  const int tr = (t / 16) * 4, tc = (t % 16) * 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFpK) {
    for (int idx = t; idx < kTileM * kFpK; idx += kFpThreads) {
      int r = idx / kFpK, k = idx % kFpK;
      sa[k][r] = (r < tile.rows && k0 + k < K)
                     ? Num<T>::load(x + (long long)(tile.row0 + r) * K + k0 +
                                    k)
                     : 0.f;
    }
    for (int idx = t; idx < kFpK * kTileN; idx += kFpThreads) {
      int k = idx / kTileN, c = idx % kTileN;
      sb[k][c] = (k0 + k < K && n0 + c < N)
                     ? weight_at<T, kW8>(
                           w, scales, scale_type,
                           wg + (long long)(k0 + k) * N + n0 + c,
                           (long long)tile.group * N + n0 + c)
                     : 0.f;
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
        Num<T>::store(out + (long long)(tile.row0 + tr + i) * N + n0 + tc + j,
                      acc[i][j]);
}

// Row-tile slots of the grid's y: an upper bound of sum_e ceil(size_e / 64)
long long tile_slots(long long rows, int groups) {
  return (rows + kTileM - 1) / kTileM + (groups < rows ? groups : rows);
}

template <typename T, bool kW8>
cudaError_t launch_cuda_cores(const void* x, const void* w, const int* offs,
                              const void* scales, int scale_type, void* out,
                              long long rows, int K, int N, int groups,
                              cudaStream_t st) {
  if (tile_slots(rows, groups) > 65535) return cudaErrorInvalidValue;
  dim3 grid((N + kTileN - 1) / kTileN, (unsigned)tile_slots(rows, groups));
  grouped_mm_cuda_cores_kernel<T, kW8><<<grid, kFpThreads, 0, st>>>(
      static_cast<const T*>(x), w, offs, scales, scale_type,
      static_cast<T*>(out), rows, K, N, groups);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// lookup (the library is not linked)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

bool make_map(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
              const void* ptr, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return counts[dev];
}

template <typename T, bool kW8, bool kDecode, int kRowsTile, int kBN,
          int kStages, int kWGs>
cudaError_t launch_wgmma(const void* x, const void* w, const int* offs,
                         const void* scales, int scale_type, void* out,
                         long long rows, int K, int N, int groups,
                         cudaStream_t st) {
  using C = Cfg<kW8, kDecode, kRowsTile, kBN, kStages, kWGs>;
  auto kernel =
      grouped_mm_wgmma_kernel<T, kW8, kDecode, kRowsTile, kBN, kStages, kWGs>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = allow_smem(kernel, C::kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const CUtensorMapDataType xt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t xstrides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xbox[2] = {kBK, kRowsTile};
  const cuuint64_t item = kW8 ? 1 : 2;
  const cuuint64_t wdims[3] = {(cuuint64_t)N, (cuuint64_t)K,
                               (cuuint64_t)groups};
  const cuuint64_t wstrides[2] = {(cuuint64_t)N * item,
                                  (cuuint64_t)K * N * item};
  const cuuint32_t wbox[3] = {(cuuint32_t)C::kBoxCols, kBK, 1};
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, xt, 2, x, xdims, xstrides, xbox) ||
      !make_map(&map_w, kW8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : xt, 3, w, wdims,
                wstrides, wbox))
    return cudaErrorInvalidValue;
  const long long tiles =
      ((rows + kRowsTile - 1) / kRowsTile + (groups < rows ? groups : rows)) *
      ((N + kBN - 1) / kBN);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  kernel<<<grid, C::kThreads, C::kSmem, st>>>(
      map_x, map_w, offs, scales, scale_type, static_cast<T*>(out), rows, K,
      N, groups);
  return cudaGetLastError();
}

// The wgmma forms of one 2-byte type: form 1 prefill (two warpgroups of
// 64 rows x 256 columns), 2 decode with tile_rows 8, 16 or 32 (int8
// weights: two warpgroups of 64 columns each, so twice the threads convert
// a stage).
template <typename T, bool kW8>
cudaError_t launch_form(int form, int tile_rows, const void* x, const void* w,
                        const int* offs, const void* scales, int scale_type,
                        void* out, long long rows, int K, int N, int groups,
                        cudaStream_t st) {
  constexpr int kPrefillStages = kW8 ? 3 : 4;
  // int8 stages hold half the bytes: more of them keep as many in flight
  constexpr int kDecodeStages = kW8 ? 12 : 10;
  constexpr int kDecodeWGs = kW8 ? 2 : 1;
  if (form == 1)
    return launch_wgmma<T, kW8, false, 128, 256, kPrefillStages, 2>(
        x, w, offs, scales, scale_type, out, rows, K, N, groups, st);
  if (form == 2 && tile_rows == 8)
    return launch_wgmma<T, kW8, true, 8, 128, kDecodeStages, kDecodeWGs>(
        x, w, offs, scales, scale_type, out, rows, K, N, groups, st);
  if (form == 2 && tile_rows == 16)
    return launch_wgmma<T, kW8, true, 16, 128, kDecodeStages, kDecodeWGs>(
        x, w, offs, scales, scale_type, out, rows, K, N, groups, st);
  if (form == 2 && tile_rows == 32)
    return launch_wgmma<T, kW8, true, 32, 128, kDecodeStages, kDecodeWGs>(
        x, w, offs, scales, scale_type, out, rows, K, N, groups, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_type(int form, int tile_rows, bool w8, const void* x,
                        const void* w, const int* offs, const void* scales,
                        int scale_type, void* out, long long rows, int K,
                        int N, int groups, cudaStream_t st) {
  if (form == 0)
    return w8 ? launch_cuda_cores<T, true>(x, w, offs, scales, scale_type,
                                           out, rows, K, N, groups, st)
              : launch_cuda_cores<T, false>(x, w, offs, scales, scale_type,
                                            out, rows, K, N, groups, st);
  if constexpr (std::is_same<T, float>::value) {
    return cudaErrorInvalidValue;
  } else {
    // TMA: 16-byte aligned bases and row strides, at most kMaxGroups groups
    const int wmult = w8 ? 16 : 8;
    if (K % 8 != 0 || N % wmult != 0 || groups > kMaxGroups ||
        !aligned16(x) || !aligned16(w))
      return cudaErrorInvalidValue;
    return w8 ? launch_form<T, true>(form, tile_rows, x, w, offs, scales,
                                     scale_type, out, rows, K, N, groups, st)
              : launch_form<T, false>(form, tile_rows, x, w, offs, scales,
                                      scale_type, out, rows, K, N, groups,
                                      st);
  }
}

}  // namespace

// out [rows, N] = the grouped product of x [rows, K] and w [groups, K, N]
// over the groups' cumulative ends `offsets` [groups] (int32, on the card).
// dtype: 0 fp32, 1 bf16, 2 fp16 (x's and out's). scale_type: -1 w is of
// x's dtype; 0 fp32, 1 bf16, 2 fp16: w is int8 codes and `scales` [groups,
// 1, N] of that type. form: 0 the CUDA-core kernel (any shape); 1 the wgmma
// prefill form, 2 the wgmma decode form with tile_rows (8, 16, 32) rows a
// tile (bf16/fp16, K and N multiples of 8, N of 16 for int8, x and w 16-byte
// aligned, groups <= 256). Returns a CUDA error code (0: launched).
extern "C" int ds_grouped_mm(const void* x, const void* w, const void* offsets,
                             const void* scales, void* out, int dtype,
                             int scale_type, long long rows, int K, int N,
                             int groups, int form, int tile_rows,
                             void* stream) {
  if (rows <= 0 || N <= 0) return 0;
  if (K <= 0 || groups <= 0 || scale_type < -1 || scale_type > 2 ||
      rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* offs = static_cast<const int*>(offsets);
  const bool w8 = scale_type >= 0;
  if (dtype == 0)
    return (int)launch_type<float>(form, tile_rows, w8, x, w, offs, scales,
                                   scale_type, out, rows, K, N, groups, st);
  if (dtype == 1)
    return (int)launch_type<__nv_bfloat16>(form, tile_rows, w8, x, w, offs,
                                           scales, scale_type, out, rows, K,
                                           N, groups, st);
  if (dtype == 2)
    return (int)launch_type<__half>(form, tile_rows, w8, x, w, offs, scales,
                                    scale_type, out, rows, K, N, groups, st);
  return (int)cudaErrorInvalidValue;
}

// Message of a code returned above.
extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
