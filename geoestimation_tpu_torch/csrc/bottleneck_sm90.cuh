// The Hopper core shared by the fused-bottleneck kernels (fused_bottleneck.cu,
// stride 1; fused_bottleneck_s2.cu, stride 2). Each kernel includes it and
// supplies only its indexing: where phase 1's x tiles come from, where y1
// lands, the nine taps' offsets, and where the output goes.
//
// A work item is one image and a tile of TH output rows (or, where no such
// tile fits in shared memory, one output row and a tile of TW output
// columns); a persistent grid of blocks walks the items. A block has three
// warps' roles:
//   * one producer warp, whose lane 0 streams every K slice the consumers
//     need, in the order they need them, through a ring of 1-4 stages of
//     shared memory: the weight slice (64 input channels x the pass's output
//     channels, by TMA with the 128-byte swizzle) and, where the A operand is
//     x, the x tiles (64 pixels x 64 channels each, by TMA, same swizzle).
//     Each stage completes on its `full` mbarrier and is handed back on its
//     `empty` mbarrier (one arrival per consumer warp);
//   * two consumer warpgroups, which run wgmma m64n64k16 (bf16 in, fp32
//     accumulate, up to four 64x64 accumulator tiles a warpgroup) with B, and
//     A where it is x, by descriptor from the ring, and A from the y1 and y2
//     tiles by descriptor where it is an intermediate. The epilogues (bias,
//     relu, bf16 pack into y1 and y2; residual and store of the output) run
//     on the consumers.
//
// Layouts in shared memory:
//   * ring stage: [A: up to kMaxATiles x 8 KB][B: NC rows x 128 B], both in
//     the TMA's 128-byte swizzle, each 1024-byte aligned (wgmma layout B128,
//     K-major, 8-row groups 1024 B apart; a k16 step adds 32 B);
//   * y1 and y2: no swizzle, channel-chunk major: 8 channels (16 B) of pixel
//     i of chunk c at c * rows * 16 + i * 16. A wgmma core matrix (8 rows x
//     16 B) is then 128 contiguous bytes starting at ANY pixel, so a 3x3 tap
//     is the same tile shifted by a constant number of pixels: the taps need
//     no copy and no register-A path. Descriptor: layout INTERLEAVE, SBO =
//     128 B (next 8 pixels), LBO = rows * 16 B (next 8 channels). The 3x3
//     phase runs over padded pixel coordinates (each row of output pixels
//     has the tile's pitch, the extra columns computed and dropped).
//   Rows that a 64-row tile reads past the end of y1 or y2 land in later
//   regions of the block's shared memory and feed only dropped rows.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <algorithm>

namespace geo_sm90 {

constexpr int kConsumerThreads = 256;                 // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;       // + the producer warp
constexpr int kTileM = 64;                            // wgmma rows
constexpr int kSlice = 64;                            // channels of a K slice
constexpr int kTileBytes = kTileM * kSlice * 2;       // one 64x64 bf16 tile
constexpr int kMaxATiles = 4;                         // x tiles in a stage
constexpr int kMaxStages = 4;
constexpr int kEmptyArrivals = kConsumerThreads / 32;
constexpr size_t kMaxSmem = 227 * 1024;

// One phase's split into passes. A pass holds, per warpgroup, `mpw` m-tiles
// x `nsub` 64-column tiles (mpw * nsub <= 4) in registers while its K slices
// stream through the ring. The warpgroups split the pass's m-tiles, or with
// `split_n` share them and split its columns.
struct PhaseCfg {
  int mt;       // 64-row tiles of the phase
  int n;        // output channels of the phase
  int mpw, nsub, split_n;
  uint32_t a_off = 0;  // where B starts in a stage that holds x tiles
  __host__ __device__ int mg() const { return split_n ? mpw : 2 * mpw; }
  __host__ __device__ int nc() const { return 64 * nsub * (split_n ? 2 : 1); }
  __host__ __device__ int groups() const { return (mt + mg() - 1) / mg(); }
  __host__ __device__ int chunks() const { return n / nc(); }
};

struct Plan {
  PhaseCfg ph[3];
  int th;             // output rows of a work item
  int tw;             // output columns of a work item (the output width, or a
                      // column tile where th is 1)
  int col_tiles;      // column tiles of an output row (1: whole rows)
  int x_row_tiles;    // with column tiles: x tiles per y1 row in phase 1, each
                      // y1 row then loaded on its own (0: the y1 rows are one
                      // run of pixels)
  int tiles_per_img;  // row tiles x column tiles of an image
  int items;          // images x tiles
  int stages;         // ring stages
  int cin_slices;     // K slices of x (the last may be partly outside Cin)
  int cmid_slices;
  int pitch;          // pixels per row of a y1 plane
  int spp[3];         // B-only K slices a stage holds, per phase
  uint32_t stage_bytes;
  uint32_t y1_rows;       // pixels of the y1 plane (rows of a chunk; stride 1)
  uint32_t y2_off, y2_rows;
  uint32_t ring_off;
  uint32_t smem;          // dynamic shared memory, alignment slack included
};

struct TmaMaps {
  CUtensorMap x;    // (Cin, N*H*W), box 64 x 64 pixels
  CUtensorMap w1;   // (Cin, Cmid), box 64 x NC of phase 1
  CUtensorMap w2;   // (9*Cmid, Cmid), box 64 x NC of phase 2
  CUtensorMap w3;   // (Cmid, Cout), box 64 x NC of phase 3
  CUtensorMap wd;   // (Cin, Cout), box 64 x NC of phase 3 (projection only)
  CUtensorMap xs;   // stride-2 projection pixels (stride-2 kernel only)
};

// ---- device helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits for the phase after `parity` to complete. A ring that never
// completes (a fault in the schedule) ends the launch with an error after
// about 2^26 polls rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier of the two consumer warpgroups only (the producer never joins).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
}

// wgmma descriptor of a K-major tile in the TMA's 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// wgmma descriptor of a K-major channel-chunk-major tile with no swizzle:
// 8 pixels 16 B apart, chunks of 8 channels `chunk_bytes` apart.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t chunk_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(chunk_bytes >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d += A (64 x 16, by descriptor) . B (16 x 64, K-major, by descriptor)
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 ldg_f2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Ring position of one role; both roles walk the same sequence of slices.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Shared-memory addresses of one block (32-bit shared-window addresses).
struct Smem {
  uint32_t base;   // 1024-aligned start of the dynamic region (y1 planes)
  uint32_t y2;
  uint32_t ring;
  uint32_t full;   // mbarriers, 8 bytes apart
  uint32_t empty;
};

// The A operand of one K slice for a warpgroup's first m-tile, and how to
// step it: `m` to the next m-tile, `k` to the next k16 step (16-byte units
// of the descriptor's start address). A slice is always four k16 steps: the
// channels of a last x slice past Cin come as zeros from the TMA, in x and
// in the weights alike.
struct ADesc {
  uint64_t d;
  uint32_t m, k;
};

// A operand from the x tiles of a ring stage, slot `slot0` on.
__device__ __forceinline__ ADesc a_from_stage(uint32_t stage, int slot0) {
  return {desc_sw128(stage + slot0 * kTileBytes), kTileBytes >> 4, 2};
}

// A operand from a chunk-major tile (y1 plane or y2) of `rows` pixels,
// channels [64 ks, 64 ks + 64), starting at pixel `pix0`.
__device__ __forceinline__ ADesc a_from_plain(uint32_t tile, uint32_t rows, int ks, int pix0) {
  const uint32_t chunk = rows * 16;
  return {desc_plain(tile + ks * 8 * chunk + pix0 * 16, chunk), (kTileM * 16) >> 4,
          (2 * chunk) >> 4};
}

// The K slices of a pass go through the ring in stage groups: slices
// [0, a_first) carry no A operand (it is y1 or y2) and share a stage, up to
// `spp` of them, their B slices back to back from the stage's start; slices
// [a_first, nslices) carry x tiles and take a stage each (x tiles, then B at
// the phase's a_off).
__device__ __forceinline__ int group_len(int s, int a_first, int spp) {
  return s < a_first ? min(spp, a_first - s) : 1;
}

// The products of slices [s, s + len) of one stage, for MV m-tiles x NS
// column tiles: accumulator tile i is m-tile i / NS x column tile i % NS.
template <int MV, int NS, class ADescFn>
__device__ __forceinline__ void mma_group(float (&acc)[4][32], ADescFn& adesc, int s, int len,
                                          uint32_t st, uint32_t b_off, uint32_t b_step, int m0,
                                          int slot0) {
  for (int j = 0; j < len; ++j) {
    const ADesc a = adesc(s + j, st, m0, slot0);
    const uint64_t b0 = desc_sw128(st + b_off + j * b_step);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < MV * NS; ++i)
        wgmma_64x64x16(acc[i], a.d + (i / NS) * a.m + kk * a.k,
                       b0 + (i % NS) * (kTileBytes >> 4) + kk * 2);
  }
}

// One pass of a warpgroup with MV real m-tiles (0: it only hands the stages
// back) and NS column tiles.
template <int MV, int NS, class ADescFn>
__device__ __forceinline__ void run_pass(float (&acc)[4][32], const PhaseCfg& c, int nslices,
                                         int a_first, int spp, const Plan& pl, const Smem& sm,
                                         Ring& ring, uint32_t wg_off, ADescFn& adesc, int m0,
                                         int slot0) {
  const int lane = threadIdx.x & 31;
  const uint32_t b_step = c.nc() * 128;
  for (int s = 0; s < nslices;) {
    const int len = group_len(s, a_first, spp);
    mbar_wait(sm.full + 8 * ring.stage, ring.phase);
    const uint32_t st = sm.ring + ring.stage * pl.stage_bytes;
    wgmma_fence();
    if constexpr (MV > 0)
      mma_group<MV, NS>(acc, adesc, s, len, st, (s < a_first ? 0u : c.a_off) + wg_off, b_step,
                        m0, slot0);
    wgmma_commit();
    wgmma_wait0();
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty + 8 * ring.stage);
    ring.next(pl.stages);
    s += len;
  }
}

// Consumer side of one phase: for each pass, zero the accumulators, run its
// K slices (`adesc(s, stage_addr, m0, slot0)` gives slice s's A), then hand
// the tiles to `epi(acc, m0, mvalid, n0)` (m0: the warpgroup's first m-tile,
// n0: its first column). The pass body is compiled for each shape of the
// accumulator, so every product's registers are known to the compiler.
template <class ADescFn, class Epi>
__device__ __forceinline__ void consume_phase(const PhaseCfg& c, int nslices, int a_first,
                                              int spp, const Plan& pl, const Smem& sm,
                                              Ring& ring, int wg, ADescFn adesc, Epi epi) {
  float acc[4][32];
  for (int g = 0; g < c.groups(); ++g) {
    const int slot0 = c.split_n ? 0 : wg * c.mpw;
    const int m0 = g * c.mg() + slot0;
    const int mvalid = max(0, min(c.mpw, c.mt - m0));
    for (int ch = 0; ch < c.chunks(); ++ch) {
      const int n0 = ch * c.nc() + (c.split_n ? wg * 64 * c.nsub : 0);
      const uint32_t wg_off = c.split_n ? wg * c.nsub * kTileBytes : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[i][j] = 0.f;
#define GEO_PASS(MV, NS) \
  run_pass<MV, NS>(acc, c, nslices, a_first, spp, pl, sm, ring, wg_off, adesc, m0, slot0)
      switch (mvalid * 8 + c.nsub) {
        case 9: GEO_PASS(1, 1); break;
        case 10: GEO_PASS(1, 2); break;
        case 12: GEO_PASS(1, 4); break;
        case 17: GEO_PASS(2, 1); break;
        case 18: GEO_PASS(2, 2); break;
        case 25: GEO_PASS(3, 1); break;
        case 33: GEO_PASS(4, 1); break;
        default: GEO_PASS(0, 1); break;
      }
#undef GEO_PASS
      if (mvalid > 0) epi(acc, m0, mvalid, n0);
    }
  }
}

// Where a K slice's weights come from: the map and the column (input
// channel) coordinate; the row coordinate is the pass's first output channel.
struct BSrc {
  const CUtensorMap* map;
  int col;
};

// Producer side of one phase, in the consumers' order: for each pass and
// stage group, the B slices `bsrc(s)` gives, and for a slice with x tiles what
// `load_a(stage, bar, s, g, dry)` loads (it returns its bytes; with `dry` it
// only counts them).
template <class BSrcFn, class LoadA>
__device__ __forceinline__ void produce_phase(const PhaseCfg& c, int nslices, int a_first,
                                              int spp, const Plan& pl, const Smem& sm,
                                              Ring& ring, BSrcFn bsrc, LoadA load_a) {
  const uint32_t b_bytes = c.nc() * 128;
  for (int g = 0; g < c.groups(); ++g)
    for (int ch = 0; ch < c.chunks(); ++ch)
      for (int s = 0; s < nslices;) {
        const int len = group_len(s, a_first, spp);
        const uint32_t full = sm.full + 8 * ring.stage;
        mbar_wait(sm.empty + 8 * ring.stage, ring.phase ^ 1);
        const uint32_t st = sm.ring + ring.stage * pl.stage_bytes;
        if (s < a_first) {
          mbar_expect_tx(full, len * b_bytes);
          for (int j = 0; j < len; ++j) {
            const BSrc b = bsrc(s + j);
            tma_load_2d(st + j * b_bytes, b.map, full, b.col, ch * c.nc());
          }
        } else {
          mbar_expect_tx(full, load_a(st, full, s, g, true) + b_bytes);
          load_a(st, full, s, g, false);
          const BSrc b = bsrc(s);
          tma_load_2d(st + c.a_off, b.map, full, b.col, ch * c.nc());
        }
        ring.next(pl.stages);
        s += len;
      }
}

// No A operand in the stage (it comes from y1 or y2).
struct NoA {
  __device__ __forceinline__ uint32_t operator()(uint32_t, uint32_t, int, int, bool) const {
    return 0u;
  }
};

// x tiles of phase 1 (or of the stride-1 projection): m-tiles of group g,
// 64 pixels each, of the (Cin, pixels) map: a run from pixel `pix0`, or
// with `per_row` tiles per row, rows `row_pixels` apart from `pix0` on.
__device__ __forceinline__ uint32_t load_x_tiles(const CUtensorMap* xmap, const PhaseCfg& c,
                                                 uint32_t st, uint32_t bar, int s, int g,
                                                 int pix0, int per_row, int row_pixels,
                                                 bool dry) {
  const int t0 = g * c.mg();
  const int nt = min(c.mg(), c.mt - t0);
  if (!dry)
    for (int t = t0; t < t0 + nt; ++t)
      tma_load_2d(st + (t - t0) * kTileBytes, xmap, bar, s * kSlice,
                  per_row ? pix0 + (t / per_row) * row_pixels + (t % per_row) * kTileM
                          : pix0 + t * kTileM);
  return nt * kTileBytes;
}

// The image, first output row and first output column of work item `item`.
struct Item {
  int img, r0, c0;
};
__device__ __forceinline__ Item item_at(const Plan& pl, int item) {
  const int tile = item % pl.tiles_per_img;
  return {item / pl.tiles_per_img, (tile / pl.col_tiles) * pl.th, (tile % pl.col_tiles) * pl.tw};
}

// Zeroes [0, bytes) of shared memory from `base`, all threads of the block.
__device__ __forceinline__ void zero_smem(uint32_t base, uint32_t bytes) {
  for (uint32_t i = threadIdx.x * 16; i < bytes; i += kThreads * 16)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(base + i), "r"(0) : "memory");
}

// Stores two bf16 (one 32-bit word) of pixel `pix`, channel `col` (even) of
// a chunk-major tile.
__device__ __forceinline__ void st_plain(uint32_t tile, uint32_t rows, int pix, int col,
                                         uint32_t v) {
  const uint32_t addr = tile + (col >> 3) * rows * 16 + pix * 16 + (col & 7) * 2;
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// ---- host side --------------------------------------------------------------

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has already
// loaded (no link against libcuda needed).
using EncodeFn = decltype(&cuTensorMapEncodeTiled);

inline EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (!fn) {
    void* sym = dlsym(RTLD_DEFAULT, "cuTensorMapEncodeTiled");
    if (!sym) {
      void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
      if (lib) sym = dlsym(lib, "cuTensorMapEncodeTiled");
    }
    fn = reinterpret_cast<EncodeFn>(sym);
  }
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle. dims innermost first; strides
// in bytes for dims 1..rank-1; element strides 1 unless given.
inline bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box,
                   const cuuint32_t* estr = nullptr) {
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  EncodeFn fn = encode_fn();
  if (!fn) return false;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, estr ? estr : ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (rows, inner) row-major bf16 matrix, read in boxes of 64 x box_rows.
inline bool encode_2d(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t rows,
                      uint32_t box_rows) {
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {kSlice, box_rows};
  return encode(map, ptr, 2, dims, strides, box);
}

constexpr int kPassCost = 8;   // a pass's fixed cost, in k16 products

// The planner's model of a phase's time, in k16 products of 64x64 tiles:
// the two warpgroups share the SM's tensor cores, so what both issue counts,
// and what the busier one issues counts again (the other may idle at the
// epilogue's barrier); plus each pass's fixed cost.
inline long phase_cost(const PhaseCfg& c, int ksteps) {
  long cost = 0;
  for (int g = 0; g < c.groups(); ++g) {
    const int left = c.mt - g * c.mg();
    const int busiest = left < c.mpw ? left : c.mpw;
    const int both = c.split_n ? 2 * busiest : (left < c.mg() ? left : c.mg());
    cost += (long)c.chunks() * ((both + 2 * busiest) * c.nsub * ksteps / 2 + kPassCost);
  }
  return cost;
}

// The cheapest split of a phase of `mt` m-tiles x `n` columns with `ksteps`
// k16 steps a pass; passes of at most `max_nc` columns and `max_mg` m-tiles
// (the x tiles a stage holds, where A is x); with `one_group`, one pass
// group covers every m-tile. False if no split qualifies.
inline bool choose_phase(PhaseCfg& best, int mt, int n, int ksteps, int max_mg, int max_nc,
                         bool one_group = false) {
  static const int opts[6][2] = {{1, 1}, {1, 2}, {1, 4}, {2, 1}, {2, 2}, {4, 1}};
  long best_cost = -1;
  for (int split = 0; split < 2; ++split)
    for (const auto& o : opts) {
      const PhaseCfg c{mt, n, o[0], o[1], split};
      if (c.nc() > max_nc || (n / 64) % (c.nc() / 64) || c.mg() > max_mg ||
          (one_group && c.groups() != 1))
        continue;
      const long cost = phase_cost(c, ksteps);
      if (best_cost < 0 || cost < best_cost) {
        best = c;
        best_cost = cost;
      }
    }
  return best_cost >= 0;
}

// The planner's levels, tried in turn until something fits. The first is
// the one measured at the main-path shapes. The second serves only shapes
// whose y1 and y2 tiles leave too little shared memory for the first even
// at one output pixel a work item (Cmid in the thousands): the narrowest
// passes, two x tiles a stage, and a ring of one stage (each load then waits
// for the products of the slice before it).
struct Level {
  int max_nc;      // columns of a pass
  int max_x;       // x tiles of a stage
  int min_stages;  // ring stages
};
constexpr Level kLevels[] = {{256, kMaxATiles, 2}, {64, 2, 1}};

inline uint32_t align1024(uint32_t v) { return (v + 1023u) & ~1023u; }

// Places y2 and the ring after `y1_bytes` of y1 planes; `a1`, `a3`: bytes
// of x tiles a stage of phase 1 and of phase 3 holds. The wide ring gives
// every stage room for the most x tiles and the widest weight slice (B-only
// phases then put more slices in a stage); where it does not fit, the
// compact ring gives each stage room for the largest (x tiles + weight
// slice) of one phase. As many stages (`min_stages`..4) as fit.
// Returns 1 (wide), 2 (compact) or 0 (nothing fits).
inline int place(Plan& pl, size_t y1_bytes, size_t y2_bytes, uint32_t a1, uint32_t a3,
                 int min_stages) {
  if (y1_bytes + y2_bytes > kMaxSmem) return 0;
  uint32_t b[3];
  for (int k = 0; k < 3; ++k) b[k] = pl.ph[k].nc() * 128;
  pl.y2_off = align1024(y1_bytes);
  pl.ring_off = align1024(pl.y2_off + y2_bytes);
  const size_t budget = kMaxSmem - 1024 - 128;   // alignment slack, static barriers
  for (int layout = 1; layout <= 2; ++layout) {
    const uint32_t a = std::max(a1, a3);
    pl.ph[0].a_off = layout == 1 ? a : a1;
    pl.ph[2].a_off = layout == 1 ? a : a3;
    pl.stage_bytes = layout == 1 ? a + std::max({b[0], b[1], b[2]})
                                 : std::max({a1 + b[0], b[1], a3 + b[2]});
    int fit = 0;
    for (int s = min_stages; s <= kMaxStages; ++s)
      if (pl.ring_off + (size_t)s * pl.stage_bytes <= budget) fit = s;
    if (fit == 0) continue;
    pl.stages = fit;
    pl.smem = pl.ring_off + pl.stages * pl.stage_bytes + 1024;
    for (int k = 0; k < 3; ++k) pl.spp[k] = std::max(1, (int)(pl.stage_bytes / b[k]));
    return layout;
  }
  return 0;
}

// The planner's search, shared by both kernels: at the first level where
// anything fits, the cheapest TH of whole output rows, or where none fits,
// TH 1 and the widest column tile that fits. `cost(plan, level, th, tw)`
// fills a plan and returns its cost, -1 where it does not fit.
template <class CostFn>
bool search_plan(Plan& best, int rows, int cols, CostFn cost) {
  for (const Level& L : kLevels) {
    long best_cost = -1;
    for (int th = 1; th <= rows && th <= 64; ++th) {
      Plan c{};
      const long k = cost(c, L, th, cols);
      if (k >= 0 && (best_cost < 0 || k < best_cost)) {
        best_cost = k;
        best = c;
      }
    }
    if (best_cost >= 0) return true;
    // the widest fitting TW, by bisection (what a tile needs grows with TW)
    Plan c{};
    if (cols < 2 || cost(c, L, 1, 1) < 0) continue;
    int lo = 1, hi = cols - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (cost(c, L, 1, mid) >= 0) lo = mid; else hi = mid - 1;
    }
    cost(best, L, 1, lo);
    return true;
  }
  return false;
}

inline int num_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Block-wide set-up: the aligned base, the mbarriers, y1 zeroed (its border
// columns stay zero: phase 1 never writes them).
__device__ __forceinline__ Smem setup_block(unsigned char* dyn, uint64_t* bars, const Plan& pl) {
  Smem sm;
  sm.base = (smem_u32(dyn) + 1023u) & ~1023u;
  sm.y2 = sm.base + pl.y2_off;
  sm.ring = sm.base + pl.ring_off;
  sm.full = smem_u32(bars);
  sm.empty = sm.full + 8 * kMaxStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < pl.stages; ++i) {
      mbar_init(sm.full + 8 * i, 1);
      mbar_init(sm.empty + 8 * i, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  zero_smem(sm.base, pl.y2_off);
  fence_proxy_async();
  __syncthreads();
  return sm;
}

}  // namespace geo_sm90
