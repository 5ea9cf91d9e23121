// int8 convolution with the requantization fused into its epilogue, for
// Hopper (sm_90a): s8 x s8 -> s32 products, then an fp32 rescale, bias,
// optional residual, clip and round back to int8 -- only int8 reaches memory.
//
// Replaces geoestimation_tpu/models/quant.py::_conv_s8 (an XLA
// conv_general_dilated with preferred_element_type=int32, no Pallas kernel)
// together with the consumer fusion XLA builds around it (`requant`,
// `requant_residual` and the residual adds of build_int8_apply). Per output
// pixel m and channel o, with acc = sum over (ky, kx, c) of x * w in int32:
//   y   = fma(float(acc), mult[o], bias[o])
//   y   = fma(float(res[m, o]), res_scale, y)      identity residual, or
//   y   = float(res[m, o]) * res_scale + y         stage-entry residual
//   out = int8(clip(round(y), lo, 127))
// where round is floor (the half_up serving mode, whose +0.5 the host folds
// into bias) or round-to-nearest-even (GEO_REQUANT_MODE=rne). Every product,
// sum and fma is written out (__fmaf_rn, __fmul_rn, __fadd_rn), so the bits
// do not depend on nvcc's contraction: they are the ones XLA's CPU backend
// produces for the JAX package's served graph, which contracts `acc * mult +
// bias` and the identity tail `y3 + x * md` into fmas but, in the
// stage-entry fusion, rounds `y3q * g3` before adding it (tests pin all
// three). The identity residual is res = the block input, res_scale =
// s_in / s_out, on conv3; the stage-entry residual is res = conv3's int8
// output, res_scale = s_y3 / s_out, on the downsample conv. An int32 sum of
// s8 products is exact in any order (|acc| <= 128 * 127 * K < 2^31), so no
// tiling or order of the products changes a bit of the result.
//
// The convolution is an implicit GEMM: M = N*Ho*Wo output pixels, N = Cout,
// K = KH*KW*Cin in (ky, kx, c) order; activations NHWC int8, weights
// (Cout, K) int8, laid out once on the host. The stem runs as a VALID 4x4
// conv over its space-to-depth buffer, with Ho, Wo given.
//
// What bounds it on an H100 (1,979 TOP/s int8, 3.35 TB/s): the ten-crop
// ResNet50 forward's 53 convolutions do about 2.7e12 multiply-adds at
// N = 640 crops (2.7 ms at the int8 peak) and must move about 17.6 GB of
// int8 inputs, residuals, outputs and weights, each once (5.2 ms), so the
// forward as a whole is bound by bytes; only the 3x3 convolutions past
// layer1 and the 1x1 convolutions of layer4 are bound by operations.
//
// What the design does about it:
//   * products: wgmma m64nNk32 s8 (N = 64 or 128, at most 64 accumulator
//     registers a thread), both operands K-major in shared memory, by
//     descriptor; a stage's group stays in flight while the next stage's
//     products are issued, and each tile's first product overwrites the
//     accumulators (no zeroing between a wgmma and its wait);
//   * loads: TMA (cp.async.bulk.tensor) into a ring of 2-8 stages, each of
//     1, 2 or 4 K sub-slices of SB bytes (128 where a tap's channels come
//     in 128s, else 64: one box row, in the swizzle of that width): the A
//     boxes of the tile's sub-boxes and, unless the weights are resident,
//     B; completed on `full` mbarriers, handed back on `empty` ones. A 1x1
//     stride-1 convolution reads A as the (N*H*W, Cin) matrix (2-D map).
//     Any other reads one 4-D box (Cin, W, H, N) per tap and sub-box of 64
//     output pixels (BW x BH): TMA's out-of-bounds zero fill is the zero
//     padding, and a stride s is a map per phase (ry, rx) of the input
//     (base x + ry*W + rx pixels, pixel strides s), so a tap (ky, kx) is map
//     (ky - pad) mod s at coordinate ox + floor((kx - pad) / s); a phase
//     with no input pixel is read wholly out of bounds. TMA's im2col mode
//     would give the same rows without per-tap boxes; the tiled mode is
//     used because its coordinates are plain, and sub-boxes (8x8, 16x4,
//     ...) cover the 56/28/14/7-wide planes with at most 24% of rows
//     computed and dropped. The stem (Cin 16, 4x4 VALID, stride 1) folds
//     its 4 kx taps into one 64-byte row, since they are contiguous in
//     NHWC: one map per output column residue mod 4 (base x + r pixels,
//     pixel stride 4), so K holds no zero padding;
//   * grid: persistent and warp-specialised: one producer warp (lane 0
//     issues every TMA, walking the taps without dividing) and WG consumer
//     warpgroups, each with its own MT sub-boxes of the tile. Where all the
//     weights fit in 64 KB (every 1x1 of layer1-2, the 3x3 at 64 channels,
//     the stem) they are loaded once per block and stay, and a block has
//     one warpgroup and shares its SM with a second block (112 KB each), so
//     one block's epilogue overlaps the other's products. Otherwise (long
//     K: the weights streamed) two warpgroups share each B stage, one block
//     to an SM (227 KB). Either way the producer runs ahead into the next
//     tile while a warpgroup's epilogue runs;
//   * epilogue through shared memory: the tile's mult and bias are staged
//     once per column chunk; the residual tile comes in by TMA and the int8
//     output tile is staged and leaves by a TMA store, both in the TMA's
//     swizzle of BN-byte rows (so the fragment-order reads and writes are
//     free of bank conflicts); where Cout % 16 != 0 no TMA row stride takes
//     them, and 8-byte loads and stores do, one row offset per pixel from a
//     table the tile builds once. The requant itself runs on the FP32
//     pipes: round and clip by an added 1.5 * 2^23, one straight-line loop
//     per residual form;
//   * a planner on the host (ops/conv_s8.py `kernel_plan`) picks the mode,
//     the sub-box shape, the warpgroups, the tile (MT sub-boxes x BN
//     channels), the sub-slice width, whether the weights stay resident, the
//     ring depth and the grid; geo_conv_s8 checks the plan again and derives
//     its layout. No K split: at N = 640 every convolution of the forward
//     has at least 980 tiles for at most 264 blocks.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int kSub = 64;                          // output pixels of a sub-box
constexpr int kFoldBytes = 64;                    // the folded taps of a stem row
constexpr int kConsumers = 128;                   // threads of a consumer warpgroup
constexpr int kMaxStages = 8;
constexpr int kParamMaps = 8;                     // A maps passed in the params
// Shared memory of a block: two one-warpgroup blocks share an SM's 228 KB;
// a two-warpgroup block has an SM to itself.
constexpr uint32_t kSmemPerBlock[2] = {112 * 1024, 227 * 1024};
constexpr uint32_t kBResidentMax = 64 * 1024;
constexpr uint32_t kBarBytes = 256;
constexpr long long kMaxPixels = (1LL << 31) - 128;

enum { kFlat = 0, kBox = 1, kFold = 2 };

// The plan: the host's choice (mode .. sb) and what geo_conv_s8 derives.
struct Plan {
  int mode, bw, bh, mt, bn, b_resident, stages, grid, wg, g;
  int sb;         // K bytes of a sub-slice: 64 or 128 (one TMA box row)
  int nch;        // column chunks of BN
  int nq;         // K sub-slices of a tile
  int cs;         // sub-slices of a tap's channels
  int nres;       // output column residues (fold), else 1
  int nbx, nby;   // sub-boxes across and down a plane
  int subs;       // sub-boxes in all
  int tiles;
  int nrx, nmaps; // A maps: per phase (box) or residue (fold)
  int tile_subs;  // sub-boxes of a tile: wg * mt
  uint32_t sub_bytes;    // A of one sub-slice of one sub-box: 64 rows x sb
  uint32_t a_bytes;      // A of one sub-slice of a tile
  uint32_t stage_bytes;  // g sub-slices: their A, then their B (unless resident)
  uint32_t b_off;        // resident weights
  uint32_t wg_off, wg_bytes;  // each warpgroup's epilogue region, from wg_off
  uint32_t out_off, res_off, mb_off, rows_off;   // within a region
  uint32_t bar_off, smem;
};

struct Params {
  CUtensorMap amap[kParamMaps];  // A, where nmaps <= kParamMaps
  CUtensorMap bmap;              // weights (K, Cout), box SB x BN
  CUtensorMap rmap;              // residual in the output's geometry
  CUtensorMap omap[4];           // output: one, or one per residue (fold)
  const CUtensorMap* amaps;      // A maps in global memory, or null
  const float* mult;
  const float* bias;
  const int8_t* res;
  int8_t* out;
  Plan pl;
  int n, h, w, cin, ho, wo, cout, kh, kw, stride, pad, m;
  float lo, res_scale;
  int rne, res_mode, res_tma, out_tma;
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

// Waits for the phase after `parity` to complete; a ring that never
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

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier of one consumer warpgroup (the producer never joins).
__device__ __forceinline__ void consumer_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kConsumers) : "memory");
}

// wgmma descriptor of a K-major tile in the TMA's swizzle of its SB-byte
// rows (128: layout 1, 64: layout 2), 8-row groups 8 SB bytes apart; a k32
// step adds 32 bytes.
template <int SB>
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * SB >> 4) << 32) | ((uint64_t)(SB == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d = A (64 x 32, by descriptor) . B (64 x 32, K-major, by descriptor)
// + (acc ? d : 0), s32
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d = A (64 x 32, by descriptor) . B (128 x 32, K-major, by descriptor)
// + (acc ? d : 0), s32
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (BN == 64) wgmma_n64(d, a, b, acc);
  else wgmma_n128(d, a, b, acc);
}

// An int8 value (a residual) as float32: exact for |v| < 2^22 by the
// 1.5 * 2^23 offset, at full rate (no conversion unit).
__device__ __forceinline__ float small_int_to_float(int v) {
  return __fsub_rn(__int_as_float(0x4B400000 + v), 12582912.0f);
}

// The requant of one accumulator, returned in the low byte of a 32-bit
// word. y is clipped to [lo, 127] before it is rounded, which equals
// clip(round(y), lo, 127) since both roundings are monotone and keep
// integers (and maps NaN to lo, as fmaxf does); then y + 1.5 * 2^23, added
// rounding down (floor) or to nearest even (rne), holds round(y) in its low
// mantissa bits. Only the int32 -> float32 conversion leaves the FP32
// pipes.
template <int RES>
__device__ __forceinline__ uint32_t requant(int acc, float mult, float bias, float r,
                                            float res_scale, bool rne, float lo) {
  float y = __fmaf_rn(__int2float_rn(acc), mult, bias);
  if constexpr (RES == 1) y = __fmaf_rn(r, res_scale, y);
  if constexpr (RES == 2) y = __fadd_rn(__fmul_rn(r, res_scale), y);
  y = fminf(fmaxf(y, lo), 127.0f);
  return __float_as_uint(rne ? __fadd_rn(y, 12582912.0f) : __fadd_rd(y, 12582912.0f));
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return q * b > a ? q - 1 : q;
}

// A sub-box: FLAT, its first pixel; BOX and FOLD, its image, residue and
// place in the plane. Sub-boxes past the last image read out of bounds
// (zeros) and store nothing.
struct SubBox {
  int n, r, by, bx;
  long long m0;
};

__device__ __forceinline__ SubBox sub_box(const Params& p, int sb) {
  const Plan& pl = p.pl;
  SubBox s{0, 0, 0, 0, (long long)sb * kSub};
  if (pl.mode == kFlat) return s;
  const int plane = pl.nby * pl.nbx, per_img = pl.nres * plane;
  s.n = sb / per_img;
  int rem = sb - s.n * per_img;
  s.r = rem / plane;
  rem -= s.r * plane;
  s.by = rem / pl.nbx;
  s.bx = rem - s.by * pl.nbx;
  return s;
}

// Byte offset in out/res of pixel `pix` of a sub-box, or -1 where it lies
// outside the output.
__device__ __forceinline__ long long row_offset(const Params& p, const SubBox& s, int pix) {
  const Plan& pl = p.pl;
  if (pl.mode == kFlat) {
    const long long m = s.m0 + pix;
    return m < p.m ? m * p.cout : -1;
  }
  const int y = pix / pl.bw, x = pix - y * pl.bw;
  const int oy = s.by * pl.bh + y;
  int ox = s.bx * pl.bw + x;
  if (pl.mode == kFold) ox = ox * p.kw + s.r;
  if (s.n >= p.n || oy >= p.ho || ox >= p.wo) return -1;
  return (((long long)s.n * p.ho + oy) * p.wo + ox) * p.cout;
}

// Where a sub-slice of a tile comes from: its A map (box mode: the tap's
// phase), its offsets in output pixels, its first channel, and its weight
// column. Where the phase holds no input pixel (W or H under the stride)
// the tap reads a box wholly out of bounds: zeros, so its products add
// nothing.
struct Tap {
  int map, qx, qy, c0, wcol;
};

// The sub-slices of a tile in order, q = 0, 1, ..., by counters: the
// producer is one thread, and an integer division would cost it dozens of
// dependent instructions a step. Sub-slice q is tap q / cs (ky, kx) and
// channels from (q % cs) * sb; the tap's phase is ((ky, kx) - pad) mod s.
struct TapWalk {
  int q, c, kx, ky, qx, rx, qy, ry, qx0, rx0;
  __device__ __forceinline__ explicit TapWalk(const Params& p) {
    q = c = kx = ky = 0;
    qx0 = qx = floor_div(-p.pad, p.stride);
    rx0 = rx = -p.pad - qx * p.stride;
    qy = qx;
    ry = rx;
  }
  __device__ __forceinline__ Tap tap(const Params& p) const {
    const Plan& pl = p.pl;
    if (pl.mode == kFlat) return {0, 0, 0, q * pl.sb, q * pl.sb};
    if (pl.mode == kFold) return {0, 0, q, 0, q * kFoldBytes};
    const int iy = p.kh <= p.stride ? ky : ry, ix = p.kw <= p.stride ? kx : rx;
    const bool live = ry < p.h && rx < p.w;
    return {iy * pl.nrx + ix, live ? qx : -(1 << 24), qy, c * pl.sb,
            (ky * p.kw + kx) * p.cin + c * pl.sb};
  }
  __device__ __forceinline__ void next(const Params& p) {
    ++q;
    if (p.pl.mode != kBox || ++c < p.pl.cs) return;
    c = 0;
    if (++rx == p.stride) {
      rx = 0;
      ++qx;
    }
    if (++kx < p.kw) return;
    kx = 0;
    qx = qx0;
    rx = rx0;
    ++ky;
    if (++ry == p.stride) {
      ry = 0;
      ++qy;
    }
  }
};

// Shared-memory addresses of a block.
struct Smem {
  uint32_t base, full, empty, b_full, res_full, res_empty;   // res_*: one per warpgroup
  unsigned char* gen;   // `base` as a generic pointer
};

// ---- producer ----------------------------------------------------------------

// Lane 0 of the producer warp: the resident weights once, then for every
// tile of this block its stages in order (each g sub-slices: the A boxes of
// the tile's sub-boxes, then B unless resident), and each warpgroup's
// residual tile once the warpgroup has read its last one.
__device__ void produce(const Params& p, const Smem& sm) {
  const Plan& pl = p.pl;
  const CUtensorMap* am = p.amaps ? p.amaps : p.amap;
  if (p.amaps)
    for (int i = 0; i < pl.nmaps; ++i)
      asm volatile("fence.proxy.tensormap::generic.acquire.gpu [%0], 128;" ::"l"(am + i)
                   : "memory");
  const uint32_t b_tile = pl.bn * pl.sb;
  if (pl.b_resident) {
    mbar_expect_tx(sm.b_full, pl.nq * pl.nch * b_tile);
    TapWalk walk(p);
    for (int q = 0; q < pl.nq; ++q, walk.next(p))
      for (int c = 0; c < pl.nch; ++c)
        tma_load_2d(sm.base + pl.b_off + (q * pl.nch + c) * b_tile, &p.bmap, sm.b_full,
                    walk.tap(p).wcol, c * pl.bn);
  }
  int stage = 0;
  uint32_t phase = 0, rphase = 0;
  for (int t = blockIdx.x; t < pl.tiles; t += gridDim.x) {
    const int mtile = t / pl.nch, chunk = t - mtile * pl.nch;
    SubBox sb[4];
    for (int i = 0; i < pl.tile_subs; ++i) sb[i] = sub_box(p, mtile * pl.tile_subs + i);
    TapWalk walk(p);
    for (int q0 = 0; q0 < pl.nq; q0 += pl.g) {
      const uint32_t full = sm.full + 8 * stage, st = sm.base + stage * pl.stage_bytes;
      mbar_wait(sm.empty + 8 * stage, phase ^ 1);
      mbar_expect_tx(full, pl.g * (pl.a_bytes + (pl.b_resident ? 0 : b_tile)));
      for (int g = 0; g < pl.g; ++g, walk.next(p)) {
        const Tap tp = walk.tap(p);
        for (int i = 0; i < pl.tile_subs; ++i) {
          const uint32_t dst = st + g * pl.a_bytes + i * pl.sub_bytes;
          if (pl.mode == kFlat)
            tma_load_2d(dst, am, full, tp.c0, (int)sb[i].m0);
          else
            tma_load_4d(dst, am + (pl.mode == kFold ? sb[i].r : tp.map), full, tp.c0,
                        sb[i].bx * pl.bw + tp.qx, sb[i].by * pl.bh + tp.qy, sb[i].n);
        }
        if (!pl.b_resident)
          tma_load_2d(st + pl.g * pl.a_bytes + g * b_tile, &p.bmap, full, tp.wcol,
                      chunk * pl.bn);
      }
      if (++stage == pl.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (p.res_tma) {
      for (int w = 0; w < pl.wg; ++w) {
        const uint32_t bar = sm.res_full + 8 * w;
        mbar_wait(sm.res_empty + 8 * w, rphase ^ 1);
        mbar_expect_tx(bar, pl.mt * kSub * pl.bn);
        for (int i = 0; i < pl.mt; ++i) {
          const SubBox& b = sb[w * pl.mt + i];
          const uint32_t dst = sm.base + pl.wg_off + w * pl.wg_bytes + pl.res_off +
                               i * kSub * pl.bn;
          if (pl.mode == kFlat)
            tma_load_2d(dst, &p.rmap, bar, chunk * pl.bn, (int)b.m0);
          else
            tma_load_4d(dst, &p.rmap, bar, chunk * pl.bn, b.bx * pl.bw, b.by * pl.bh, b.n);
        }
      }
      rphase ^= 1;
    }
  }
}

// ---- consumer ----------------------------------------------------------------

// Byte of a staged output or residual tile at (row, col): rows of BN bytes
// in the TMA's swizzle for them (128-byte for BN 128, 64-byte for BN 64),
// 16-byte chunks XOR-ed with address bits 7-9 (7-8). The 8 rows a quad of
// lanes touches then fall in distinct banks, and TMA stores the tile (or
// brings the residual) in this same layout.
template <int BN>
__device__ __forceinline__ uint32_t out_at(int row, int col) {
  const uint32_t at = row * BN + col;
  return at ^ (((at >> 7) & (BN == 128 ? 7u : 3u)) << 4);
}

// The requant of a warpgroup's tile from its accumulator fragments into the
// staged output tile: register 4 jj + 2 hh + e of a 64 x BN accumulator is
// row 16 warp + lane / 4 + 8 hh, column 8 jj + 2 (lane % 4) + e.
template <int MT, int BN, int RES>
__device__ __forceinline__ void requant_tile(const int (&acc)[MT][BN / 2], const float* mult_s,
                                             const float* bias_s, const int8_t* res_s,
                                             int8_t* out_s, const Params& p, bool rne) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const float lo = p.lo, res_scale = p.res_scale;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int col = jj * 8 + (lane & 3) * 2;
      const float2 mu = *reinterpret_cast<const float2*>(mult_s + col);
      const float2 bi = *reinterpret_cast<const float2*>(bias_s + col);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = i * kSub + warp * 16 + (lane >> 2) + hh * 8;
        float r0 = 0.0f, r1 = 0.0f;
        if constexpr (RES != 0) {
          const char2 rv = *reinterpret_cast<const char2*>(res_s + out_at<BN>(row, col));
          r0 = small_int_to_float(rv.x);
          r1 = small_int_to_float(rv.y);
        }
        const uint32_t q0 =
            requant<RES>(acc[i][4 * jj + 2 * hh], mu.x, bi.x, r0, res_scale, rne, lo);
        const uint32_t q1 =
            requant<RES>(acc[i][4 * jj + 2 * hh + 1], mu.y, bi.y, r1, res_scale, rne, lo);
        *reinterpret_cast<uint16_t*>(out_s + out_at<BN>(row, col)) =
            static_cast<uint16_t>(__byte_perm(q0, q1, 0x0040));
      }
    }
}

// The consumer warpgroup: every tile of this block, MT sub-boxes x BN
// channels, accumulators acc[MT][BN / 2] (at most 64 registers a thread, so
// that ptxas never moves them between a wgmma and its wait).
template <int MT, int BN, int G, int SB>
__device__ void consume(const Params& p, const Smem& sm, int wg) {
  constexpr uint32_t kSubBytes = kSub * SB;
  constexpr int NR = BN / 2;
  const Plan& pl = p.pl;
  const int tid = threadIdx.x & (kConsumers - 1), warp = tid >> 5, lane = tid & 31;
  unsigned char* region = sm.gen + pl.wg_off + wg * pl.wg_bytes;
  float* mult_s = reinterpret_cast<float*>(region + pl.mb_off);
  float* bias_s = mult_s + BN;
  long long* rows_s = reinterpret_cast<long long*>(region + pl.rows_off);
  int8_t* out_s = reinterpret_cast<int8_t*>(region + pl.out_off);
  int8_t* res_s = reinterpret_cast<int8_t*>(region + pl.res_off);
  const uint32_t res_full = sm.res_full + 8 * wg, res_empty = sm.res_empty + 8 * wg;
  const int res_mode = p.res_mode;
  const bool rne = p.rne != 0;
  int acc[MT][NR];

  if (pl.b_resident) mbar_wait(sm.b_full, 0);
  int stage = 0, staged = -1;
  uint32_t phase = 0, rphase = 0;
  for (int t = blockIdx.x; t < pl.tiles; t += gridDim.x) {
    const int mtile = t / pl.nch, chunk = t - mtile * pl.nch, n0 = chunk * BN;
    consumer_sync(wg);   // the last tile's copy-out has read its staging and rows
    if (chunk != staged) {   // this chunk's multipliers and biases
      for (int c = tid; c < BN; c += kConsumers) {
        const bool in = n0 + c < p.cout;
        mult_s[c] = in ? p.mult[n0 + c] : 0.0f;
        bias_s[c] = in ? p.bias[n0 + c] : 0.0f;
      }
      staged = chunk;
    }
    if (tid < MT * kSub)
      rows_s[tid] = row_offset(p, sub_box(p, (mtile * pl.wg + wg) * MT + tid / kSub), tid % kSub);

    int prev = 0;
    for (int q0 = 0; q0 < pl.nq; q0 += G) {
      mbar_wait(sm.full + 8 * stage, phase);
      const uint32_t st = sm.base + stage * pl.stage_bytes;
      wgmma_fence();
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint32_t a = st + g * pl.a_bytes + wg * MT * kSubBytes;
        const uint32_t b = pl.b_resident
                               ? sm.base + pl.b_off + ((q0 + g) * pl.nch + chunk) * BN * SB
                               : st + G * pl.a_bytes + g * BN * SB;
#pragma unroll
        for (int kk = 0; kk < SB / 32; ++kk)
#pragma unroll
          for (int i = 0; i < MT; ++i)   // the tile's first product overwrites
            wgmma_tile<BN>(acc[i], desc_sw<SB>(a + i * kSubBytes) + 2 * kk,
                           desc_sw<SB>(b) + 2 * kk, q0 + g > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the stage before this one is done: hand it back
      if (q0 > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.empty + 8 * prev);
      }
      prev = stage;
      if (++stage == pl.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty + 8 * prev);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < NR; ++r) asm volatile("" : "+r"(acc[i][r])::"memory");

    if (p.res_tma) mbar_wait(res_full, rphase);
    // the last tile's TMA store has read the staging
    if (p.out_tma && tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    consumer_sync(wg);   // mult, bias and rows are in place
    if (res_mode != 0 && !p.res_tma) {
      // residual rows by 8-byte loads where no TMA map takes them
      for (int idx = tid; idx < MT * kSub * (BN / 8); idx += kConsumers) {
        const int row = idx / (BN / 8), col = (idx - row * (BN / 8)) * 8;
        const long long off = rows_s[row];
        if (off >= 0 && n0 + col < p.cout)
          *reinterpret_cast<int2*>(res_s + out_at<BN>(row, col)) =
              *reinterpret_cast<const int2*>(p.res + off + n0 + col);
      }
      consumer_sync(wg);
    }

    switch (res_mode) {   // one straight-line loop per form, for the scheduler
      case 0: requant_tile<MT, BN, 0>(acc, mult_s, bias_s, res_s, out_s, p, rne); break;
      case 1: requant_tile<MT, BN, 1>(acc, mult_s, bias_s, res_s, out_s, p, rne); break;
      default: requant_tile<MT, BN, 2>(acc, mult_s, bias_s, res_s, out_s, p, rne); break;
    }
    if (p.out_tma) fence_proxy_async();   // the staging, visible to the TMA store
    consumer_sync(wg);   // the staged tile is whole; the residual is read
    if (p.res_tma) {
      if (tid == 0) mbar_arrive(res_empty);
      rphase ^= 1;
    }
    if (p.out_tma) {
      if (tid == 0) {
        for (int i = 0; i < MT; ++i) {
          const SubBox b = sub_box(p, (mtile * pl.wg + wg) * MT + i);
          const uint32_t src = smem_u32(out_s) + i * kSub * BN;
          if (pl.mode == kFlat)
            tma_store_2d(&p.omap[0], src, n0, (int)b.m0);
          else
            tma_store_4d(&p.omap[pl.mode == kFold ? b.r : 0], src, n0, b.bx * pl.bw,
                         b.by * pl.bh, b.n);
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
      continue;
    }
    // copy-out by 8-byte stores where no TMA map takes the rows (Cout % 16 != 0)
    for (int idx = tid; idx < MT * kSub * (BN / 8); idx += kConsumers) {
      const int row = idx / (BN / 8), col = (idx - row * (BN / 8)) * 8;
      const long long off = rows_s[row];
      if (off >= 0 && n0 + col < p.cout)
        *reinterpret_cast<int2*>(p.out + off + n0 + col) =
            *reinterpret_cast<const int2*>(out_s + out_at<BN>(row, col));
    }
  }
  if (p.out_tma && tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// WG consumer warpgroups (threads 0 .. 128 WG - 1) and the producer warp.
template <int WG>
__global__ void __launch_bounds__(WG * kConsumers + 32, 3 - WG)
    conv_s8_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char dyn[];
  const Plan& pl = p.pl;
  Smem sm;
  sm.base = (smem_u32(dyn) + 1023u) & ~1023u;
  sm.gen = dyn + (sm.base - smem_u32(dyn));
  sm.full = sm.base + pl.bar_off;
  sm.empty = sm.full + 8 * kMaxStages;
  sm.b_full = sm.empty + 8 * kMaxStages;
  sm.res_full = sm.b_full + 8;
  sm.res_empty = sm.res_full + 16;
  if (threadIdx.x == 0) {
    for (int i = 0; i < pl.stages; ++i) {
      mbar_init(sm.full + 8 * i, 1);
      mbar_init(sm.empty + 8 * i, WG * kConsumers / 32);
    }
    mbar_init(sm.b_full, 1);
    for (int w = 0; w < WG; ++w) {
      mbar_init(sm.res_full + 8 * w, 1);
      mbar_init(sm.res_empty + 8 * w, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= WG * kConsumers) {
    if (threadIdx.x == WG * kConsumers) produce(p, sm);
    return;
  }
  const int wg = threadIdx.x / kConsumers;
#define GEO_TILE(MT, BN)                                                       \
  switch (pl.g * 1000 + pl.sb) {                                               \
    case 1064: consume<MT, BN, 1, 64>(p, sm, wg); return;                      \
    case 2064: consume<MT, BN, 2, 64>(p, sm, wg); return;                      \
    case 4064: consume<MT, BN, 4, 64>(p, sm, wg); return;                      \
    case 1128: consume<MT, BN, 1, 128>(p, sm, wg); return;                     \
    case 2128: consume<MT, BN, 2, 128>(p, sm, wg); return;                     \
    case 4128: consume<MT, BN, 4, 128>(p, sm, wg); return;                     \
  }
  switch (pl.mt * 1000 + pl.bn) {
    case 1064: GEO_TILE(1, 64) break;
    case 2064: GEO_TILE(2, 64) break;
    case 1128: GEO_TILE(1, 128) break;
  }
#undef GEO_TILE
  __trap();
}

// ---- host side --------------------------------------------------------------

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// The plan of one convolution: checks the host's choice and derives the rest
// (the same arithmetic as ops/conv_s8.py kernel_plan). False where the
// choice is not one the kernel takes for this convolution.
bool make_plan(Plan& pl, int n, int h, int w, int cin, int ho, int wo, int cout, int kh, int kw,
               int stride, int pad, bool has_res) {
  const bool pow2 = pl.bw > 0 && (pl.bw & (pl.bw - 1)) == 0;
  if (!pow2 || pl.bw * pl.bh != kSub || pl.stages < 2 || pl.stages > kMaxStages ||
      pl.wg < 1 || pl.wg > 2 || (pl.g != 1 && pl.g != 2 && pl.g != 4) ||
      (pl.sb != 64 && pl.sb != 128) || (pl.sb == 128 && (pl.mode == kFold || cin % 128)))
    return false;
  const int tile = pl.mt * 1000 + pl.bn;
  if (tile != 1064 && tile != 2064 && tile != 1128) return false;
  pl.cs = cdiv(cin, pl.sb);
  pl.nres = 1;
  pl.nbx = pl.nby = 1;
  pl.nrx = 1;
  pl.nmaps = 1;
  long long subs;
  if (pl.mode == kFlat) {
    if (!(kh == 1 && kw == 1 && stride == 1 && pad == 0 && ho == h && wo == w && pl.bw == kSub))
      return false;
    pl.nq = pl.cs;
    subs = cdiv((long long)n * h * w, kSub);
  } else if (pl.mode == kFold) {
    if (!(stride == 1 && pad == 0 && kw > 1 && kw * cin == kFoldBytes && !has_res)) return false;
    pl.nq = kh;
    pl.nres = pl.nmaps = wo < kw ? wo : kw;
    pl.nbx = cdiv(cdiv(wo, kw), pl.bw);
    pl.nby = cdiv(ho, pl.bh);
    subs = (long long)n * pl.nres * pl.nbx * pl.nby;
  } else if (pl.mode == kBox) {
    pl.nq = kh * kw * pl.cs;
    pl.nrx = kw < stride ? kw : stride;
    pl.nmaps = (kh < stride ? kh : stride) * pl.nrx;
    pl.nbx = cdiv(wo, pl.bw);
    pl.nby = cdiv(ho, pl.bh);
    subs = (long long)n * pl.nbx * pl.nby;
  } else {
    return false;
  }
  if (pl.nq % pl.g) return false;
  pl.nch = cdiv(cout, pl.bn);
  pl.tile_subs = pl.wg * pl.mt;
  const long long tiles = (subs + pl.tile_subs - 1) / pl.tile_subs * pl.nch;
  if (subs >= (1LL << 31) || tiles >= (1LL << 31)) return false;
  pl.subs = static_cast<int>(subs);
  pl.tiles = static_cast<int>(tiles);
  if (pl.grid < 1 || pl.grid > pl.tiles) return false;
  const uint32_t b_tile = pl.bn * pl.sb;
  const uint32_t b_all = static_cast<uint32_t>(pl.nq) * pl.nch * b_tile;
  if (pl.b_resident && ((long long)pl.nq * pl.nch * b_tile > kBResidentMax)) return false;
  pl.sub_bytes = kSub * pl.sb;
  pl.a_bytes = pl.tile_subs * pl.sub_bytes;
  pl.stage_bytes = pl.g * (pl.a_bytes + (pl.b_resident ? 0 : b_tile));
  pl.b_off = pl.stages * pl.stage_bytes;
  pl.wg_off = pl.b_off + (pl.b_resident ? b_all : 0);
  const uint32_t out_bytes = pl.mt * kSub * pl.bn;
  pl.out_off = 0;
  pl.res_off = out_bytes;
  pl.mb_off = pl.res_off + (has_res ? out_bytes : 0);
  pl.rows_off = pl.mb_off + 8 * pl.bn;
  pl.wg_bytes = (pl.rows_off + 8 * pl.mt * kSub + 1023u) & ~1023u;   // swizzle atoms
  pl.bar_off = pl.wg_off + pl.wg * pl.wg_bytes;
  pl.smem = pl.bar_off + kBarBytes + 1024;   // + the base's alignment slack
  return pl.smem <= kSmemPerBlock[pl.wg - 1];
}

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has already
// loaded (no link against libcuda needed).
using EncodeFn = decltype(&cuTensorMapEncodeTiled);

EncodeFn encode_fn() {
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

// An int8 tensor map (bytes: TMA has no signed byte type): dims innermost
// first, strides in bytes of dims 1..rank-1, element strides 1.
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  EncodeFn fn = encode_fn();
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr), dims,
                  strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The A maps of a plan, in the order the kernel indexes them.
CUtensorMapSwizzle swizzle_of(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

bool encode_a(std::vector<CUtensorMap>& maps, const Plan& pl, const int8_t* x, int n, int h,
              int w, int cin, int kh, int kw, int stride, int pad) {
  maps.resize(pl.nmaps);
  const uint64_t row = (uint64_t)w * cin, img = row * h;
  const CUtensorMapSwizzle sw = swizzle_of(pl.sb);
  if (pl.mode == kFlat) {
    const cuuint64_t dims[2] = {(uint64_t)cin, (uint64_t)n * h * w};
    const cuuint64_t strides[1] = {(uint64_t)cin};
    const cuuint32_t box[2] = {(uint32_t)pl.sb, kSub};
    return encode(&maps[0], x, 2, dims, strides, box, sw);
  }
  const cuuint32_t box[4] = {(uint32_t)pl.sb, (uint32_t)pl.bw, (uint32_t)pl.bh, 1};
  if (pl.mode == kFold) {   // residue r: the kw taps of output column kw j + r
    for (int r = 0; r < pl.nres; ++r) {
      const cuuint64_t dims[4] = {(uint64_t)kFoldBytes, (uint64_t)(w - r) / kw, (uint64_t)h,
                                  (uint64_t)n};
      const cuuint64_t strides[3] = {(uint64_t)kFoldBytes, row, img};
      if (!encode(&maps[r], x + (uint64_t)r * cin, 4, dims, strides, box, sw))
        return false;
    }
    return true;
  }
  const int nry = pl.nmaps / pl.nrx;
  for (int iy = 0; iy < nry; ++iy)
    for (int ix = 0; ix < pl.nrx; ++ix) {
      // phase (ry, rx): input pixels (ry + s i, rx + s j)
      const int ry = kh <= stride ? ((iy - pad) % stride + stride) % stride : iy;
      const int rx = kw <= stride ? ((ix - pad) % stride + stride) % stride : ix;
      const bool live = ry < h && rx < w;   // else never loaded
      const cuuint64_t dims[4] = {(uint64_t)cin, live ? (uint64_t)cdiv(w - rx, stride) : 1,
                                  live ? (uint64_t)cdiv(h - ry, stride) : 1, (uint64_t)n};
      const cuuint64_t strides[3] = {(uint64_t)stride * cin, row * stride, img};
      const int8_t* base = live ? x + ((uint64_t)ry * w + rx) * cin : x;
      if (!encode(&maps[iy * pl.nrx + ix], base, 4, dims, strides, box, sw))
        return false;
    }
  return true;
}

bool takes(int n, int h, int w, int cin, int ho, int wo, int cout, int kh, int kw) {
  return n > 0 && h > 0 && w > 0 && ho > 0 && wo > 0 && kh > 0 && kw > 0 && cin > 0 &&
         cout > 0 && cin % 16 == 0 && cout % 8 == 0 &&
         static_cast<long long>(n) * ho * wo < kMaxPixels &&
         static_cast<long long>(kh) * kw * cin * cout < (1LL << 31);
}

}  // namespace

// What the kernel takes: Cin a multiple of 16 (TMA rows are 16-byte
// multiples), Cout a multiple of 8, output pixels N*Ho*Wo and the weights'
// K*Cout in int32 range; byte offsets into x, res and out are 64-bit, so a
// batch's activations may pass 2 GiB. `plan` is the host planner's (mode,
// BW, BH, MT, BN, weights resident, stages, grid, warpgroups, sub-slices a
// stage, K bytes of a sub-slice); `maps` is 128-byte
// aligned device memory for the A maps where they are more than 8 (else
// unused). Returns a cudaError_t.
extern "C" int geo_conv_s8(const void* x, const void* w, const void* mult, const void* bias,
                           const void* res, void* out, int n, int h, int wd, int cin, int ho,
                           int wo, int cout, int kh, int kw, int stride, int pad, float lo,
                           int rne, int res_mode, float res_scale, const int* plan, void* maps,
                           void* stream) {
  if (!takes(n, h, wd, cin, ho, wo, cout, kh, kw) || stride < 1 || pad < 0 ||
      res_mode < 0 || res_mode > 2 || (res_mode != 0) != (res != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  Plan& pl = p.pl;
  pl.mode = plan[0];
  pl.bw = plan[1];
  pl.bh = plan[2];
  pl.mt = plan[3];
  pl.bn = plan[4];
  pl.b_resident = plan[5];
  pl.stages = plan[6];
  pl.grid = plan[7];
  pl.wg = plan[8];
  pl.g = plan[9];
  pl.sb = plan[10];
  if (!make_plan(pl, n, h, wd, cin, ho, wo, cout, kh, kw, stride, pad, res != nullptr) ||
      (pl.nmaps > kParamMaps && maps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xs = static_cast<const int8_t*>(x);
  std::vector<CUtensorMap> amaps;
  const int k = kh * kw * cin;
  const cuuint64_t bdims[2] = {(uint64_t)k, (uint64_t)cout};
  const cuuint64_t bstrides[1] = {(uint64_t)k};
  const cuuint32_t bbox[2] = {(uint32_t)pl.sb, (uint32_t)pl.bn};
  if (!encode_a(amaps, pl, xs, n, h, wd, cin, kh, kw, stride, pad) ||
      !encode(&p.bmap, w, 2, bdims, bstrides, bbox, swizzle_of(pl.sb)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the output and the residual by TMA, in the staging's swizzle, where
  // their rows are 16-byte multiples
  p.out_tma = cout % 16 == 0;
  p.res_tma = res != nullptr && p.out_tma;
  if (p.out_tma) {
    const CUtensorMapSwizzle sw = swizzle_of(pl.bn);
    const uint64_t row = (uint64_t)wo * cout, img = row * ho;
    bool ok = true;
    if (pl.mode == kFlat) {
      const cuuint64_t dims[2] = {(uint64_t)cout, (uint64_t)n * ho * wo};
      const cuuint64_t strides[1] = {(uint64_t)cout};
      const cuuint32_t box[2] = {(uint32_t)pl.bn, kSub};
      ok = encode(&p.omap[0], out, 2, dims, strides, box, sw) &&
           (!p.res_tma || encode(&p.rmap, res, 2, dims, strides, box, sw));
    } else {
      const cuuint32_t box[4] = {(uint32_t)pl.bn, (uint32_t)pl.bw, (uint32_t)pl.bh, 1};
      const int fold = pl.mode == kFold ? kw : 1;   // output column fold j + r
      for (int r = 0; r < pl.nres && ok; ++r) {
        const cuuint64_t dims[4] = {(uint64_t)cout, (uint64_t)cdiv(wo - r, fold), (uint64_t)ho,
                                    (uint64_t)n};
        const cuuint64_t strides[3] = {(uint64_t)fold * cout, row, img};
        ok = encode(&p.omap[r], static_cast<int8_t*>(out) + (uint64_t)r * cout, 4, dims,
                    strides, box, sw);
        if (ok && r == 0 && p.res_tma) ok = encode(&p.rmap, res, 4, dims, strides, box, sw);
      }
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.nmaps <= kParamMaps) {
    for (int i = 0; i < pl.nmaps; ++i) p.amap[i] = amaps[i];
    p.amaps = nullptr;
  } else {
    const cudaError_t err = cudaMemcpyAsync(maps, amaps.data(), pl.nmaps * sizeof(CUtensorMap),
                                            cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.amaps = static_cast<const CUtensorMap*>(maps);
  }
  p.mult = static_cast<const float*>(mult);
  p.bias = static_cast<const float*>(bias);
  p.res = static_cast<const int8_t*>(res);
  p.out = static_cast<int8_t*>(out);
  p.n = n;
  p.h = h;
  p.w = wd;
  p.cin = cin;
  p.ho = ho;
  p.wo = wo;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.m = n * ho * wo;
  p.lo = lo;
  p.res_scale = res_scale;
  p.rne = rne;
  p.res_mode = res_mode;
  const auto kernel = pl.wg == 1 ? conv_s8_kernel<1> : conv_s8_kernel<2>;
  static bool attributes_set[2][64] = {};   // per kernel and device
  int device = 0;
  cudaGetDevice(&device);
  if (device >= 64 || !attributes_set[pl.wg - 1][device]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemPerBlock[pl.wg - 1]);
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    if (device < 64) attributes_set[pl.wg - 1][device] = true;
  }
  kernel<<<pl.grid, pl.wg * kConsumers + 32, pl.smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
