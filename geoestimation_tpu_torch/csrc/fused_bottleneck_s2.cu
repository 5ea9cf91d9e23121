// Fused stride-2 ResNet bottleneck (a stage entry) for inference, BatchNorm
// folded, bf16 in and out, fp32 accumulation, for Hopper (sm_90a).
//
// Replaces geoestimation_tpu/ops/fused_bottleneck.py::fused_bottleneck_s2,
// the Pallas TPU kernel. It computes the same function with the same rounding
// points, for x (N, H, W, Cin) with H and W even and out (N, H/2, W/2, Cout):
//   y1  = bf16(relu(f32(x . w1) + b1))              1x1 conv at full resolution
//   y2  = bf16(relu(sum over 9 taps f32(y1[2r+dy-1, 2c+dx-1] . w2[tap]) + b2))
//                                                     3x3 conv, stride 2, pad 1
//   y3  = f32(y2 . w3) + b3                          1x1 conv, not rounded
//   res = f32(x[2r, 2c] . wd) + bd                   1x1 stride-2 projection
//   out = bf16(relu(y3 + res))
// (y2 . w3 and x[2r, 2c] . wd share one fp32 accumulator.)
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s), counting each
// input byte read once and each output byte written once, at the stage entry
// of layer2 of the ten-crop ResNet50 main path (56x56, 256 -> 128 -> 512,
// N = 80 crops): 59.6 GFLOP = 60 us against 193 MB = 58 us, so it sits at
// the ridge, on the side of the operations.
//
// What the design does about it: the core of the stride-1 kernel
// (bottleneck_sm90.cuh) with stride-2 indexing. A work item is one image and
// TH output rows [r0, r0 + TH); they read y1 rows [2 r0 - 1, 2 (r0 + TH) - 1]
// (2 TH + 1 rows, the top one a recomputed halo, zero above the image) and
// y1 columns -1 .. W - 1 (column -1 zero; for even H and W the bottom and
// right padding is never read). Phase 1 computes them from x tiles of 64
// consecutive pixels (one run of NHWC pixels, as in the stride-1 kernel).
// The y1 tile is kept as four planes, by the parity of its row and of its
// column (the Pallas kernel's even/odd deinterleave, in both directions), of
// W/2 + 1 pixels a row, TH + 1 rows for the even tile rows and TH for the
// odd ones: then tap (dy, dx) of output pixel (r, c)
// is pixel (r + dy/2, c + dx/2) of plane (dy % 2, dx % 2), so each tap is one
// plane shifted by a constant number of pixels and the 3x3 phase reads
// consecutive pixels by wgmma descriptor, over padded coordinates of pitch
// W/2 + 1. The projection's pixels x[2r, 2c] come by TMA from a 4-D view of
// x, (Cin, column parity, W/2, N*H), with a traversal stride of 2 over the
// rows, straight into the ring in the output's pixel order: one box of all
// TH rows, or at TH 1 one box per pass group (so a wide row takes several).
//
// Shared memory: y1 planes of 2 (2 TH + 1)(W/2 + 1) Cmid 2 B in all, y2 of
// TH (W/2) Cmid 2 B, and a ring of stages; the planner picks TH, the passes
// and the ring as the stride-1 kernel's does. At N = 640, one block of 288
// threads per SM and
//   56x56 256-128-512 (layer2.0):  TH 2, 2 stages, 221,184 B
//   28x28 512-256-1024 (layer3.0): TH 3, 2 stages, 228,352 B
// (geo_fused_bottleneck_s2_plan reports it for any shape; chip_smoke.py
// prints it on each kernel-check line).

#include "bottleneck_sm90.cuh"

using namespace geo_sm90;

namespace {

struct Params {
  const __nv_bfloat16* x;   // (N, H, W, Cin)
  const float* b1;          // (Cmid)
  const float* b2;          // (Cmid)
  const float* b3;          // (Cout)
  const float* bd;          // (Cout)
  __nv_bfloat16* out;       // (N, H / 2, W / 2, Cout)
  int h, w, cin, cmid, cout;
};

// Columns of the projection's box: TH rows of TW pixels in one box, or at
// TH 1 (where phase 3 may take several pass groups) each group's pixels of
// the one output row.
__host__ __device__ inline int proj_box_cols(const Plan& pl) {
  return pl.th > 1 || pl.tw < pl.ph[2].mg() * kTileM ? pl.tw : pl.ph[2].mg() * kTileM;
}

__global__ void __launch_bounds__(kThreads, 1)
fused_bottleneck_s2_kernel(const __grid_constant__ TmaMaps maps, const __grid_constant__ Params p,
                           const __grid_constant__ Plan pl) {
  extern __shared__ unsigned char dyn[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  const Smem sm = setup_block(dyn, bars, pl);
  const int H = p.h, W = p.w, H2 = p.h / 2, W2 = p.w / 2, P = pl.pitch, TH = pl.th, TW = pl.tw;
  // warp-uniform to the compiler too (a broadcast), so that the roles'
  // branches and the warpgroups' passes do not count as divergent
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int nk = pl.cmid_slices;
  // y1 plane (row parity pr, column parity pc): the even-row planes hold
  // TH + 1 rows, the odd-row ones TH, each of pitch P
  const uint32_t rows_e = (TH + 1) * P, rows_o = TH * P;
  const auto plane_rows = [&](int pr) { return pr ? rows_o : rows_e; };
  const auto plane_at = [&](int pr, int pc) {
    return sm.base + (pr ? 2 * rows_e + pc * rows_o : pc * rows_e) * p.cmid * 2;
  };
  const int box_cols = proj_box_cols(pl);
  Ring ring;

  if (warp == kConsumerThreads / 32) {  // producer
    if (lane != 0) return;
    for (int item = blockIdx.x; item < pl.items; item += gridDim.x) {
      const Item it = item_at(pl, item);
      const int img = it.img, r0 = it.r0;
      const int pix1 = (img * H + 2 * r0 - 1) * W + (pl.x_row_tiles ? 2 * it.c0 - 1 : 0);
      produce_phase(pl.ph[0], pl.cin_slices, 0, 1, pl, sm, ring,
                    [&](int s) { return BSrc{&maps.w1, s * kSlice}; },
                    [&](uint32_t st, uint32_t bar, int s, int g, bool dry) {
                      return load_x_tiles(&maps.x, pl.ph[0], st, bar, s, g, pix1,
                                          pl.x_row_tiles, W, dry);
                    });
      produce_phase(pl.ph[1], 9 * nk, 9 * nk, pl.spp[1], pl, sm, ring,
                    [&](int s) { return BSrc{&maps.w2, (s / nk) * p.cmid + (s % nk) * kSlice}; },
                    NoA());
      produce_phase(pl.ph[2], nk + pl.cin_slices, nk, pl.spp[2], pl, sm, ring,
                    [&](int s) {
                      return s < nk ? BSrc{&maps.w3, s * kSlice}
                                    : BSrc{&maps.wd, (s - nk) * kSlice};
                    },
                    [&](uint32_t st, uint32_t bar, int s, int g, bool dry) {
                      if (s < nk) return 0u;
                      if (!dry)  // x[2r, 2c] for the TH output rows, in output order
                        tma_load_4d(st, &maps.xs, bar, (s - nk) * kSlice, 0,
                                    it.c0 + g * pl.ph[2].mg() * kTileM, img * H + 2 * r0);
                      return (uint32_t)(TH * box_cols * kSlice * 2);
                    });
    }
    return;
  }

  // consumers: accumulator row of this thread (and 8 below), column pair
  const int wg = warp >> 2;
  const int qrow = (warp & 3) * 16 + (lane >> 2), qcol = (lane & 3) * 2;
  const uint32_t y2 = sm.y2;
  // phase 1's rows of pixels: the run's W, or x_row_tiles whole tiles a row,
  // which start at column 2 c0 - 1
  const int row1 = pl.x_row_tiles ? pl.x_row_tiles * kTileM : W, col1 = pl.x_row_tiles ? 0 : 1;
  for (int item = blockIdx.x; item < pl.items; item += gridDim.x) {
    const Item it = item_at(pl, item);
    const int img = it.img, r0 = it.r0, c0 = it.c0;

    // Phase 1: y1 for image rows [2 r0 - 1, 2 (r0 + TH) - 1] and columns
    // [2 c0 - 1, 2 (c0 + TW) - 1]; pixel i of phase 1 is tile row tr = i /
    // row1, tile column tc = i % row1 + col1 (image column 2 c0 - 1 + tc), and
    // lands in plane (tr % 2, tc % 2) at pixel (tr / 2) P + tc / 2.
    consume_phase(
        pl.ph[0], pl.cin_slices, 0, 1, pl, sm, ring, wg,
        [&](int, uint32_t st, int, int slot0) { return a_from_stage(st, slot0); },
        [&](float(&acc)[4][32], int m0, int mvalid, int n0) {
          const PhaseCfg& c = pl.ph[0];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int mi = i / c.nsub, ni = i % c.nsub;
            if (i >= c.mpw * c.nsub || mi >= mvalid) continue;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int pix = (m0 + mi) * kTileM + qrow + 8 * hh;
              const int tr = pix / row1, tc = pix % row1 + col1;
              if (tr >= 2 * TH + 1 || tc >= 2 * TW + 1) continue;
              const int irow = 2 * r0 - 1 + tr, icol = 2 * c0 - 1 + tc;
              const bool inside = irow >= 0 && irow < H && icol >= 0 && icol < W;
              const uint32_t plane = plane_at(tr & 1, tc & 1), rows = plane_rows(tr & 1);
              const int dst = (tr >> 1) * P + (tc >> 1);
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int col = n0 + ni * 64 + j * 8 + qcol;
                uint32_t v = 0u;  // outside the image: the conv's zero padding
                if (inside) {
                  const float2 b = ldg_f2(p.b1 + col);
                  v = pack_bf16(fmaxf(acc[i][4 * j + 2 * hh] + b.x, 0.f),
                                fmaxf(acc[i][4 * j + 2 * hh + 1] + b.y, 0.f));
                }
                st_plain(plane, rows, dst, col, v);
              }
            }
          }
        });
    fence_proxy_async();
    consumer_sync();

    // Phase 2: y2 = strided 3x3 conv over padded coordinates q = r P + c.
    consume_phase(
        pl.ph[1], 9 * nk, 9 * nk, pl.spp[1], pl, sm, ring, wg,
        [&](int s, uint32_t, int m0, int) {
          const int tap = s / nk, dy = tap / 3, dx = tap % 3;
          return a_from_plain(plane_at(dy & 1, dx & 1), plane_rows(dy & 1), s % nk,
                              m0 * kTileM + (dy >> 1) * P + (dx >> 1));
        },
        [&](float(&acc)[4][32], int m0, int mvalid, int n0) {
          const PhaseCfg& c = pl.ph[1];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int mi = i / c.nsub, ni = i % c.nsub;
            if (i >= c.mpw * c.nsub || mi >= mvalid) continue;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int q = (m0 + mi) * kTileM + qrow + 8 * hh;
              const int r = q / P, cc = q % P;
              if (r >= TH || cc >= TW) continue;  // padding column: computed, dropped
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int col = n0 + ni * 64 + j * 8 + qcol;
                const float2 b = ldg_f2(p.b2 + col);
                st_plain(y2, pl.y2_rows, r * TW + cc, col,
                         pack_bf16(fmaxf(acc[i][4 * j + 2 * hh] + b.x, 0.f),
                                   fmaxf(acc[i][4 * j + 2 * hh + 1] + b.y, 0.f)));
              }
            }
          }
        });
    fence_proxy_async();
    consumer_sync();

    // Phase 3: out = relu(y2 . w3 + x[2r, 2c] . wd + b3 + bd).
    const int m3 = TH * TW;
    consume_phase(
        pl.ph[2], nk + pl.cin_slices, nk, pl.spp[2], pl, sm, ring, wg,
        [&](int s, uint32_t st, int m0, int slot0) {
          return s < nk ? a_from_plain(y2, pl.y2_rows, s, m0 * kTileM)
                        : a_from_stage(st, slot0);
        },
        [&](float(&acc)[4][32], int m0, int mvalid, int n0) {
          const PhaseCfg& c = pl.ph[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int mi = i / c.nsub, ni = i % c.nsub;
            if (i >= c.mpw * c.nsub || mi >= mvalid) continue;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int q = (m0 + mi) * kTileM + qrow + 8 * hh;
              const int r = q / TW, cc = q % TW;
              if (q >= m3 || r0 + r >= H2 || c0 + cc >= W2) continue;
              __nv_bfloat16* dst = p.out + ((size_t)(img * H2 + r0 + r) * W2 + c0 + cc) * p.cout;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int col = n0 + ni * 64 + j * 8 + qcol;
                const float2 b3 = ldg_f2(p.b3 + col), bd = ldg_f2(p.bd + col);
                *reinterpret_cast<uint32_t*>(dst + col) =
                    pack_bf16(fmaxf(acc[i][4 * j + 2 * hh] + b3.x + bd.x, 0.f),
                              fmaxf(acc[i][4 * j + 2 * hh + 1] + b3.y + bd.y, 0.f));
              }
            }
          }
        });
  }
}

// The planner's cost, as the stride-1 kernel's. The projection's pixels come
// in one box per K slice and pass group, so phase 3 is one group of at most
// kMaxATiles tiles where a work item has more than one output row.
long plan_cost(Plan& c, const Level& L, int sms, int n, int h, int w, int cin, int cmid,
               int cout, int th, int tw) {
  const int h2 = h / 2, w2 = w / 2;
  const int k1 = 4 * ((cin + kSlice - 1) / kSlice), k2 = 9 * cmid / 16, k3 = cmid / 16 + k1;
  c = Plan{};
  c.th = th;
  c.tw = tw;
  c.col_tiles = (w2 + tw - 1) / tw;
  c.x_row_tiles = tw < w2 ? (2 * tw + 1 + kTileM - 1) / kTileM : 0;
  c.pitch = tw + 1;
  c.tiles_per_img = (h2 + th - 1) / th * c.col_tiles;
  c.items = n * c.tiles_per_img;
  c.cin_slices = (cin + kSlice - 1) / kSlice;
  c.cmid_slices = cmid / kSlice;
  const int mt1 =
      c.x_row_tiles ? (2 * th + 1) * c.x_row_tiles : ((2 * th + 1) * w + kTileM - 1) / kTileM;
  if (!choose_phase(c.ph[0], mt1, cmid, k1, L.max_x, L.max_nc) ||
      !choose_phase(c.ph[1], (th * c.pitch + kTileM - 1) / kTileM, cmid, k2, 1 << 20, L.max_nc) ||
      !choose_phase(c.ph[2], (th * tw + kTileM - 1) / kTileM, cout, k3,
                    th > 1 ? kMaxATiles : L.max_x, L.max_nc, th > 1))
    return -1;
  c.y2_rows = th * tw;
  const int layout = place(c, (size_t)2 * (2 * th + 1) * c.pitch * cmid * 2,
                           (size_t)c.y2_rows * cmid * 2,
                           std::min(c.ph[0].mg(), c.ph[0].mt) * kTileBytes,
                           std::min(c.ph[2].mg(), c.ph[2].mt) * kTileBytes, L.min_stages);
  if (!layout) return -1;
  const long cost = (long)((c.items + sms - 1) / sms) *
                    (phase_cost(c.ph[0], k1) + phase_cost(c.ph[1], k2) + phase_cost(c.ph[2], k3));
  return layout == 2 ? cost * 5 / 4 : cost;  // the compact ring measured ~20% slower
}

bool make_plan(Plan& best, int n, int h, int w, int cin, int cmid, int cout) {
  const int sms = num_sms();
  return search_plan(best, h / 2, w / 2, [&](Plan& c, const Level& L, int th, int tw) {
    return plan_cost(c, L, sms, n, h, w, cin, cmid, cout, th, tw);
  });
}

bool takes(int n, int h, int w, int cin, int cmid, int cout) {
  return n >= 1 && n <= 65535 && h >= 2 && w >= 2 && h % 2 == 0 && w % 2 == 0 &&
         cin % 16 == 0 && cmid % 64 == 0 && cout % 64 == 0 && cin >= 16 && cmid >= 64 &&
         cout >= 64;
}

}  // namespace

// Launches one fused stride-2 bottleneck on `stream`. The projection (wd, bd)
// is required; H and W must be even. Returns a cudaError_t: nonzero when the
// arguments are outside what the kernel takes or the launch failed.
extern "C" int geo_fused_bottleneck_s2(const void* x, const void* w1, const void* b1,
                                       const void* w2, const void* b2, const void* w3,
                                       const void* b3, const void* wd, const void* bd,
                                       void* out, int n, int h, int w, int cin, int cmid,
                                       int cout, void* stream) {
  if (!takes(n, h, w, cin, cmid, cout) || wd == nullptr || bd == nullptr)
    return (int)cudaErrorInvalidValue;
  Plan pl;
  if (!make_plan(pl, n, h, w, cin, cmid, cout)) return (int)cudaErrorInvalidValue;
  TmaMaps maps = {};
  // x[2r, 2c]: (Cin, column parity, W/2, N*H) with rows taken every second
  const cuuint64_t xs_dims[4] = {(uint64_t)cin, 2, (uint64_t)w / 2, (uint64_t)n * h};
  const cuuint64_t xs_strides[3] = {(uint64_t)cin * 2, (uint64_t)cin * 4, (uint64_t)w * cin * 2};
  const cuuint32_t xs_box[4] = {kSlice, 1, (uint32_t)proj_box_cols(pl),
                                2 * (uint32_t)pl.th};
  const cuuint32_t xs_estr[4] = {1, 1, 1, 2};
  if (!(encode_2d(&maps.x, x, cin, (uint64_t)n * h * w, kTileM) &&
        encode_2d(&maps.w1, w1, cin, cmid, pl.ph[0].nc()) &&
        encode_2d(&maps.w2, w2, 9 * (uint64_t)cmid, cmid, pl.ph[1].nc()) &&
        encode_2d(&maps.w3, w3, cmid, cout, pl.ph[2].nc()) &&
        encode_2d(&maps.wd, wd, cin, cout, pl.ph[2].nc()) &&
        encode(&maps.xs, x, 4, xs_dims, xs_strides, xs_box, xs_estr)))
    return (int)cudaErrorNotSupported;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b3 = static_cast<const float*>(b3);
  p.bd = static_cast<const float*>(bd);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cmid = cmid;
  p.cout = cout;
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_s2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = pl.items < num_sms() ? pl.items : num_sms();
  fused_bottleneck_s2_kernel<<<grid, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(
      maps, p, pl);
  return (int)cudaGetLastError();
}

// What the planner chose for a shape: out[0] dynamic shared memory bytes,
// out[1] blocks per SM, out[2] TH, out[3] ring stages, out[4] TW (output
// columns of a work item). Returns a cudaError_t.
extern "C" int geo_fused_bottleneck_s2_plan(int n, int h, int w, int cin, int cmid, int cout,
                                            int proj, int* out) {
  Plan pl;
  if (!proj || !takes(n, h, w, cin, cmid, cout) || !make_plan(pl, n, h, w, cin, cmid, cout))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_s2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_bottleneck_s2_kernel,
                                                      kThreads, pl.smem);
  out[0] = (int)pl.smem;
  out[1] = blocks;
  out[2] = pl.th;
  out[3] = pl.stages;
  out[4] = pl.tw;
  return (int)err;
}
