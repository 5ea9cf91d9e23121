// Fused stride-1 ResNet bottleneck for inference (BatchNorm folded), bf16 in
// and out, fp32 accumulation, for Hopper (sm_90a).
//
// Replaces geoestimation_tpu/ops/fused_bottleneck.py::fused_bottleneck, the
// Pallas TPU kernel. It computes the same function with the same rounding
// points:
//   y1  = bf16(relu(f32(x . w1) + b1))                      1x1 conv
//   y2  = bf16(relu(sum of 9 taps f32(y1 . w2[tap]) + b2))   3x3 conv, pad 1
//   y3  = f32(y2 . w3) + b3                                  1x1 conv, not rounded
//   res = f32(x . wd) + bd   or   f32(x)                     projection or identity
//   out = bf16(relu(y3 + res))
// (with a projection, y2 . w3 and x . wd share one fp32 accumulator.)
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s), counting each
// input byte read once and each output byte written once, at the three shapes
// of the ten-crop ResNet50 main path with N = 80 crops:
//   56x56, 64 -> 64 -> 256 with projection: 37.0 GFLOP = 37 us; 161 MB = 48 us
//   56x56, 256 -> 64 -> 256 identity:        34.9 GFLOP = 35 us; 257 MB = 77 us
//   28x28, 512 -> 128 -> 512 identity:       34.9 GFLOP = 35 us; 129 MB = 38 us
// so the first two are bound by bytes and the third sits at the ridge.
//
// What the design does about it (the core is bottleneck_sm90.cuh): a work
// item is one image and TH output rows; a persistent grid walks the items.
// Phase 1 computes y1 for image rows [r0 - 1, r0 + TH] (halo rows recomputed,
// zero outside the image) from x tiles of 64 consecutive pixels: the rows
// [r0 - 1, r0 + TH] of an NHWC image are one run of pixels, so a 2-D tensor
// map (Cin, N*H*W) gives them, and the pixels it fetches outside the image
// only feed rows that are forced to zero. y1 lands in one plane of
// (TH + 2) x (W + 2) pixels with two zero border columns; phase 2 runs the
// 3x3 conv over the plane's padded pixel coordinates, tap (dy, dx) being the
// same A tile shifted by dy (W + 2) + dx pixels, into y2 (TH x W pixels);
// phase 3 runs conv3 (and the projection, from x tiles of the TH output rows)
// and writes relu(y3 + res) to the output. Weights stream through the ring
// by TMA once per pass, so one slice serves every m-tile of the pass. Where
// rows are too wide for even one whole row's tiles, a work item is one
// output row and TW output columns: phase 1 then loads each of its three
// y1 rows (TW + 2 pixels from column c0 - 1) as tiles of its own, and the
// columns outside the image are zero like the rows.
//
// Shared memory: y1 = (TH + 2)(TW + 2) Cmid 2 B, y2 = TH TW Cmid 2 B (TW = W
// but for column tiles), and a ring of stages of (x tiles + weight slice).
// The planner (plan_cost, search_plan) picks TH, TW, each phase's split and
// the ring to minimise a count of 64x64x16 products per SM; at N = 640 it
// gives one block of 288 threads per SM and
//   56x56 64-64-256 proj:  TH 4, 2 stages, 205,824 B
//   56x56 256-64-256:      TH 4, 3 stages, 222,208 B
//   28x28 512-128-512:     TH 4, 2 stages, 190,464 B
// (geo_fused_bottleneck_plan reports it for any shape; chip_smoke.py prints
// it on each kernel-check line).

#include "bottleneck_sm90.cuh"

using namespace geo_sm90;

namespace {

struct Params {
  const __nv_bfloat16* x;   // (N, H, W, Cin)
  const float* b1;          // (Cmid)
  const float* b2;          // (Cmid)
  const float* b3;          // (Cout)
  const float* bd;          // (Cout), projection only
  __nv_bfloat16* out;       // (N, H, W, Cout)
  int h, w, cin, cmid, cout;
};

template <bool kProj>
__global__ void __launch_bounds__(kThreads, 1)
fused_bottleneck_kernel(const __grid_constant__ TmaMaps maps, const __grid_constant__ Params p,
                        const __grid_constant__ Plan pl) {
  extern __shared__ unsigned char dyn[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  const Smem sm = setup_block(dyn, bars, pl);
  const int H = p.h, W = p.w, P = pl.pitch, TH = pl.th, TW = pl.tw;
  // warp-uniform to the compiler too (a broadcast), so that the roles'
  // branches and the warpgroups' passes do not count as divergent
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int nk = pl.cmid_slices;
  Ring ring;

  if (warp == kConsumerThreads / 32) {  // producer
    if (lane != 0) return;
    for (int item = blockIdx.x; item < pl.items; item += gridDim.x) {
      const Item it = item_at(pl, item);
      const int img = it.img, r0 = it.r0;
      const int pix1 = (img * H + r0 - 1) * W + it.c0 - (pl.x_row_tiles ? 1 : 0);
      const int pix3 = (img * H + r0) * W + it.c0;
      produce_phase(pl.ph[0], pl.cin_slices, 0, 1, pl, sm, ring,
                    [&](int s) { return BSrc{&maps.w1, s * kSlice}; },
                    [&](uint32_t st, uint32_t bar, int s, int g, bool dry) {
                      return load_x_tiles(&maps.x, pl.ph[0], st, bar, s, g, pix1,
                                          pl.x_row_tiles, W, dry);
                    });
      produce_phase(pl.ph[1], 9 * nk, 9 * nk, pl.spp[1], pl, sm, ring,
                    [&](int s) { return BSrc{&maps.w2, (s / nk) * p.cmid + (s % nk) * kSlice}; },
                    NoA());
      produce_phase(pl.ph[2], nk + (kProj ? pl.cin_slices : 0), nk, pl.spp[2], pl, sm, ring,
                    [&](int s) {
                      return s < nk ? BSrc{&maps.w3, s * kSlice}
                                    : BSrc{&maps.wd, (s - nk) * kSlice};
                    },
                    [&](uint32_t st, uint32_t bar, int s, int g, bool dry) {
                      return s < nk ? 0u
                                    : load_x_tiles(&maps.x, pl.ph[2], st, bar, s - nk, g, pix3,
                                                   0, 0, dry);
                    });
    }
    return;
  }

  // consumers: accumulator row of this thread (and 8 below), column pair
  const int wg = warp >> 2;
  const int qrow = (warp & 3) * 16 + (lane >> 2), qcol = (lane & 3) * 2;
  const uint32_t y1 = sm.base, y2 = sm.y2;
  // phase 1's rows of pixels: the run's W, or x_row_tiles whole tiles a row,
  // which start at column c0 - 1
  const int row1 = pl.x_row_tiles ? pl.x_row_tiles * kTileM : W, col1 = pl.x_row_tiles ? 0 : 1;
  for (int item = blockIdx.x; item < pl.items; item += gridDim.x) {
    const Item it = item_at(pl, item);
    const int img = it.img, r0 = it.r0, c0 = it.c0;

    // Phase 1: y1 for image rows [r0 - 1, r0 + TH] and columns [c0 - 1,
    // c0 + TW]; pixel i of phase 1 is plane pixel (i / row1) P + i % row1 +
    // col1, image column c0 - 1 + that.
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
              if (tr >= TH + 2 || tc >= P) continue;
              const int irow = r0 - 1 + tr, icol = c0 - 1 + tc;
              const bool inside = irow >= 0 && irow < H && icol >= 0 && icol < W;
              const int dst = tr * P + tc;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int col = n0 + ni * 64 + j * 8 + qcol;
                uint32_t v = 0u;  // outside the image: the conv's zero padding
                if (inside) {
                  const float2 b = ldg_f2(p.b1 + col);
                  v = pack_bf16(fmaxf(acc[i][4 * j + 2 * hh] + b.x, 0.f),
                                fmaxf(acc[i][4 * j + 2 * hh + 1] + b.y, 0.f));
                }
                st_plain(y1, pl.y1_rows, dst, col, v);
              }
            }
          }
        });
    fence_proxy_async();
    consumer_sync();

    // Phase 2: y2 = 3x3 conv over padded coordinates q = r P + c.
    consume_phase(
        pl.ph[1], 9 * nk, 9 * nk, pl.spp[1], pl, sm, ring, wg,
        [&](int s, uint32_t, int m0, int) {
          const int tap = s / nk;
          return a_from_plain(y1, pl.y1_rows, s % nk, m0 * kTileM + (tap / 3) * P + tap % 3);
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
              if (r >= TH || cc >= TW) continue;  // padding columns: computed, dropped
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

    // Phase 3: out = relu(y2 . w3 + b3 + residual).
    const int m3 = TH * TW;
    consume_phase(
        pl.ph[2], nk + (kProj ? pl.cin_slices : 0), nk, pl.spp[2], pl, sm, ring, wg,
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
              if (q >= m3 || r0 + r >= H || c0 + cc >= W) continue;
              const size_t pix = (size_t)(img * H + r0 + r) * W + c0 + cc;
              __nv_bfloat16* dst = p.out + pix * p.cout;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int col = n0 + ni * 64 + j * 8 + qcol;
                const float2 b3 = ldg_f2(p.b3 + col);
                float r_lo, r_hi;
                if constexpr (kProj) {
                  const float2 bd = ldg_f2(p.bd + col);
                  r_lo = bd.x;
                  r_hi = bd.y;
                } else {
                  const __nv_bfloat162 xv =
                      *reinterpret_cast<const __nv_bfloat162*>(p.x + pix * p.cin + col);
                  r_lo = __low2float(xv);
                  r_hi = __high2float(xv);
                }
                *reinterpret_cast<uint32_t*>(dst + col) =
                    pack_bf16(fmaxf(acc[i][4 * j + 2 * hh] + b3.x + r_lo, 0.f),
                              fmaxf(acc[i][4 * j + 2 * hh + 1] + b3.y + r_hi, 0.f));
              }
            }
          }
        });
  }
}

// The planner's cost of TH x TW output pixels a work item at level L (the
// count of 64x64x16 products per SM over the grid; bottleneck_sm90.cuh's
// search_plan picks among them), -1 where the tiles do not fit.
long plan_cost(Plan& c, const Level& L, int sms, int n, int h, int w, int cin, int cmid,
               int cout, bool proj, int th, int tw) {
  const int k1 = 4 * ((cin + kSlice - 1) / kSlice), k2 = 9 * cmid / 16,
            k3 = cmid / 16 + (proj ? k1 : 0);
  c = Plan{};
  c.th = th;
  c.tw = tw;
  c.col_tiles = (w + tw - 1) / tw;
  c.x_row_tiles = tw < w ? (tw + 2 + kTileM - 1) / kTileM : 0;
  c.pitch = tw + 2;
  c.tiles_per_img = (h + th - 1) / th * c.col_tiles;
  c.items = n * c.tiles_per_img;
  c.cin_slices = (cin + kSlice - 1) / kSlice;
  c.cmid_slices = cmid / kSlice;
  const int mt1 = c.x_row_tiles ? (th + 2) * c.x_row_tiles : ((th + 2) * w + kTileM - 1) / kTileM;
  if (!choose_phase(c.ph[0], mt1, cmid, k1, L.max_x, L.max_nc) ||
      !choose_phase(c.ph[1], (th * c.pitch + kTileM - 1) / kTileM, cmid, k2, 1 << 20, L.max_nc) ||
      !choose_phase(c.ph[2], (th * tw + kTileM - 1) / kTileM, cout, k3, proj ? L.max_x : 1 << 20,
                    L.max_nc))
    return -1;
  c.y1_rows = (th + 2) * c.pitch;
  c.y2_rows = th * tw;
  const int a1 = std::min(c.ph[0].mg(), c.ph[0].mt);
  const int a3 = proj ? std::min(c.ph[2].mg(), c.ph[2].mt) : 0;
  const int layout = place(c, (size_t)c.y1_rows * cmid * 2, (size_t)c.y2_rows * cmid * 2,
                           a1 * kTileBytes, a3 * kTileBytes, L.min_stages);
  if (!layout) return -1;
  const long cost = (long)((c.items + sms - 1) / sms) *
                    (phase_cost(c.ph[0], k1) + phase_cost(c.ph[1], k2) + phase_cost(c.ph[2], k3));
  return layout == 2 ? cost * 5 / 4 : cost;  // the compact ring measured ~20% slower
}

bool make_plan(Plan& best, int n, int h, int w, int cin, int cmid, int cout, bool proj) {
  const int sms = num_sms();
  return search_plan(best, h, w, [&](Plan& c, const Level& L, int th, int tw) {
    return plan_cost(c, L, sms, n, h, w, cin, cmid, cout, proj, th, tw);
  });
}

bool takes(int n, int h, int w, int cin, int cmid, int cout, bool proj) {
  return n >= 1 && n <= 65535 && h >= 1 && w >= 1 && cin % 16 == 0 && cmid % 64 == 0 &&
         cout % 64 == 0 && cin >= 16 && cmid >= 64 && cout >= 64 && (proj || cin == cout);
}

void (*kernel_for(bool proj))(TmaMaps, Params, Plan) {
  return proj ? fused_bottleneck_kernel<true> : fused_bottleneck_kernel<false>;
}

}  // namespace

// Launches one fused bottleneck on `stream`. `wd` and `bd` are null for the
// identity residual (then cin == cout). Returns a cudaError_t: nonzero when
// the arguments are outside what the kernel takes or the launch failed.
extern "C" int geo_fused_bottleneck(const void* x, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* w3,
                                    const void* b3, const void* wd, const void* bd,
                                    void* out, int n, int h, int w, int cin, int cmid,
                                    int cout, void* stream) {
  const bool proj = wd != nullptr;
  if (!takes(n, h, w, cin, cmid, cout, proj) || proj != (bd != nullptr))
    return (int)cudaErrorInvalidValue;
  Plan pl;
  if (!make_plan(pl, n, h, w, cin, cmid, cout, proj)) return (int)cudaErrorInvalidValue;
  TmaMaps maps = {};
  if (!(encode_2d(&maps.x, x, cin, (uint64_t)n * h * w, kTileM) &&
        encode_2d(&maps.w1, w1, cin, cmid, pl.ph[0].nc()) &&
        encode_2d(&maps.w2, w2, 9 * (uint64_t)cmid, cmid, pl.ph[1].nc()) &&
        encode_2d(&maps.w3, w3, cmid, cout, pl.ph[2].nc()) &&
        (!proj || encode_2d(&maps.wd, wd, cin, cout, pl.ph[2].nc()))))
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
  auto kern = kernel_for(proj);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = pl.items < num_sms() ? pl.items : num_sms();
  kern<<<grid, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(maps, p, pl);
  return (int)cudaGetLastError();
}

// What the planner chose for a shape: out[0] dynamic shared memory bytes,
// out[1] blocks per SM, out[2] TH, out[3] ring stages, out[4] TW (output
// columns of a work item). Returns a cudaError_t.
extern "C" int geo_fused_bottleneck_plan(int n, int h, int w, int cin, int cmid, int cout,
                                         int proj, int* out) {
  Plan pl;
  if (!takes(n, h, w, cin, cmid, cout, proj != 0) ||
      !make_plan(pl, n, h, w, cin, cmid, cout, proj != 0))
    return (int)cudaErrorInvalidValue;
  auto kern = kernel_for(proj != 0);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, pl.smem);
  out[0] = (int)pl.smem;
  out[1] = blocks;
  out[2] = pl.th;
  out[3] = pl.stages;
  out[4] = pl.tw;
  return (int)err;
}
