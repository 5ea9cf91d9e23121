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
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s), counting each
// input byte read once and each output byte written once, at the stage entry
// of layer2 of the ten-crop ResNet50 main path (56x56, 256 -> 128 -> 512,
// N = 80 crops): 59.6 GFLOP = 60 us against 193 MB = 58 us, so it sits at
// the ridge, on the side of the operations. An unfused block also writes and
// reads back y1 (full resolution, 64 MB) and y2 (16 MB).
//
// What the design does about it: the scheme of the stride-1 kernel
// (fused_bottleneck.cu). One CUDA block owns one image and a tile of TH
// output rows [r0, r0 + TH). Those rows read y1 rows [2 r0 - 1, 2 (r0 + TH) - 1]
// (2 TH + 1 rows: the top one is the halo, recomputed from the block's own
// image, zero above the image) and y1 columns -1 .. W - 1 (one zero border
// column on the left; for even H and W the bottom and right padding is never
// read). The block computes that y1 tile into shared memory, then the
// strided 3x3 conv into a y2 tile in shared memory, then conv3, the strided
// projection of x (read straight from x[2r, 2c]), the residual and relu to
// the output. y1 and y2 never leave the SM. The products run on the tensor
// cores through mma.sync m16n8k16 (bf16 in, fp32 accumulate); each warp owns
// a 16-pixel by 64-channel tile of a product at a time. The 3x3 conv reads
// every second pixel of the y1 tile, so the y1 pitch is Cmid + 4 (two pixels
// apart = 4 banks apart) to keep the 8 rows of an A fragment in 8 distinct
// bank groups; the y2 tile is read pixel by pixel and keeps Cmid + 8. No TMA,
// wgmma or pipelining yet: this kernel is the simple correct version.
//
// It has its own copies of the few mma and load helpers of the stride-1
// kernel: each source is built on its own and its build is keyed on its own
// bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;            // output channels of one warp work item
constexpr int kNT = kChunk / 8;       // mma n-tiles per work item
constexpr int kPad1 = 4;              // bf16 padding per pixel of the y1 tile
constexpr int kPad2 = 8;              // bf16 padding per pixel of the y2 tile
constexpr int kRowsPerTile = 4;       // TH, lowered only if shared memory runs out
constexpr size_t kMaxSmem = 227 * 1024;

struct Params {
  const __nv_bfloat16* x;   // (N, H, W, Cin)
  const __nv_bfloat16* w1;  // (Cmid, Cin)
  const float* b1;          // (Cmid)
  const __nv_bfloat16* w2;  // (Cmid, 3, 3, Cmid): out, dy, dx, in
  const float* b2;          // (Cmid)
  const __nv_bfloat16* w3;  // (Cout, Cmid)
  const float* b3;          // (Cout)
  const __nv_bfloat16* wd;  // (Cout, Cin)
  const float* bd;          // (Cout)
  __nv_bfloat16* out;       // (N, H / 2, W / 2, Cout)
  int h, w, cin, cmid, cout, th;
};

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring bf16 values as one 32-bit word, lower address in the low half.
__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 ldg_f2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// One k-step of a 16 x 64 tile: A fragment given, B rows from a (N, K) matrix
// with K contiguous, `ld` elements apart, starting at channel n0 and depth k.
__device__ __forceinline__ void mma_chunk(float acc[kNT][4], const uint32_t a[4],
                                          const __nv_bfloat16* b, size_t ld,
                                          int n0, int g, int t) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const __nv_bfloat16* row = b + (size_t)(n0 + j * 8 + g) * ld + 2 * t;
    mma_bf16(acc[j], a, ldg32(row), ldg32(row + 8));
  }
}

__global__ void __launch_bounds__(kThreads)
fused_bottleneck_s2_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int img = blockIdx.y;
  const int r0 = blockIdx.x * p.th;  // first output row of this block
  const int H = p.h, W = p.w, H2 = p.h / 2, W2 = p.w / 2;
  const int wp = W + 1;              // y1 tile columns -1 .. W - 1
  const int rows1 = 2 * p.th + 1;    // y1 tile rows 2 r0 - 1 .. 2 (r0 + TH) - 1
  const int ld1 = p.cmid + kPad1, ld2 = p.cmid + kPad2;
  // y1 tile: (2 TH + 1, W + 1, ld1); y2 tile: (TH * W / 2, ld2)
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* y2s = y1s + (size_t)rows1 * wp * ld1;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* ximg = p.x + (size_t)img * H * W * p.cin;

  // Zero the left border column (y1 column -1) of every tile row.
  {
    const int words = p.cmid / 2;
    for (int i = threadIdx.x; i < rows1 * words; i += kThreads) {
      uint32_t* px = reinterpret_cast<uint32_t*>(y1s + (size_t)(i / words) * wp * ld1);
      px[i % words] = 0u;
    }
  }

  // Phase 1: y1 for image rows [2 r0 - 1, 2 (r0 + TH) - 1], every column.
  const int m1 = rows1 * W;
  const int nch1 = p.cmid / kChunk;
  for (int item = warp; item < ((m1 + 15) / 16) * nch1; item += kWarps) {
    const int mt = item / nch1, n0 = (item % nch1) * kChunk;
    const __nv_bfloat16* arow[2];
    bool inside[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int pix = mt * 16 + g + 8 * hh;
      const int irow = 2 * r0 - 1 + pix / W;
      inside[hh] = pix < m1 && irow >= 0 && irow < H;
      arow[hh] = ximg + (inside[hh] ? ((size_t)irow * W + pix % W) * p.cin : 0) + 2 * t;
    }
    float acc[kNT][4] = {};
    for (int k0 = 0; k0 < p.cin; k0 += 16) {
      const uint32_t a[4] = {
          inside[0] ? ldg32(arow[0] + k0) : 0u, inside[1] ? ldg32(arow[1] + k0) : 0u,
          inside[0] ? ldg32(arow[0] + k0 + 8) : 0u, inside[1] ? ldg32(arow[1] + k0 + 8) : 0u};
      mma_chunk(acc, a, p.w1 + k0, p.cin, n0, g, t);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int pix = mt * 16 + g + 8 * hh;
      if (pix >= m1) continue;
      __nv_bfloat16* dst = y1s + ((size_t)(pix / W) * wp + pix % W + 1) * ld1 + n0;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = j * 8 + 2 * t;
        uint32_t v = 0u;  // rows outside the image are the conv's zero padding
        if (inside[hh]) {
          const float2 b = ldg_f2(p.b1 + n0 + n);
          v = pack_bf16(fmaxf(acc[j][2 * hh] + b.x, 0.f),
                        fmaxf(acc[j][2 * hh + 1] + b.y, 0.f));
        }
        *reinterpret_cast<uint32_t*>(dst + n) = v;
      }
    }
  }
  __syncthreads();

  // Phase 2: y2 = strided 3x3 conv of the y1 tile, for the TH output rows.
  // Output pixel (r, c) of the tile reads tile row 2 r + dy, tile column 2 c + dx.
  const int m2 = p.th * W2;
  const int mt2 = (m2 + 15) / 16;
  for (int item = warp; item < mt2 * nch1; item += kWarps) {
    const int mt = item / nch1, n0 = (item % nch1) * kChunk;
    const __nv_bfloat16* abase[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      int q = mt * 16 + g + 8 * hh;
      if (q >= m2) q = 0;  // padding rows of the last m-tile: computed, never stored
      abase[hh] = y1s + ((size_t)(2 * (q / W2)) * wp + 2 * (q % W2)) * ld1 + 2 * t;
    }
    float acc[kNT][4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const size_t off = (size_t)((tap / 3) * wp + tap % 3) * ld1;
      const __nv_bfloat16* wt = p.w2 + (size_t)tap * p.cmid;
      for (int k0 = 0; k0 < p.cmid; k0 += 16) {
        const uint32_t a[4] = {
            lds32(abase[0] + off + k0), lds32(abase[1] + off + k0),
            lds32(abase[0] + off + k0 + 8), lds32(abase[1] + off + k0 + 8)};
        mma_chunk(acc, a, wt + k0, (size_t)9 * p.cmid, n0, g, t);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = mt * 16 + g + 8 * hh;
      if (q >= m2) continue;
      __nv_bfloat16* dst = y2s + (size_t)q * ld2 + n0;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = j * 8 + 2 * t;
        const float2 b = ldg_f2(p.b2 + n0 + n);
        *reinterpret_cast<uint32_t*>(dst + n) =
            pack_bf16(fmaxf(acc[j][2 * hh] + b.x, 0.f), fmaxf(acc[j][2 * hh + 1] + b.y, 0.f));
      }
    }
  }
  __syncthreads();

  // Phase 3: out = relu(y2 . w3 + b3 + x[2r, 2c] . wd + bd).
  const int nch3 = p.cout / kChunk;
  for (int item = warp; item < mt2 * nch3; item += kWarps) {
    const int mt = item / nch3, n0 = (item % nch3) * kChunk;
    const __nv_bfloat16* yrow[2];
    const __nv_bfloat16* xrow[2];
    bool valid[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = mt * 16 + g + 8 * hh;
      valid[hh] = q < m2 && r0 + q / W2 < H2;
      const int qq = valid[hh] ? q : 0;
      yrow[hh] = y2s + (size_t)qq * ld2 + 2 * t;
      xrow[hh] = ximg + ((size_t)(2 * (r0 + qq / W2)) * W + 2 * (qq % W2)) * p.cin + 2 * t;
    }
    float acc[kNT][4] = {};
    for (int k0 = 0; k0 < p.cmid; k0 += 16) {
      const uint32_t a[4] = {lds32(yrow[0] + k0), lds32(yrow[1] + k0),
                             lds32(yrow[0] + k0 + 8), lds32(yrow[1] + k0 + 8)};
      mma_chunk(acc, a, p.w3 + k0, p.cmid, n0, g, t);
    }
    float res[kNT][4] = {};
    for (int k0 = 0; k0 < p.cin; k0 += 16) {
      const uint32_t a[4] = {ldg32(xrow[0] + k0), ldg32(xrow[1] + k0),
                             ldg32(xrow[0] + k0 + 8), ldg32(xrow[1] + k0 + 8)};
      mma_chunk(res, a, p.wd + k0, p.cin, n0, g, t);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!valid[hh]) continue;
      const int q = mt * 16 + g + 8 * hh;
      __nv_bfloat16* dst =
          p.out + (((size_t)img * H2 + r0 + q / W2) * W2 + q % W2) * p.cout + n0;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = j * 8 + 2 * t;
        const float2 b3 = ldg_f2(p.b3 + n0 + n);
        const float2 bd = ldg_f2(p.bd + n0 + n);
        *reinterpret_cast<uint32_t*>(dst + n) =
            pack_bf16(fmaxf(acc[j][2 * hh] + b3.x + (res[j][2 * hh] + bd.x), 0.f),
                      fmaxf(acc[j][2 * hh + 1] + b3.y + (res[j][2 * hh + 1] + bd.y), 0.f));
      }
    }
  }
}

size_t smem_bytes(int th, int w, int cmid) {
  return ((size_t)(2 * th + 1) * (w + 1) * (cmid + kPad1) +
          (size_t)th * (w / 2) * (cmid + kPad2)) * sizeof(__nv_bfloat16);
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
  if (n < 1 || n > 65535 || h < 2 || w < 2 || h % 2 || w % 2 || cin % 16 ||
      cmid % kChunk || cout % kChunk || cin < 16 || cmid < kChunk || cout < kChunk ||
      wd == nullptr || bd == nullptr)
    return (int)cudaErrorInvalidValue;
  const int h2 = h / 2;
  int th = kRowsPerTile < h2 ? kRowsPerTile : h2;
  while (th > 1 && smem_bytes(th, w, cmid) > kMaxSmem) --th;
  const size_t smem = smem_bytes(th, w, cmid);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;

  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.w3 = static_cast<const __nv_bfloat16*>(w3);
  p.b3 = static_cast<const float*>(b3);
  p.wd = static_cast<const __nv_bfloat16*>(wd);
  p.bd = static_cast<const float*>(bd);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cmid = cmid;
  p.cout = cout;
  p.th = th;

  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_s2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((h2 + th - 1) / th, n);
  fused_bottleneck_s2_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
