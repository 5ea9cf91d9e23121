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
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s), counting each
// input byte read once and each output byte written once, at the three shapes
// of the ten-crop ResNet50 main path with N = 80 crops:
//   56x56, 64 -> 64 -> 256 with projection: 37.0 GFLOP = 37 us; 161 MB = 48 us
//   56x56, 256 -> 64 -> 256 identity:        34.9 GFLOP = 35 us; 257 MB = 77 us
//   28x28, 512 -> 128 -> 512 identity:       34.9 GFLOP = 35 us; 129 MB = 38 us
// so the first two are bound by bytes and the third sits at the ridge. An
// unfused block also writes and reads back y1 and y2 (128 MB a block at the
// 56x56 shapes, 64 MB at 28x28) and launches three or four kernels.
//
// What the design does about it: one CUDA block owns one image and a tile of
// TH output rows. It computes y1 for rows [r0-1, r0+TH] into shared memory
// (halo rows recomputed from the block's own image, zero outside the image,
// two zero border columns), then the 3x3 conv into a y2 tile in shared memory,
// then conv3, the residual and relu straight to the output. x is read from
// device memory for conv1 and the residual, the output written once, and y1
// and y2 never leave the SM. The products run on the tensor cores through
// mma.sync m16n8k16 (bf16 in, fp32 accumulate); the A fragments come from
// shared memory (y1, y2) or from x, the B fragments from the weights in L2.
// Each warp owns a 16-pixel by 64-channel tile of a product at a time. No
// TMA, wgmma or pipelining yet: this kernel is the simple correct version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;            // output channels of one warp work item
constexpr int kNT = kChunk / 8;       // mma n-tiles per work item
constexpr int kPad = 8;               // bf16 padding per shared-memory pixel
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
  const __nv_bfloat16* wd;  // (Cout, Cin), projection only
  const float* bd;          // (Cout), projection only
  __nv_bfloat16* out;       // (N, H, W, Cout)
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

template <bool kProj>
__global__ void __launch_bounds__(kThreads)
fused_bottleneck_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int img = blockIdx.y;
  const int r0 = blockIdx.x * p.th;
  const int H = p.h, W = p.w, wp = p.w + 2;
  const int ldm = p.cmid + kPad;
  // y1 tile: (TH + 2, W + 2, ldm); y2 tile: (TH * W, ldm)
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* y2s = y1s + (size_t)(p.th + 2) * wp * ldm;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* ximg = p.x + (size_t)img * H * W * p.cin;

  // Zero the left and right border columns of every y1 row.
  {
    const int words = p.cmid / 2;
    for (int i = threadIdx.x; i < (p.th + 2) * 2 * words; i += kThreads) {
      const int r = i / (2 * words), side = (i / words) & 1, c = i % words;
      uint32_t* px = reinterpret_cast<uint32_t*>(
          y1s + ((size_t)r * wp + (side ? wp - 1 : 0)) * ldm);
      px[c] = 0u;
    }
  }

  // Phase 1: y1 for image rows [r0 - 1, r0 + TH].
  const int m1 = (p.th + 2) * W;
  const int nch1 = p.cmid / kChunk;
  for (int item = warp; item < ((m1 + 15) / 16) * nch1; item += kWarps) {
    const int mt = item / nch1, n0 = (item % nch1) * kChunk;
    const __nv_bfloat16* arow[2];
    bool inside[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int pix = mt * 16 + g + 8 * hh;
      const int irow = r0 - 1 + pix / W;
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
      __nv_bfloat16* dst = y1s + ((size_t)(pix / W) * wp + pix % W + 1) * ldm + n0;
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

  // Phase 2: y2 = 3x3 conv of the y1 tile, for the TH output rows.
  const int m2 = p.th * W;
  const int mt2 = (m2 + 15) / 16;
  for (int item = warp; item < mt2 * nch1; item += kWarps) {
    const int mt = item / nch1, n0 = (item % nch1) * kChunk;
    const __nv_bfloat16* abase[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      int q = mt * 16 + g + 8 * hh;
      if (q >= m2) q = 0;  // padding rows of the last m-tile: computed, never stored
      abase[hh] = y1s + ((size_t)(q / W) * wp + q % W) * ldm + 2 * t;
    }
    float acc[kNT][4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const size_t off = (size_t)((tap / 3) * wp + tap % 3) * ldm;
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
      __nv_bfloat16* dst = y2s + (size_t)q * ldm + n0;
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

  // Phase 3: out = relu(y2 . w3 + b3 + residual).
  const int nch3 = p.cout / kChunk;
  for (int item = warp; item < mt2 * nch3; item += kWarps) {
    const int mt = item / nch3, n0 = (item % nch3) * kChunk;
    const __nv_bfloat16* yrow[2];
    const __nv_bfloat16* xrow[2];
    bool valid[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = mt * 16 + g + 8 * hh;
      valid[hh] = q < m2 && r0 + q / W < H;
      const int qq = valid[hh] ? q : 0;
      yrow[hh] = y2s + (size_t)qq * ldm + 2 * t;
      xrow[hh] = ximg + ((size_t)(r0 + qq / W) * W + qq % W) * p.cin;
    }
    float acc[kNT][4] = {};
    for (int k0 = 0; k0 < p.cmid; k0 += 16) {
      const uint32_t a[4] = {lds32(yrow[0] + k0), lds32(yrow[1] + k0),
                             lds32(yrow[0] + k0 + 8), lds32(yrow[1] + k0 + 8)};
      mma_chunk(acc, a, p.w3 + k0, p.cmid, n0, g, t);
    }
    float res[kNT][4] = {};
    if constexpr (kProj) {
      for (int k0 = 0; k0 < p.cin; k0 += 16) {
        const uint32_t a[4] = {ldg32(xrow[0] + k0 + 2 * t), ldg32(xrow[1] + k0 + 2 * t),
                               ldg32(xrow[0] + k0 + 8 + 2 * t),
                               ldg32(xrow[1] + k0 + 8 + 2 * t)};
        mma_chunk(res, a, p.wd + k0, p.cin, n0, g, t);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!valid[hh]) continue;
      const int q = mt * 16 + g + 8 * hh;
      __nv_bfloat16* dst =
          p.out + (((size_t)img * H + r0 + q / W) * W + q % W) * p.cout + n0;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = j * 8 + 2 * t;
        const float2 b3 = ldg_f2(p.b3 + n0 + n);
        float r_lo, r_hi;
        if constexpr (kProj) {
          const float2 bd = ldg_f2(p.bd + n0 + n);
          r_lo = res[j][2 * hh] + bd.x;
          r_hi = res[j][2 * hh + 1] + bd.y;
        } else {
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(xrow[hh] + n0 + n);
          r_lo = __low2float(xv);
          r_hi = __high2float(xv);
        }
        *reinterpret_cast<uint32_t*>(dst + n) =
            pack_bf16(fmaxf(acc[j][2 * hh] + b3.x + r_lo, 0.f),
                      fmaxf(acc[j][2 * hh + 1] + b3.y + r_hi, 0.f));
      }
    }
  }
}

size_t smem_bytes(int th, int w, int cmid) {
  return ((size_t)(th + 2) * (w + 2) + (size_t)th * w) * (cmid + kPad) * sizeof(__nv_bfloat16);
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
  if (n < 1 || n > 65535 || h < 1 || w < 1 || cin % 16 || cmid % kChunk ||
      cout % kChunk || cin < 16 || cmid < kChunk || cout < kChunk ||
      (proj != (bd != nullptr)) || (!proj && cin != cout))
    return (int)cudaErrorInvalidValue;
  int th = kRowsPerTile < h ? kRowsPerTile : h;
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

  void (*kern)(Params) = proj ? fused_bottleneck_kernel<true> : fused_bottleneck_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((h + th - 1) / th, n);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
