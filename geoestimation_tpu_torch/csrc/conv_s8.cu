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
// output, res_scale = s_y3 / s_out, on the downsample conv.
//
// The convolution is an implicit GEMM: M = N*Ho*Wo output pixels, N = Cout,
// K = KH*KW*Cin in (ky, kx, c) order; activations NHWC int8, weights
// (Cout, K) int8, laid out once on the host. Zero padding is exact because
// every padded input is post-relu (zero at zero); the stem runs as a VALID
// 4x4 conv over its space-to-depth buffer, with Ho, Wo given.
//
// What bounds it on an H100 (1,979 TOP/s int8, 3.35 TB/s): the ten-crop
// ResNet50 forward's 53 convolutions do about 2.7e12 multiply-adds at
// N = 640 crops (2.7 ms at the int8 peak) and must move about 17.6 GB of
// int8 inputs, residuals, outputs and weights, each once (5.2 ms), so the
// forward as a whole is bound by bytes; only the 3x3 convolutions past
// layer1 and the 1x1 convolutions of layer4 are bound by operations.
//
// What this first design does about it: little -- it is simple and right.
// A 128-pixel x 64-channel output tile per block of 4 warps (each 64 x 32),
// K in chunks of 64 bytes through a two-stage cp.async ring (zero-filled
// for padding and for pixels or channels past the edge),
// mma.sync m16n8k32 s8 products from shared memory rows padded to 80 bytes
// (conflict-free fragment loads), and the epilogue straight from the
// accumulator fragments (2-byte stores). Not yet: wgmma s8, TMA, a
// persistent grid, an output tile staged through shared memory, the stem
// and the pool fused (ROADMAP.md Queue 2b).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;               // output pixels per block
constexpr int kBN = 64;                // output channels per block
constexpr int kBK = 64;                // K bytes per chunk
constexpr int kRow = kBK + 16;         // shared row stride in bytes
constexpr int kThreads = 128;          // 4 warps: 2 (pixels) x 2 (channels)
constexpr int kPieces = kBK / 16;      // 16-byte pieces per row of a chunk

struct Params {
  const int8_t* x;       // (N, H, W, Cin)
  const int8_t* wgt;     // (Cout, K)
  const float* mult;     // (Cout)
  const float* bias;     // (Cout)
  const int8_t* res;     // (N, Ho, Wo, Cout) or null
  int8_t* out;           // (N, Ho, Wo, Cout)
  int in_h, in_w, cin, ho, wo, cout, kw, stride, pad, k, m;
  float lo;
  int rne;
  int res_mode;          // 0 none, 1 identity (fma), 2 stage entry (mul, add)
  float res_scale;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int8_t requant(int acc, float mult, float bias, int res_mode,
                                          float r, float res_scale, bool rne, float lo) {
  float y = __fmaf_rn(__int2float_rn(acc), mult, bias);
  if (res_mode == 1) y = __fmaf_rn(r, res_scale, y);
  if (res_mode == 2) y = __fadd_rn(__fmul_rn(r, res_scale), y);
  y = rne ? rintf(y) : floorf(y);
  y = fminf(fmaxf(y, lo), 127.0f);
  return static_cast<int8_t>(static_cast<int>(y));
}

__global__ void __launch_bounds__(kThreads) conv_s8_kernel(const __grid_constant__ Params p) {
  __shared__ __align__(16) int8_t sa[2][kBM * kRow];
  __shared__ __align__(16) int8_t sb[2][kBN * kRow];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int piece = tid % kPieces;          // this thread's 16-byte piece of a row
  const int row0 = tid / kPieces;           // its first row; then every 32nd

  // The output pixels this thread loads A rows for: image base and the input
  // corner (iy0, ix0) of each, fixed over the K loop.
  constexpr int kARows = kBM * kPieces / kThreads;   // 4
  const int8_t* abase[kARows];
  int iy0[kARows], ix0[kARows];
  bool mvalid[kARows];
  for (int i = 0; i < kARows; ++i) {
    const int m = m0 + row0 + i * (kThreads / kPieces);
    mvalid[i] = m < p.m;
    const int mm = mvalid[i] ? m : 0;
    const int img = mm / (p.ho * p.wo);
    const int rem = mm - img * p.ho * p.wo;
    const int oy = rem / p.wo;
    const int ox = rem - oy * p.wo;
    abase[i] = p.x + static_cast<long long>(img) * p.in_h * p.in_w * p.cin;
    iy0[i] = oy * p.stride - p.pad;
    ix0[i] = ox * p.stride - p.pad;
  }
  constexpr int kBRows = kBN * kPieces / kThreads;   // 2

  auto load_chunk = [&](int chunk, int stage) {
    const int k = chunk * kBK + piece * 16;
    const bool kvalid = k < p.k;
    const int kk = kvalid ? k : 0;
    const int tap = kk / p.cin;
    const int c = kk - tap * p.cin;
    const int ky = tap / p.kw;
    const int kx = tap - ky * p.kw;
    for (int i = 0; i < kARows; ++i) {
      const int r = row0 + i * (kThreads / kPieces);
      const int iy = iy0[i] + ky, ix = ix0[i] + kx;
      const bool valid =
          kvalid && mvalid[i] && iy >= 0 && iy < p.in_h && ix >= 0 && ix < p.in_w;
      const int8_t* src =
          valid ? abase[i] + (static_cast<long long>(iy) * p.in_w + ix) * p.cin + c : p.x;
      cp_async16(&sa[stage][r * kRow + piece * 16], src, valid);
    }
    for (int i = 0; i < kBRows; ++i) {
      const int r = row0 + i * (kThreads / kPieces);
      const int o = n0 + r;
      const bool valid = kvalid && o < p.cout;
      const int8_t* src = valid ? p.wgt + static_cast<long long>(o) * p.k + k : p.wgt;
      cp_async16(&sb[stage][r * kRow + piece * 16], src, valid);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 64, wn = (warp % 2) * 32;
  int acc[4][4][4] = {};

  const int chunks = (p.k + kBK - 1) / kBK;
  load_chunk(0, 0);
  cp_async_commit();
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int stage = chunk & 1;
    if (chunk + 1 < chunks) {
      load_chunk(chunk + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* a = sa[stage];
    const int8_t* b = sb[stage];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(a + r * kRow + ks + t * 4);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(a + (r + 8) * kRow + ks + t * 4);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(a + r * kRow + ks + 16 + t * 4);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(a + (r + 8) * kRow + ks + 16 + t * 4);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn + ni * 8 + g;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(b + col * kRow + ks + t * 4);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(b + col * kRow + ks + 16 + t * 4);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_s8(acc[mi][ni], af[mi], b0, b1);
      }
    }
    __syncthreads();
  }

  // Epilogue from the fragments: c0, c1 are row g, columns 2t and 2t + 1;
  // c2, c3 row g + 8.
  const int res_mode = p.res != nullptr ? p.res_mode : 0;
  const bool rne = p.rne != 0;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int o = n0 + wn + ni * 8 + t * 2;
    if (o >= p.cout) continue;   // Cout is even: o + 1 is in range with o
    const float m_0 = p.mult[o], m_1 = p.mult[o + 1];
    const float b_0 = p.bias[o], b_1 = p.bias[o + 1];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + mi * 16 + g + half * 8;
        if (m >= p.m) continue;
        const long long at = static_cast<long long>(m) * p.cout + o;
        float r0 = 0.0f, r1 = 0.0f;
        if (res_mode != 0) {
          const char2 rv = *reinterpret_cast<const char2*>(p.res + at);
          r0 = static_cast<float>(rv.x);
          r1 = static_cast<float>(rv.y);
        }
        char2 q;
        q.x = requant(acc[mi][ni][half * 2], m_0, b_0, res_mode, r0, p.res_scale, rne, p.lo);
        q.y = requant(acc[mi][ni][half * 2 + 1], m_1, b_1, res_mode, r1, p.res_scale, rne,
                      p.lo);
        *reinterpret_cast<char2*>(p.out + at) = q;
      }
    }
  }
}

// What the kernel takes: Cin a multiple of 16 (a 16-byte piece of a row of
// A never straddles two taps), Cout a multiple of 8, output pixels N*Ho*Wo
// and the weights' K*Cout in int32 range (a block's last pixel index
// included). Byte offsets into x, res and out are 64-bit, so a batch's
// activations may pass 2 GiB.
constexpr long long kMaxPixels = (1LL << 31) - kBM;

bool takes(int n, int h, int w, int cin, int ho, int wo, int cout, int kh, int kw) {
  return n > 0 && h > 0 && w > 0 && ho > 0 && wo > 0 && kh > 0 && kw > 0 && cin > 0 &&
         cout > 0 && cin % 16 == 0 && cout % 8 == 0 &&
         static_cast<long long>(n) * ho * wo < kMaxPixels &&
         static_cast<long long>(kh) * kw * cin * cout < (1LL << 31);
}

}  // namespace

extern "C" int geo_conv_s8(const void* x, const void* w, const void* mult, const void* bias,
                           const void* res, void* out, int n, int h, int wd, int cin, int ho,
                           int wo, int cout, int kh, int kw, int stride, int pad, float lo,
                           int rne, int res_mode, float res_scale, void* stream) {
  if (!takes(n, h, wd, cin, ho, wo, cout, kh, kw) || stride < 1 || pad < 0 ||
      res_mode < 0 || res_mode > 2 || (res_mode != 0) != (res != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.wgt = static_cast<const int8_t*>(w);
  p.mult = static_cast<const float*>(mult);
  p.bias = static_cast<const float*>(bias);
  p.res = static_cast<const int8_t*>(res);
  p.out = static_cast<int8_t*>(out);
  p.in_h = h;
  p.in_w = wd;
  p.cin = cin;
  p.ho = ho;
  p.wo = wo;
  p.cout = cout;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.k = kh * kw * cin;
  p.m = n * ho * wo;
  p.lo = lo;
  p.rne = rne;
  p.res_mode = res_mode;
  p.res_scale = res_scale;
  const dim3 grid((p.m + kBM - 1) / kBM, (cout + kBN - 1) / kBN);
  conv_s8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
