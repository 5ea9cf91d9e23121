// The epilogue of a bf16 convolution of the BN-folded inference path: its
// bias, relu and residual add in one pass over the convolution's output, in
// place, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's fast path leaves the bias add,
// the relu and the residual add after each XLA convolution to XLA, which
// fuses them into the convolution's output. Eager PyTorch fuses nothing, so
// the port's fast path made up to three elementwise passes after each of its
// library convolutions (bias add, relu, residual add), each a read and a
// write of the whole map. One launch here does what they did, with their
// rounding points, on a channels-last map y of M = N*H*W rows of C channels:
//
//   bias_relu          y = relu(bf16(y + b))
//   bias_add_relu      y = relu(bf16(bf16(y + b) + r)), r the bf16 residual
//   bias_add_relu_ds   the same with r = bf16(res + bres), res the raw output
//                      of the downsample convolution and bres its bias
//
// Each add is a float32 sum of two bf16 values rounded to nearest even, as
// PyTorch adds two bf16 tensors; relu is PyTorch's clamp_min(v, 0): a NaN
// stays as it is, anything else is fmaxf(v, 0). So every output bit is the
// separate passes' bit.
//
// What bounds it on an H100 (3.35 TB/s): bytes. Per element it reads y (and
// the residual) and writes y once: 4 B, or 6 B with a residual, against 2 to
// 4 flops; the separate passes moved 8 B, 14 B with a residual and 18 B
// with the downsample's bias.
//
// What the design does about it: every thread moves 16 bytes a load and a
// store (8 channels), neighbouring threads on neighbouring channels and then
// on the next rows, so each warp reads whole 512-byte runs. A thread keeps
// one 8-channel slice of the biases in registers and walks the rows with a
// grid stride, kUnroll rows' loads in flight before their stores. The grid
// asks for 8 blocks of 256 threads a SM and no more; ptxas gives the
// residual forms 112-122 registers a thread, so two of their blocks are
// resident on a SM at once and the rest follow. Nothing is allocated: the
// result goes back into the convolution's fresh output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kUnroll = 4;
constexpr int kVec = 8;           // bf16 channels in 16 bytes

enum { kBiasRelu = 0, kBiasAddRelu = 1, kBiasAddReluDs = 2 };

struct alignas(16) Vec {
  __nv_bfloat16 h[kVec];
};

__device__ __forceinline__ Vec ld16(const __nv_bfloat16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  return *reinterpret_cast<const Vec*>(&v);
}

__device__ __forceinline__ Vec ldg16(const __nv_bfloat16* p) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  return *reinterpret_cast<const Vec*>(&v);
}

__device__ __forceinline__ void st16(__nv_bfloat16* p, const Vec& v) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&v);
}

// bf16(a + b): the float32 sum rounded to nearest even
__device__ __forceinline__ __nv_bfloat16 add_rn(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// PyTorch's relu on bf16 (clamp_min(v, 0)): a NaN is returned as it is
__device__ __forceinline__ __nv_bfloat16 relu(__nv_bfloat16 h) {
  const float v = __bfloat162float(h);
  return isnan(v) ? h : __float2bfloat16_rn(fmaxf(v, 0.f));
}

// Block (tx, ty) flattened: thread t takes the channel slice blockIdx.y * tx
// + t % tx and the rows t / tx + k * ty * gridDim.x.
template <int kForm>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(__nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ b,
                         const __nv_bfloat16* __restrict__ res,
                         const __nv_bfloat16* __restrict__ bres, long long rows, int c, int tx,
                         int ty) {
  const int slice = blockIdx.y * tx + threadIdx.x % tx;
  const int row0 = threadIdx.x / tx;
  if (row0 >= ty || slice * kVec >= c) return;
  const int col = slice * kVec;
  const Vec bias = ldg16(b + col);
  Vec bias_res;
  if (kForm == kBiasAddReluDs) bias_res = ldg16(bres + col);
  const long long step = (long long)gridDim.x * ty;
  for (long long r = (long long)blockIdx.x * ty + row0; r < rows; r += kUnroll * step) {
    Vec yv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + u * step;
      if (ru < rows) {
        yv[u] = ld16(y + ru * c + col);
        if (kForm != kBiasRelu) rv[u] = ldg16(res + ru * c + col);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + u * step;
      if (ru >= rows) break;
      Vec o;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        __nv_bfloat16 v = add_rn(yv[u].h[i], bias.h[i]);
        if (kForm == kBiasAddReluDs) v = add_rn(v, add_rn(rv[u].h[i], bias_res.h[i]));
        if (kForm == kBiasAddRelu) v = add_rn(v, rv[u].h[i]);
        o.h[i] = relu(v);
      }
      st16(y + ru * c + col, o);
    }
  }
}

bool aligned(const void* p) { return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// form: 0 bias-relu, 1 bias-add-relu (res the residual), 2 the same with the
// residual res + bres (the downsample's raw output and its bias). y and res
// are (rows, c) row-major bf16 maps (channels-last), b and bres (c,) bf16,
// all 16-byte aligned, c a multiple of 8; `res` and `bres` null where the
// form reads none. `sms` is the card's SM count. Launches on `stream`;
// returns a cudaError_t, nonzero when the arguments are outside what the
// kernel takes or the launch failed.
extern "C" int geo_conv_epilogue(int form, void* y, const void* b, const void* res,
                                 const void* bres, long long rows, int c, int sms,
                                 void* stream) {
  if (form < kBiasRelu || form > kBiasAddReluDs || rows < 0 || c <= 0 || c % kVec ||
      sms <= 0 || !aligned(y) || !aligned(b) || (form != kBiasRelu) != (res != nullptr) ||
      (res != nullptr && !aligned(res)) || (form == kBiasAddReluDs) != (bres != nullptr) ||
      (bres != nullptr && !aligned(bres)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int slices = c / kVec;
  const int tx = slices < kThreads ? slices : kThreads;
  const int ty = kThreads / tx;
  const int gy = (slices + tx - 1) / tx;
  const long long want = (rows + ty - 1) / ty;
  const long long cap = (long long)sms * kBlocksPerSm / gy + 1;
  const dim3 grid((unsigned)(want < cap ? want : cap), (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  const __nv_bfloat16* bp = static_cast<const __nv_bfloat16*>(b);
  const __nv_bfloat16* rp = static_cast<const __nv_bfloat16*>(res);
  const __nv_bfloat16* brp = static_cast<const __nv_bfloat16*>(bres);
  if (form == kBiasRelu)
    conv_epilogue_kernel<kBiasRelu><<<grid, kThreads, 0, s>>>(yp, bp, rp, brp, rows, c, tx, ty);
  else if (form == kBiasAddRelu)
    conv_epilogue_kernel<kBiasAddRelu><<<grid, kThreads, 0, s>>>(yp, bp, rp, brp, rows, c, tx,
                                                                 ty);
  else
    conv_epilogue_kernel<kBiasAddReluDs><<<grid, kThreads, 0, s>>>(yp, bp, rp, brp, rows, c, tx,
                                                                   ty);
  return (int)cudaGetLastError();
}
