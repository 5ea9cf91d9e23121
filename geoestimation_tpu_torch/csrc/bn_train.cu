// Train-mode BatchNorm of the ResNet train step, fused with the relu and the
// residual add that consume its output: four kernels, bf16 or float32 in and
// out, float32 statistics, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves flax's BatchNorm to XLA,
// which fuses the statistics, the normalisation, the relu and the residual
// add into the passes around the convolutions. Eager PyTorch fuses nothing,
// so written as operators the same function makes about ten float32 passes
// over each map forward and twice as many backward. These kernels make two
// each way, over the channels-last map x (M = N*H*W rows of C channels):
//
//   bn_stats       S1[c] = sum x, S2[c] = sum x^2 (float32), and M
//   (the caller sums S1, S2 and M over the data axis's ranks)
//   bn_apply       mean = S1/M, var = max(S2/M - mean^2, 0) (flax's fast,
//                  biased variance), rstd = rsqrt(var + eps), and
//                  y = bf16((x - mean) * (rstd * gamma) + beta), then
//                  out = y (plain), relu(y) (relu) or relu(bf16(y + r))
//                  (add-relu, r the bf16 residual): the JAX model's rounding
//                  points, each float32 operation rounded on its own
//   bn_bwd_reduce  g = dy * [out > 0] (dy in the plain form), the sums
//                  Sg[c] = sum g and Sgc[c] = sum g * (x - mean) from the
//                  saved input and statistics, and from them autodiff's
//                  steps: dbeta = Sg, dgamma = Sgc * rstd, dvar = -0.5 *
//                  (Sgc * gamma) * rstd^3 (0 where S2/M - mean^2 < 0: the
//                  clip), dmean = -(rstd * gamma) * Sg - dvar * 2 mean, and
//                  the gradients of S1 and S2: d1 = dmean / M, d2 = dvar / M
//   (the caller sums d1 and d2 over the ranks)
//   bn_bwd_dx      dx = bf16((g * (rstd * gamma) + d2 * 2x) + d1), the
//                  terms added in autodiff's order; dr = g in the add-relu
//                  form
//
// dgamma and dbeta, each rank's own, stay float32. This is the analytic
// gradient of the fast-variance formula, gamma * rstd * (g - Sg/M - xh *
// (sum g * xh)/M), arranged as autodiff of the formula arranges it (and as
// the plain version does, bit for bit autodiff's own on the CPU), so that
// the per-channel quantities summed over the ranks are those the formula's
// all-reduce of S1 and S2 sums in its backward.
//
// What bounds it on an H100 (3.35 TB/s): bytes. Per element of a bf16 map,
// stats read 2 B; apply reads 2 (4 with a residual) and writes 2; the
// backward reduction reads 6 (4 in the plain form); dx reads 6 and writes 2
// (4 with the residual's gradient). At batch 256 a ResNet50 step has 2.845 G
// BatchNorm'd elements, about 57 GB at these counts, 17 ms.
//
// What the design does about it: every thread moves 16 bytes a load (8 bf16
// or 4 float32 channels), neighbouring threads on neighbouring channels and
// a warp over consecutive rows where C is narrow, so each warp reads whole
// 512-byte runs. A block is 512 threads, TX of them across a channel tile of
// CT = 8 TX channels and 512 / TX rows at once; the grid is the channel
// tiles times enough row blocks for two blocks on every SM, which walk the
// rows with a stride. The reductions sum in registers, then across the
// block's warps in shared memory, then write one partial per block; the
// last block of a channel tile to take an integer ticket (no float atomics)
// adds the partials in the order of the row blocks, with 16-byte loads
// spread over all its threads, so two runs give the same bits and one
// launch finishes the sums. Per-channel values (mean, rstd, gamma * rstd,
// the gradient's coefficients) come from the sums in each block's prologue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxTile = 256;     // channels of a tile: 32 threads x 8 bf16
constexpr int kMaxTiles = 64;     // channel tiles, one ticket counter each

enum { kPlain = 0, kRelu = 1, kAddRelu = 2 };

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void st16(void* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// 16 bytes of T as floats, and back (round to nearest even, as torch's casts)
template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(uint4 u, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return u;
  }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <>
struct Pack<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(uint4 u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  __device__ __forceinline__ static float round(float v) { return v; }
};

// The launch geometry: TX threads across a tile of CT channels, TY rows at
// once, GX channel tiles by GY row blocks.
struct Geo {
  long long rows;
  int c, tx, ty, ct, gx, gy;
};

int num_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// false where the kernels do not take the shape: C a multiple of the pack,
// its packs a divisor of 32 or a multiple of 32, at most kMaxTiles tiles.
bool make_geo(Geo& g, int dtype, long long rows, int c) {
  const int n = dtype == 0 ? 8 : 4;
  if (rows < 1 || c < n || c % n) return false;
  const int packs = c / n;
  if (packs <= 32 ? 32 % packs != 0 : packs % 32 != 0) return false;
  g.rows = rows;
  g.c = c;
  g.tx = packs < 32 ? packs : 32;
  g.ct = g.tx * n;
  g.gx = c / g.ct;
  g.ty = kThreads / g.tx;
  if (g.gx > kMaxTiles) return false;
  long long want = (long long)num_sms() * kBlocksPerSm / g.gx;
  if (want < 1) want = 1;
  const long long need = (rows + g.ty - 1) / g.ty;
  g.gy = (int)(want < need ? want : need);
  return true;
}

struct Stats {
  float mean, var, rstd;
  bool keep;  // the variance term of the gradient: S2/M - mean^2 >= 0
};

// A channel's statistics from the sums, one rounding per operation as the
// plain version's tensor operations: the same bits in every kernel.
__device__ __forceinline__ Stats channel_stats(const float* sums, int c, int ch, float eps) {
  const float m = sums[2 * c];
  Stats s;
  s.mean = __fdiv_rn(sums[ch], m);
  const float raw = __fsub_rn(__fdiv_rn(sums[c + ch], m), __fmul_rn(s.mean, s.mean));
  s.var = fmaxf(raw, 0.f);
  s.rstd = rsqrtf(__fadd_rn(s.var, eps));
  s.keep = raw >= 0.f;
  return s;
}

// Sums each thread's acc[2][N] (two quantities for its N channels) over the
// block and writes the block's partial to part[(y * 2 + q) * C + channel];
// the last block of the channel tile to take a ticket then adds the tile's
// GY partials in the order of y into tot[q][channel in the tile] (shared
// memory) and returns true, leaving the tile's counter at 0 for the next
// launch. Every other block returns false.
template <int N>
__device__ __forceinline__ bool reduce_tile(float (&acc)[2][N], const Geo& g, float* part,
                                            unsigned* counter, float (&tot)[2][kMaxTile]) {
  __shared__ float red[kWarps][2 * kMaxTile];
  __shared__ float4 fin[kThreads];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the lanes of a warp that hold the same channels (lane mod TX)
  for (int off = g.tx; off < 32; off <<= 1) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < N; ++i) acc[q][i] += __shfl_xor_sync(0xffffffffu, acc[q][i], off);
  }
  if (lane < g.tx) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < N; ++i) red[warp][q * g.ct + lane * N + i] = acc[q][i];
  }
  __syncthreads();
  const int ch0 = blockIdx.x * g.ct;
  if (tid < 2 * g.ct) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    const int q = tid / g.ct, j = tid - q * g.ct;
    part[((long long)blockIdx.y * 2 + q) * g.c + ch0 + j] = s;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  // float4 columns: CT / 4 of each quantity; the threads split the row
  // blocks into `groups` interleaved runs, added in a fixed order
  const int quarter = g.ct / 4, cols = 2 * quarter, groups = kThreads / cols;
  const int col = tid % cols, grp = tid / cols;
  const int q = col / quarter, j = (col - q * quarter) * 4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int y = grp; y < (int)gridDim.y; y += groups) {
    const float4 v =
        __ldcg(reinterpret_cast<const float4*>(part + ((long long)y * 2 + q) * g.c + ch0 + j));
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  fin[tid] = s;
  __syncthreads();
  if (tid < cols) {
    float4 t = fin[tid];
    for (int k = 1; k < groups; ++k) {
      const float4 v = fin[k * cols + tid];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    tot[q][j] = t.x;
    tot[q][j + 1] = t.y;
    tot[q][j + 2] = t.z;
    tot[q][j + 3] = t.w;
  }
  if (tid == 0) counter[blockIdx.x] = 0;
  __syncthreads();
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_stats_kernel(const T* __restrict__ x, const Geo g, float* part, unsigned* counter,
                float* sums) {
  constexpr int N = Pack<T>::n;
  float acc[2][N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[0][i] = acc[1][i] = 0.f;
  const T* base = x + blockIdx.x * g.ct + (threadIdx.x % g.tx) * N;
  const long long step = (long long)gridDim.y * g.ty;
  long long r = (long long)blockIdx.y * g.ty + threadIdx.x / g.tx;
  for (; r + 3 * step < g.rows; r += 4 * step) {
    uint4 raw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) raw[k] = ld16(base + (r + k * step) * g.c);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v[N];
      Pack<T>::unpack(raw[k], v);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        acc[0][i] += v[i];
        acc[1][i] = fmaf(v[i], v[i], acc[1][i]);
      }
    }
  }
  for (; r < g.rows; r += step) {
    float v[N];
    Pack<T>::unpack(ld16(base + r * g.c), v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      acc[0][i] += v[i];
      acc[1][i] = fmaf(v[i], v[i], acc[1][i]);
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) sums[2 * g.c] = (float)g.rows;
  __shared__ float tot[2][kMaxTile];
  if (!reduce_tile<N>(acc, g, part, counter, tot)) return;
  const int ch0 = blockIdx.x * g.ct;
  for (int j = threadIdx.x; j < g.ct; j += kThreads) {
    sums[ch0 + j] = tot[0][j];
    sums[g.c + ch0 + j] = tot[1][j];
  }
}

template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ sums,
                const float* __restrict__ gamma, const float* __restrict__ beta, float eps,
                const Geo g, T* __restrict__ out, float* __restrict__ mean_out,
                float* __restrict__ var_out) {
  constexpr int N = Pack<T>::n;
  __shared__ float s_mean[kMaxTile], s_mul[kMaxTile], s_beta[kMaxTile];
  const int ch0 = blockIdx.x * g.ct;
  for (int j = threadIdx.x; j < g.ct; j += kThreads) {
    const Stats st = channel_stats(sums, g.c, ch0 + j, eps);
    s_mean[j] = st.mean;
    s_mul[j] = __fmul_rn(st.rstd, gamma[ch0 + j]);
    s_beta[j] = beta[ch0 + j];
    if (blockIdx.y == 0) {
      mean_out[ch0 + j] = st.mean;
      var_out[ch0 + j] = st.var;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x % g.tx;
  float mean[N], mul[N], bet[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mean[i] = s_mean[lane * N + i];
    mul[i] = s_mul[lane * N + i];
    bet[i] = s_beta[lane * N + i];
  }
  const long long col = ch0 + lane * N;
  const long long step = (long long)gridDim.y * g.ty;
  for (long long r = (long long)blockIdx.y * g.ty + threadIdx.x / g.tx; r < g.rows; r += step) {
    const long long off = r * g.c + col;
    float v[N], rv[N];
    Pack<T>::unpack(ld16(x + off), v);
    if (kForm == kAddRelu) Pack<T>::unpack(ld16(res + off), rv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float y = Pack<T>::round(__fadd_rn(__fmul_rn(__fsub_rn(v[i], mean[i]), mul[i]), bet[i]));
      if (kForm == kAddRelu) y = Pack<T>::round(__fadd_rn(y, rv[i]));
      if (kForm != kPlain) y = y > 0.f ? y : 0.f;
      v[i] = y;
    }
    st16(out + off, Pack<T>::pack(v));
  }
}

template <typename T, bool kMask>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_bwd_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ out,
                     const T* __restrict__ x, const float* __restrict__ sums,
                     const float* __restrict__ gamma, float eps, const Geo g, float* part,
                     unsigned* counter, float* red) {
  constexpr int N = Pack<T>::n;
  __shared__ float s_mean[kMaxTile];
  const int ch0 = blockIdx.x * g.ct;
  for (int j = threadIdx.x; j < g.ct; j += kThreads)
    s_mean[j] = channel_stats(sums, g.c, ch0 + j, eps).mean;
  __syncthreads();
  const int lane = threadIdx.x % g.tx;
  float mean[N];
#pragma unroll
  for (int i = 0; i < N; ++i) mean[i] = s_mean[lane * N + i];
  // acc[0] sums g, acc[1] g * (x - mean)
  float acc[2][N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[0][i] = acc[1][i] = 0.f;
  const long long col = ch0 + lane * N;
  const long long step = (long long)gridDim.y * g.ty;
  long long r = (long long)blockIdx.y * g.ty + threadIdx.x / g.tx;
  for (; r + step < g.rows; r += 2 * step) {
    uint4 d[2], o[2], xr[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const long long off = (r + k * step) * g.c + col;
      d[k] = ld16(dy + off);
      if (kMask) o[k] = ld16(out + off);
      xr[k] = ld16(x + off);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float gv[N], ov[N], xv[N];
      Pack<T>::unpack(d[k], gv);
      if (kMask) Pack<T>::unpack(o[k], ov);
      Pack<T>::unpack(xr[k], xv);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float gi = kMask ? (ov[i] > 0.f ? gv[i] : 0.f) : gv[i];
        acc[0][i] += gi;
        acc[1][i] = fmaf(gi, xv[i] - mean[i], acc[1][i]);
      }
    }
  }
  for (; r < g.rows; r += step) {
    const long long off = r * g.c + col;
    float gv[N], ov[N], xv[N];
    Pack<T>::unpack(ld16(dy + off), gv);
    if (kMask) Pack<T>::unpack(ld16(out + off), ov);
    Pack<T>::unpack(ld16(x + off), xv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float gi = kMask ? (ov[i] > 0.f ? gv[i] : 0.f) : gv[i];
      acc[0][i] += gi;
      acc[1][i] = fmaf(gi, xv[i] - mean[i], acc[1][i]);
    }
  }
  __shared__ float tot[2][kMaxTile];
  if (!reduce_tile<N>(acc, g, part, counter, tot)) return;
  // autodiff's steps from the sums: the weight's and bias's gradients, and
  // those of the sums of x (d1) and of x^2 (d2), the rank's own
  const float m = sums[2 * g.c];
  for (int j = threadIdx.x; j < g.ct; j += kThreads) {
    const int ch = ch0 + j;
    const Stats st = channel_stats(sums, g.c, ch, eps);
    const float sg = tot[0][j], dmul = tot[1][j];
    const float mul = __fmul_rn(st.rstd, gamma[ch]);
    const float r3 = __fmul_rn(__fmul_rn(st.rstd, st.rstd), st.rstd);
    const float dvar = st.keep ? __fmul_rn(__fmul_rn(-0.5f, __fmul_rn(dmul, gamma[ch])), r3) : 0.f;
    const float dmean =
        __fadd_rn(-__fmul_rn(mul, sg), __fmul_rn(-dvar, __fmul_rn(2.f, st.mean)));
    red[ch] = sg;
    red[g.c + ch] = __fmul_rn(dmul, st.rstd);
    red[2 * g.c + ch] = __fdiv_rn(dmean, m);
    red[3 * g.c + ch] = __fdiv_rn(dvar, m);
  }
}

template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ out, const T* __restrict__ x,
                 const float* __restrict__ sums, const float* __restrict__ gamma,
                 const float* __restrict__ d12, float eps, const Geo g, T* __restrict__ dx,
                 T* __restrict__ dres) {
  constexpr int N = Pack<T>::n;
  constexpr bool kMask = kForm != kPlain;
  // dx = (g * mul + x * 2 d2) + d1, in autodiff's order
  __shared__ float s_mul[kMaxTile], s_d1[kMaxTile], s_2d2[kMaxTile];
  const int ch0 = blockIdx.x * g.ct;
  for (int j = threadIdx.x; j < g.ct; j += kThreads) {
    const int ch = ch0 + j;
    s_mul[j] = __fmul_rn(channel_stats(sums, g.c, ch, eps).rstd, gamma[ch]);
    s_d1[j] = d12[ch];
    s_2d2[j] = __fmul_rn(2.f, d12[g.c + ch]);
  }
  __syncthreads();
  const int lane = threadIdx.x % g.tx;
  float mul[N], d1[N], d2x2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mul[i] = s_mul[lane * N + i];
    d1[i] = s_d1[lane * N + i];
    d2x2[i] = s_2d2[lane * N + i];
  }
  const long long col = ch0 + lane * N;
  const long long step = (long long)gridDim.y * g.ty;
  for (long long r = (long long)blockIdx.y * g.ty + threadIdx.x / g.tx; r < g.rows; r += step) {
    const long long off = r * g.c + col;
    const uint4 d = ld16(dy + off);
    uint4 o = d;
    if (kMask) o = ld16(out + off);
    const uint4 xr = ld16(x + off);
    float gv[N], ov[N], xv[N];
    Pack<T>::unpack(d, gv);
    if (kMask) Pack<T>::unpack(o, ov);
    Pack<T>::unpack(xr, xv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (kMask) gv[i] = ov[i] > 0.f ? gv[i] : 0.f;
      xv[i] = __fadd_rn(__fadd_rn(__fmul_rn(gv[i], mul[i]), __fmul_rn(d2x2[i], xv[i])), d1[i]);
    }
    st16(dx + off, Pack<T>::pack(xv));
    if (kForm == kAddRelu) st16(dres + off, Pack<T>::pack(gv));
  }
}

bool aligned(const void* p) { return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t stats(const Geo& g, const void* x, void* part, void* counter, void* sums,
                  cudaStream_t s) {
  bn_stats_kernel<T><<<dim3(g.gx, g.gy), kThreads, 0, s>>>(
      static_cast<const T*>(x), g, static_cast<float*>(part), static_cast<unsigned*>(counter),
      static_cast<float*>(sums));
  return cudaGetLastError();
}

template <typename T, int kForm>
cudaError_t apply(const Geo& g, const void* x, const void* res, const void* sums,
                  const void* gamma, const void* beta, float eps, void* out, void* mean,
                  void* var, cudaStream_t s) {
  bn_apply_kernel<T, kForm><<<dim3(g.gx, g.gy), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(sums),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), eps, g,
      static_cast<T*>(out), static_cast<float*>(mean), static_cast<float*>(var));
  return cudaGetLastError();
}

template <typename T, bool kMask>
cudaError_t bwd_reduce(const Geo& g, const void* dy, const void* out, const void* x,
                       const void* sums, const void* gamma, float eps, void* part,
                       void* counter, void* red, cudaStream_t s) {
  bn_bwd_reduce_kernel<T, kMask><<<dim3(g.gx, g.gy), kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(out), static_cast<const T*>(x),
      static_cast<const float*>(sums), static_cast<const float*>(gamma), eps, g,
      static_cast<float*>(part), static_cast<unsigned*>(counter), static_cast<float*>(red));
  return cudaGetLastError();
}

template <typename T, int kForm>
cudaError_t bwd_dx(const Geo& g, const void* dy, const void* out, const void* x,
                   const void* sums, const void* gamma, const void* d12, float eps, void* dx,
                   void* dres, cudaStream_t s) {
  bn_bwd_dx_kernel<T, kForm><<<dim3(g.gx, g.gy), kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(out), static_cast<const T*>(x),
      static_cast<const float*>(sums), static_cast<const float*>(gamma),
      static_cast<const float*>(d12), eps, g, static_cast<T*>(dx), static_cast<T*>(dres));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 bf16, 1 float32; form: 0 plain, 1 relu, 2 add-relu. Every map is
// (rows, c) row-major (channels-last), 16-byte aligned; `part` holds gy x 2 x
// c floats and `counter` gx zeroed unsigned ints (left zeroed), gx and gy as
// geo_bn_grid reports. Each entry returns a cudaError_t: nonzero when the
// arguments are outside what the kernels take or the launch failed.

// The reductions' grid for a shape: out[0] gx channel tiles, out[1] gy row
// blocks.
extern "C" int geo_bn_grid(int dtype, long long rows, int c, int* out) {
  Geo g;
  if ((dtype != 0 && dtype != 1) || !make_geo(g, dtype, rows, c))
    return (int)cudaErrorInvalidValue;
  out[0] = g.gx;
  out[1] = g.gy;
  return 0;
}

// sums[0:c] = sum x, sums[c:2c] = sum x^2, sums[2c] = rows.
extern "C" int geo_bn_stats(int dtype, const void* x, long long rows, int c, void* part,
                            void* counter, void* sums, void* stream) {
  Geo g;
  if ((dtype != 0 && dtype != 1) || !make_geo(g, dtype, rows, c) || !aligned(x) ||
      !aligned(part) || !aligned(sums) || counter == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? (int)stats<__nv_bfloat16>(g, x, part, counter, sums, s)
                    : (int)stats<float>(g, x, part, counter, sums, s);
}

// out, and mean[c] and var[c] (clipped) for the running statistics.
extern "C" int geo_bn_apply(int dtype, int form, const void* x, const void* res,
                            const void* sums, const void* gamma, const void* beta, float eps,
                            long long rows, int c, void* out, void* mean, void* var,
                            void* stream) {
  Geo g;
  if ((dtype != 0 && dtype != 1) || form < kPlain || form > kAddRelu ||
      !make_geo(g, dtype, rows, c) || !aligned(x) || !aligned(out) ||
      (form == kAddRelu) != (res != nullptr) || (res != nullptr && !aligned(res)) ||
      sums == nullptr || gamma == nullptr || beta == nullptr || mean == nullptr ||
      var == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GEO_APPLY(T, F) apply<T, F>(g, x, res, sums, gamma, beta, eps, out, mean, var, s)
  cudaError_t err;
  if (dtype == 0)
    err = form == kPlain  ? GEO_APPLY(__nv_bfloat16, kPlain)
          : form == kRelu ? GEO_APPLY(__nv_bfloat16, kRelu)
                          : GEO_APPLY(__nv_bfloat16, kAddRelu);
  else
    err = form == kPlain  ? GEO_APPLY(float, kPlain)
          : form == kRelu ? GEO_APPLY(float, kRelu)
                          : GEO_APPLY(float, kAddRelu);
#undef GEO_APPLY
  return (int)err;
}

// red (4 x c), the rank's own: the bias's gradient (sum g), the weight's
// (sum g * xh), and those of the sums of x (d1) and of x^2 (d2); `out` is
// read (the relu mask) unless the form is plain, where it may be null.
extern "C" int geo_bn_bwd_reduce(int dtype, int form, const void* dy, const void* out,
                                 const void* x, const void* sums, const void* gamma, float eps,
                                 long long rows, int c, void* part, void* counter, void* red,
                                 void* stream) {
  Geo g;
  const bool mask = form != kPlain;
  if ((dtype != 0 && dtype != 1) || form < kPlain || form > kAddRelu ||
      !make_geo(g, dtype, rows, c) || !aligned(dy) || !aligned(x) || (mask && !aligned(out)) ||
      !aligned(part) || red == nullptr || sums == nullptr || gamma == nullptr ||
      counter == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GEO_RED(T, M) bwd_reduce<T, M>(g, dy, out, x, sums, gamma, eps, part, counter, red, s)
  cudaError_t err;
  if (dtype == 0)
    err = mask ? GEO_RED(__nv_bfloat16, true) : GEO_RED(__nv_bfloat16, false);
  else
    err = mask ? GEO_RED(float, true) : GEO_RED(float, false);
#undef GEO_RED
  return (int)err;
}

// dx, and dres = g in the add-relu form (null otherwise); `d12` (2 x c) is
// d1 and d2 of geo_bn_bwd_reduce summed over the ranks.
extern "C" int geo_bn_bwd_dx(int dtype, int form, const void* dy, const void* out,
                             const void* x, const void* sums, const void* gamma, const void* d12,
                             float eps, long long rows, int c, void* dx, void* dres,
                             void* stream) {
  Geo g;
  if ((dtype != 0 && dtype != 1) || form < kPlain || form > kAddRelu ||
      !make_geo(g, dtype, rows, c) || !aligned(dy) || !aligned(x) || !aligned(dx) ||
      (form != kPlain && !aligned(out)) || (form == kAddRelu) != (dres != nullptr) ||
      (dres != nullptr && !aligned(dres)) || sums == nullptr || gamma == nullptr ||
      d12 == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GEO_DX(T, F) bwd_dx<T, F>(g, dy, out, x, sums, gamma, d12, eps, dx, dres, s)
  cudaError_t err;
  if (dtype == 0)
    err = form == kPlain  ? GEO_DX(__nv_bfloat16, kPlain)
          : form == kRelu ? GEO_DX(__nv_bfloat16, kRelu)
                          : GEO_DX(__nv_bfloat16, kAddRelu);
  else
    err = form == kPlain  ? GEO_DX(float, kPlain)
          : form == kRelu ? GEO_DX(float, kRelu)
                          : GEO_DX(float, kAddRelu);
#undef GEO_DX
  return (int)err;
}
