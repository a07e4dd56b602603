// Gradient of the fused RMS norm on Hopper (sm_90a).
//
// The TPU kernel `_rmsnorm_kernel` (src/repro/kernels/rmsnorm/kernel.py) has
// no backward: JAX differentiates the jnp model.  The port's model calls the
// forward kernel (rmsnorm.cu), so training needs this gradient.  For each row
// of x [N, D] with upstream gradient g [N, D] (x's type), all in f32:
//
//   r  = 1 / sqrt(mean(x^2) + eps)        gs = g * (1 + scale)
//   dx = r * gs - (x * r^3) * mean(x * gs)
//   dscale = sum over rows of g * (x * r)
//
// What bounds it: bytes.  x and g read once, dx written once, and D
// partial sums a lane; a few FP32 operations an element.
//
// Design, simple first.  Pass 1 cuts a row over threads exactly as the
// forward's launch plan does (kernel.launch_plan(D, dtype): units of 16
// bytes of x, up to 2 a thread, rows of a block sharing it when narrow).
// A "lane" is one row group of one block; lane l walks rows l, l + L,
// l + 2L, ... (L lanes in all) in order.  For each row it loads x and g,
// reduces sum(x^2) and sum(x * gs) together (warp shuffles, then the row's
// warps through shared memory), writes dx, and adds g * (x * r) into the
// dscale sums its thread holds for the columns it owns.  At the end each
// lane writes its D sums as one row of `partial` [L, D].  Pass 2 (a second
// launch) sums partial's rows column by column, lane 0 to L - 1 in order,
// and writes dscale in scale's type.  No atomics: the bits of dx and dscale
// depend on N and D only, never on the schedule (a replayed training step
// gives the same gradient).
//
// Rounding follows the plain version (ref.py, rms_norm_backward_reference)
// operation by operation: every product and sum rounded on its own (no FMA
// contraction), the means as sums times 1/D, r through rsqrtf as the
// forward.  Only the order of the three sums differs.
//
// The entry point launches both passes on the caller's stream, allocates
// nothing (the wrapper passes `partial`) and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxBlock = 1024;
constexpr int kPer = 2;  // units a thread holds
constexpr int kColBlock = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int pack_align(int bytes) { return bytes < 16 ? bytes : 16; }

template <typename T, int N>
struct alignas(pack_align(int(sizeof(T)) * N)) Pack {
  T v[N];
};

template <typename T, typename S, int kUnit>
__global__ void __launch_bounds__(kMaxBlock)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const S* __restrict__ scale,
                   T* __restrict__ dx, float* __restrict__ partial, int64_t rows, int cols,
                   int threads, float eps) {
  __shared__ float2 pair[kMaxBlock / kWarp];
  using XP = Pack<T, kUnit>;
  using SP = Pack<S, kUnit>;
  const int groups = blockDim.x / threads;
  const int group = threadIdx.x / threads, tid = threadIdx.x % threads;
  const int64_t lane = int64_t(blockIdx.x) * groups + group;
  const int64_t lanes = int64_t(gridDim.x) * groups;
  const int64_t iters = (rows + lanes - 1) / lanes;  // the same for every thread
  const int units = cols / kUnit;
  const float inv_cols = 1.0f / float(cols);

  float sw[kPer][kUnit];  // 1 + scale
  float acc[kPer][kUnit];  // this thread's dscale sums
  const SP* sr = reinterpret_cast<const SP*>(scale);
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int u = tid + p * threads;
    SP s;
    if (u < units) s = sr[u];
#pragma unroll
    for (int e = 0; e < kUnit; ++e) {
      sw[p][e] = u < units ? __fadd_rn(1.0f, to_float(s.v[e])) : 0.f;
      acc[p][e] = 0.f;
    }
  }

  for (int64_t it = 0; it < iters; ++it) {
    const int64_t row = lane + it * lanes;
    const bool live = row < rows;
    const XP* xr = reinterpret_cast<const XP*>(x + row * cols);
    const XP* gr = reinterpret_cast<const XP*>(g + row * cols);
    XP xv[kPer], gv[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int u = tid + p * threads;
      if (live && u < units) {
        xv[p] = xr[u];
        gv[p] = gr[u];
      } else {
#pragma unroll
        for (int e = 0; e < kUnit; ++e) {
          xv[p].v[e] = from_float<T>(0.f);
          gv[p].v[e] = from_float<T>(0.f);
        }
      }
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int p = 0; p < kPer; ++p)
#pragma unroll
      for (int e = 0; e < kUnit; ++e) {
        const float f = to_float(xv[p].v[e]);
        ss = __fadd_rn(ss, __fmul_rn(f, f));
        dot = __fadd_rn(dot, __fmul_rn(f, __fmul_rn(to_float(gv[p].v[e]), sw[p][e])));
      }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    if (threads > kWarp) {  // the same for every thread of the block
      const int warps = threads / kWarp, lane_in_warp = threadIdx.x % kWarp;
      if (lane_in_warp == 0) pair[threadIdx.x / kWarp] = make_float2(ss, dot);
      __syncthreads();
      const float2 mine = lane_in_warp < warps ? pair[group * warps + lane_in_warp]
                                               : make_float2(0.f, 0.f);
      ss = mine.x;
      dot = mine.y;
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      __syncthreads();  // pair is rewritten by the next row
    }
    if (!live) continue;
    const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_cols), eps));
    const float r3 = __fmul_rn(__fmul_rn(r, r), r);
    const float mean_dot = __fmul_rn(dot, inv_cols);
    XP* orow = reinterpret_cast<XP*>(dx + row * cols);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int u = tid + p * threads;
      if (u < units) {
        XP res;
#pragma unroll
        for (int e = 0; e < kUnit; ++e) {
          const float f = to_float(xv[p].v[e]), gf = to_float(gv[p].v[e]);
          const float gs = __fmul_rn(gf, sw[p][e]);
          const float t = __fmul_rn(__fmul_rn(f, r3), mean_dot);
          res.v[e] = from_float<T>(__fsub_rn(__fmul_rn(r, gs), t));
          acc[p][e] = __fadd_rn(acc[p][e], __fmul_rn(gf, __fmul_rn(f, r)));
        }
        orow[u] = res;
      }
    }
  }

  float* prow = partial + lane * cols;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int u = tid + p * threads;
    if (u < units)
#pragma unroll
      for (int e = 0; e < kUnit; ++e) prow[u * kUnit + e] = acc[p][e];
  }
}

template <typename S>
__global__ void __launch_bounds__(kColBlock)
column_sum_kernel(const float* __restrict__ partial, S* __restrict__ dscale, int lanes, int cols) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float s = 0.f;
  for (int l = 0; l < lanes; ++l) s = __fadd_rn(s, partial[int64_t(l) * cols + col]);
  dscale[col] = from_float<S>(s);
}

template <typename T, typename S, int kUnit>
int launch_unit(const void* x, const void* g, const void* scale, void* dx, void* dscale,
                float* partial, int64_t rows, int cols, int threads, int rows_per_block,
                int blocks, float eps, cudaStream_t stream) {
  if (rows_per_block * threads > kMaxBlock) return int(cudaErrorInvalidValue);
  rmsnorm_bwd_kernel<T, S, kUnit><<<blocks, rows_per_block * threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const S*>(scale),
      static_cast<T*>(dx), partial, rows, cols, threads, eps);
  const int err = int(cudaGetLastError());
  if (err != 0) return err;
  column_sum_kernel<S><<<(cols + kColBlock - 1) / kColBlock, kColBlock, 0, stream>>>(
      partial, static_cast<S*>(dscale), blocks * rows_per_block, cols);
  return int(cudaGetLastError());
}

template <typename T, typename S>
int launch(const void* x, const void* g, const void* scale, void* dx, void* dscale,
           float* partial, int64_t rows, int cols, int unit, int threads, int rows_per_block,
           int blocks, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (unit == kVec) {
    const uintptr_t align_s = pack_align(int(sizeof(S)) * kVec);
    if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(g) % 16 ||
        reinterpret_cast<uintptr_t>(dx) % 16 || reinterpret_cast<uintptr_t>(scale) % align_s)
      return int(cudaErrorMisalignedAddress);
    return launch_unit<T, S, kVec>(x, g, scale, dx, dscale, partial, rows, cols, threads,
                                   rows_per_block, blocks, eps, stream);
  }
  if (unit == 1)
    return launch_unit<T, S, 1>(x, g, scale, dx, dscale, partial, rows, cols, threads,
                                rows_per_block, blocks, eps, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, g and dx share one type; scale
// and dscale another).  The plan (unit, threads, rows_per_block) is the
// forward's, kernel.launch_plan(D, x's type); `blocks` comes from
// kernel.backward_blocks(N, rows_per_block), and `partial` holds
// blocks * rows_per_block rows of D floats.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* g, const void* scale, void* dx,
                                  void* dscale, void* partial, int64_t rows, int64_t cols,
                                  int x_dtype, int scale_dtype, int unit, int threads,
                                  int rows_per_block, int blocks, float eps,
                                  cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || cols > 2147483647LL || unit <= 0 || cols % unit ||
      threads < kWarp || threads % kWarp || rows_per_block < 1 || blocks < 1 ||
      int64_t(threads) * kPer * unit < cols)
    return int(cudaErrorInvalidValue);
  const int c = int(cols);
  float* part = static_cast<float*>(partial);
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, g, scale, dx, dscale, part, rows, c, unit, threads,
                                rows_per_block, blocks, eps, stream);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, g, scale, dx, dscale, part, rows, c, unit, threads,
                                        rows_per_block, blocks, eps, stream);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, g, scale, dx, dscale, part, rows, c, unit, threads,
                                        rows_per_block, blocks, eps, stream);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, g, scale, dx, dscale, part, rows, c, unit,
                                                threads, rows_per_block, blocks, eps, stream);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rmsnorm_bwd_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
