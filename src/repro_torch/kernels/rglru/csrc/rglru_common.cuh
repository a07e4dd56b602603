// What the RG-LRU scan (rglru.cu) and its backward (rglru_bwd.cu) share: the
// limits of the chunk plan (kernel.chunk_plan), the f32/bf16 conversions, the
// rounded step, the plan's check and its launch.  See rglru.cu's head note for
// the plan: a warp per (stripe of 32 channels, chunk), the chunks of a stripe the
// warps of a thread block cluster along grid.y, one launch.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxChunksPerCta = 8;  // chunks a CTA holds, one a warp
constexpr int kMaxCtas = 8;          // CTAs a cluster holds (the portable limit)
constexpr int kMaxChunks = kMaxChunksPerCta * kMaxCtas;
constexpr int kMaxThreads = 256;
constexpr int kTile = 16;            // steps a thread loads at once

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

__device__ __forceinline__ int tile_len(int64_t t, int64_t end) {
  return end - t < kTile ? int(end - t) : kTile;
}

// Element i of a [B, W] state given by dtype code: -1 = absent (0), 0 = float32,
// 1 = bfloat16.
__device__ __forceinline__ float load_state(const void* p, int dtype, int64_t i) {
  if (dtype == 0) return static_cast<const float*>(p)[i];
  if (dtype == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return 0.f;
}

// A plan (chunk length L, chunks C, chunks a CTA, CTAs a cluster, channels a CTA,
// CTAs across W) that covers [0, S) chunk by chunk and W stripe by stripe and fits
// a cluster; the state's dtype code agrees with its pointer.
inline bool plan_ok(int64_t B, int64_t S, int64_t W, int64_t L, int C, int per_cta,
                    int ctas, int stripe, int64_t stripes, const void* state,
                    int state_dtype) {
  if (B <= 0 || B > 65535 || S < 0 || W <= 0 || stripe < kWarp || stripe % kWarp ||
      stripes != (W + stripe - 1) / stripe || stripes > 2147483647LL)
    return false;
  if (L < 1 || C < 1 || C > kMaxChunks || per_cta < 1 || per_cta > kMaxChunksPerCta ||
      ctas < 1 || ctas > kMaxCtas || per_cta * ctas < C || per_cta * stripe > kMaxThreads ||
      L * C < S || (C > 1 && L * (C - 1) >= S))
    return false;
  return state_dtype >= -1 && state_dtype <= 1 && (state_dtype >= 0) == (state != nullptr);
}

// One launch of `kernel` over the plan on `stream`: CTAs of `per_cta` warps of
// `stripe` channels, grid (stripes, ctas, B).  With C > 1 the CTAs along y form a
// cluster and share (per_cta + C - 1) * stripe (A, l) pairs of shared memory; one
// chunk is the sequential scan, launched plainly.  Returns the launch's error, or
// cudaGetLastError().
template <typename... Params, typename... Args>
int launch_plan(void (*kernel)(Params...), int64_t B, int C, int per_cta, int ctas,
                int stripe, int64_t stripes, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(unsigned(stripes), unsigned(ctas), unsigned(B));
  config.blockDim = dim3(unsigned(per_cta * stripe));
  config.stream = stream;
  cudaLaunchAttribute cluster;
  if (C > 1) {
    config.dynamicSmemBytes = size_t(per_cta + C - 1) * stripe * sizeof(float2);
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = 1;
    cluster.val.clusterDim.y = unsigned(ctas);
    cluster.val.clusterDim.z = 1;
    config.attrs = &cluster;
    config.numAttrs = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace
