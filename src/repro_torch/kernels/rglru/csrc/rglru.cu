// RG-LRU linear recurrence on Hopper (sm_90a).
//
// Replaces the TPU kernel `_rglru_kernel` in src/repro/kernels/rglru/kernel.py:32
// (wrapper `rglru_scan_pallas`, entry point `ops.rglru_scan`).  For a, b [B, S, W]
// and an optional carried state h0 [B, W] (absent: zeros):
//
//     h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0,
//
// carried in f32; every h_t is written in a's type and the last one, h_last [B, W],
// in f32, as the plain version (ref.py) returns them.
//
// What bounds it: bytes.  Two f32 operations per element against reading a and b
// once and writing h once, plus h0 and h_last per row: the least time is those
// bytes at 3.35 TB/s.  One prefill launch of recurrentgemma-2b in f32 at S = 3000,
// W = 2560 moves 92 MB, 27 us.
//
// Design, simple first: the TPU kernel's split, channel-parallel and time-serial.
// One thread owns one (b, w) channel on a grid of (ceil(W / 128), B) blocks of 128
// threads and walks t in a loop with h in a register; the ragged W edge is masked,
// not padded.  Neighbouring threads hold neighbouring w, so each step's loads and
// stores coalesce.  The loop is unrolled by 8: the 16 loads of a and b for 8 steps
// do not depend on h, so they are issued before the 8 dependent steps and share one
// memory latency.  At batch 1 and W = 2560 the grid is B * W / 128 = 20 blocks, on
// 20 of the 132 SMs with 4 warps each: a long prefill is latency-bound, several
// times its byte bound.  The chunked parallel scan over S that the TPU kernel's
// docstring names as the GPU form (each chunk's (prod a, local h) pair, combined
// across chunks, then a pass that applies the carried state) is the later redesign
// (ROADMAP queue 2).
//
// Rounding: a * h + b is not contracted to an fma.  The product and the sum are
// each rounded (__fmul_rn, __fadd_rn), as the plain version's mul kernel and add
// kernel round them, so the kernel equals its plain version bit for bit.  An fma
// would differ by one rounding of a * h per step (2^-24 relative); that error decays
// by a each step and adds up like a random walk to about 2^-24 |h| / sqrt(1 - a^2),
// about 1e-6 for |h| ~ 1 at a = 0.999: inside the f32 tolerance of 1e-5, but with
// little to spare where |h| and a are both large.
//
// The entry point launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

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

// h0_dtype: -1 = absent (zeros), 0 = float32, 1 = bfloat16.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
             const void* __restrict__ h0, int h0_dtype, TA* __restrict__ h,
             float* __restrict__ h_last, int64_t S, int64_t W) {
  const int64_t w = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= W) return;
  const int64_t row = blockIdx.y;
  float hv = 0.f;
  if (h0_dtype == 0)
    hv = static_cast<const float*>(h0)[row * W + w];
  else if (h0_dtype == 1)
    hv = __bfloat162float(static_cast<const __nv_bfloat16*>(h0)[row * W + w]);

  const int64_t base = row * S * W + w;
  const TA* ap = a + base;
  const TB* bp = b + base;
  TA* hp = h + base;
  int64_t t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      av[k] = to_float(ap[(t + k) * W]);
      bv[k] = to_float(bp[(t + k) * W]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      hv = step(av[k], hv, bv[k]);
      hp[(t + k) * W] = from_float<TA>(hv);
    }
  }
  for (; t < S; ++t) {
    hv = step(to_float(ap[t * W]), hv, to_float(bp[t * W]));
    hp[t * W] = from_float<TA>(hv);
  }
  h_last[row * W + w] = hv;
}

template <typename TA, typename TB>
int launch(const void* a, const void* b, const void* h0, void* h, float* h_last,
           int64_t B, int64_t S, int64_t W, int h0_dtype, cudaStream_t stream) {
  const dim3 grid(unsigned((W + kThreads - 1) / kThreads), unsigned(B));
  rglru_kernel<TA, TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), h0, h0_dtype,
      static_cast<TA*>(h), h_last, S, W);
  return int(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; h0_dtype -1 means h0 is absent.
extern "C" int rglru_launch(const void* a, const void* b, const void* h0, void* h,
                            void* h_last, int64_t B, int64_t S, int64_t W, int a_dtype,
                            int b_dtype, int h0_dtype, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || S < 0 || W <= 0 || (W + kThreads - 1) / kThreads > 2147483647LL)
    return int(cudaErrorInvalidValue);
  if (h0_dtype < -1 || h0_dtype > 1 || (h0_dtype >= 0) != (h0 != nullptr))
    return int(cudaErrorInvalidValue);
  auto* hl = static_cast<float*>(h_last);
  if (a_dtype == 0 && b_dtype == 0)
    return launch<float, float>(a, b, h0, h, hl, B, S, W, h0_dtype, stream);
  if (a_dtype == 0 && b_dtype == 1)
    return launch<float, __nv_bfloat16>(a, b, h0, h, hl, B, S, W, h0_dtype, stream);
  if (a_dtype == 1 && b_dtype == 0)
    return launch<__nv_bfloat16, float>(a, b, h0, h, hl, B, S, W, h0_dtype, stream);
  if (a_dtype == 1 && b_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, b, h0, h, hl, B, S, W, h0_dtype, stream);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rglru_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
