// Fused RMS norm on Hopper (sm_90a).
//
// Replaces the TPU kernel `_rmsnorm_kernel` in
// src/repro/kernels/rmsnorm/kernel.py (wrapper `rms_norm_pallas`).  For each
// row of x [N, D]:  out = x * (1 / sqrt(mean(x^2) + eps)) * (1 + scale),
// computed in f32 and written once in x's type.
//
// What bounds it: bytes.  Each element is read, squared and added, then
// read again (from L1/L2: a row is at most a few tens of KB), scaled twice
// and written: a few FP32 operations per 2 * sizeof(x) bytes of device
// memory traffic, far below the card's ratio of operations to bytes.  The
// least time is 2 * N * D * sizeof(x) / 3.35 TB/s.
//
// Design: one block per row, so any N works with no padding (the TPU
// version pads N to its 256-row blocks).  Threads stride over the row with
// 16-byte vector loads (4 f32 or 8 bf16) where D and the pointers allow it,
// and with scalar loads otherwise.  The sum of squares is reduced in f32
// within each warp by shuffles, then across warps through shared memory.
// The block has 32 to 256 threads, about one per vector of the row.
//
// Rounding: the reciprocal square root is 1.0f / sqrtf(v), both correctly
// rounded (nvcc's default -prec-sqrt=true -prec-div=true), rather than
// rsqrtf, whose error of up to 2 ulp could use up the f32 tolerance of
// 1e-6 on its own.  The mean divides the sum by D, as jnp.mean does.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of T as one aligned vector.
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

__device__ __forceinline__ float block_sum(float v, float* shared) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  const int warps = (blockDim.x + 31) / 32;
  v = lane < warps ? shared[lane] : 0.f;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;  // every thread holds the block's sum
}

template <typename T, typename S, bool kVector>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                               T* __restrict__ out, int64_t cols, float eps) {
  __shared__ float partial[kMaxThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * cols;
  T* outr = out + row * cols;
  using V = Vec<T>;
  constexpr int kN = V::kN;

  float ss = 0.f;
  if (kVector) {
    const V* xv = reinterpret_cast<const V*>(xr);
    for (int64_t i = threadIdx.x; i < cols / kN; i += blockDim.x) {
      const V chunk = xv[i];
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float f = to_float(chunk.v[e]);
        ss += f * f;
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < cols; i += blockDim.x) {
      const float f = to_float(xr[i]);
      ss += f * f;
    }
  }
  ss = block_sum(ss, partial);
  const float inv = 1.0f / sqrtf(ss / float(cols) + eps);

  if (kVector) {
    const V* xv = reinterpret_cast<const V*>(xr);
    V* ov = reinterpret_cast<V*>(outr);
    for (int64_t i = threadIdx.x; i < cols / kN; i += blockDim.x) {
      const V chunk = xv[i];
      V res;
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float s = to_float(scale[i * kN + e]);
        res.v[e] = from_float<T>((to_float(chunk.v[e]) * inv) * (1.0f + s));
      }
      ov[i] = res;
    }
  } else {
    for (int64_t i = threadIdx.x; i < cols; i += blockDim.x) {
      const float s = to_float(scale[i]);
      outr[i] = from_float<T>((to_float(xr[i]) * inv) * (1.0f + s));
    }
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int64_t rows, int64_t cols,
           float eps, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  const bool vector = cols % kN == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t per_row = vector ? cols / kN : cols;
  int threads = int(((per_row + 31) / 32) * 32);
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const auto* xt = static_cast<const T*>(x);
  const auto* st = static_cast<const S*>(scale);
  auto* ot = static_cast<T*>(out);
  if (vector)
    rmsnorm_kernel<T, S, true><<<unsigned(rows), threads, 0, stream>>>(xt, st, ot, cols, eps);
  else
    rmsnorm_kernel<T, S, false><<<unsigned(rows), threads, 0, stream>>>(xt, st, ot, cols, eps);
  return int(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x and out share one type).
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out, int64_t rows,
                              int64_t cols, int x_dtype, int scale_dtype, float eps,
                              cudaStream_t stream) {
  if (rows <= 0 || rows > 2147483647LL || cols <= 0) return int(cudaErrorInvalidValue);
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, out, rows, cols, eps, stream);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, cols, eps, stream);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, cols, eps, stream);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, cols, eps, stream);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
