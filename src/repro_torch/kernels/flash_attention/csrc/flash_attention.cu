// Flash attention (forward) on Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py (wrapper
// `flash_attention_pallas`, GQA expansion in `ops.flash_attention`).  It
// computes softmax(q k^T / sqrt(D) + mask) v with f32 accumulation and an
// online softmax, so no [Sq, Skv] tensor ever exists.  The mask is causal
// (key <= query) and/or a sliding window (key > query - window), counted
// from position 0 for both q and k, and always k < Skv.
//
// What bounds it: operations.  Causal attention does 4 * D FLOPs for every
// visible (query, key) pair and moves only Q, K, V and O, so at the serving
// shapes (D = 128, hundreds of keys per query) it lies far above the card's
// ratio of operations to bytes.  The least time is 4 * B * H * D * (visible
// pairs) at the bf16 tensor-core rate of 989 TFLOP/s.  This first kernel
// runs on the CUDA cores in f32 (67 TFLOP/s at most), so it cannot come
// near that bound; wgmma, TMA and a pipelined design are later work.
//
// Design: one block of 128 threads per (query tile, head, batch).  A query
// tile of BQ rows (64, or 32 when D = 256) is kept in shared memory in f32.
// The block walks 64-key tiles of K and V through shared memory, from the first
// tile the window can reach to the last one the diagonal reaches; tiles
// wholly above the diagonal or before the window are never loaded.  Each
// thread owns RQ query rows and 8 keys (key = lane % 8 + 8 j) of the score
// tile, keeps its scores in registers, and takes each row's max and sum by
// shuffles within its group of 8 lanes.  The running (max, denominator,
// output) stay in f32 registers; for P V each thread owns a fixed set of
// output columns and fetches the probabilities it needs from its group's
// lanes by shuffles.  Rows of Q and K in shared memory are padded by 4
// floats, so the 16-byte reads of a quarter-warp fall in distinct banks.
//
// Layout: q, k, v and o are [B, heads, S, D] with any strides for B, heads
// and S (the last dimension must be contiguous), so the model's [B, S, H, D]
// tensors are read in place.  GQA: query head h reads KV head h / (H / KV),
// which is the head jnp.repeat gives it; K and V are never repeated.
//
// Scale: each score is q.k * (1/sqrt(D)), as the plain version computes it
// (PyTorch divides by a scalar as a product with its reciprocal); the TPU
// kernel scales q before the product instead, which rounds differently.
// Scaling q first gave f32 errors up to 1.85e-6 against the plain version
// at yi-9b's shapes on an H100, close to the 2e-6 tolerance.
//
// Masking: masked scores are -inf.  A row whose visible keys are all masked
// (possible only with a window and no causal mask) keeps a denominator of 0
// and is written as 0, guarded by max(l, 1e-30) as in the TPU kernel.
// Query rows past Sq are computed on zeros and not written; keys past Skv
// are loaded as zeros and masked.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 16 groups of 8 lanes
constexpr int kBK = 64;        // keys per tile: 8 per lane

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Strides {
  int64_t b, h, s;
};

template <int D>
struct Shape {
  static constexpr int kRQ = D >= 256 ? 2 : 4;     // query rows per thread
  static constexpr int kBQ = 16 * kRQ;             // query rows per block
  static constexpr int kDP = D + 4;                // padded row of Q and K
  static constexpr int kVec = D >= 32 ? 4 : D / 8; // output columns per chunk
  static constexpr int kChunks = D / (8 * kVec);   // chunks per thread
  static constexpr size_t kSmemBytes =
      sizeof(float) * (size_t(kBQ) * kDP + size_t(kBK) * kDP + size_t(kBK) * D);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int H, int KV, int64_t Sq, int64_t Skv, Strides qs,
             Strides ks, Strides vs, Strides os, int causal, int64_t window, float sm_scale) {
  using Sh = Shape<D>;
  constexpr int RQ = Sh::kRQ, BQ = Sh::kBQ, DP = Sh::kDP, VEC = Sh::kVec, NC = Sh::kChunks;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + kBK * DP;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid & 7;   // key / column slot within the group of 8 lanes
  const int ty = tid >> 3;  // row group
  const int group_base = lane & ~7;
  const int b = blockIdx.z, h = blockIdx.y;
  const int kvh = h / (H / KV);
  const int64_t q0 = int64_t(blockIdx.x) * BQ;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int64_t qg = q0 + r;
    Qs[r * DP + d] = qg < Sq ? to_float(qb[qg * qs.s + d]) : 0.f;
  }

  // Keys this tile's rows can see: [k_lo, k_hi).
  const int64_t q_last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  int64_t k_hi = causal ? (q_last + 1 < Skv ? q_last + 1 : Skv) : Skv;
  int64_t k_lo = window > 0 ? q0 - window + 1 : 0;
  if (k_lo < 0) k_lo = 0;

  float m[RQ], l[RQ], acc[RQ][NC][VEC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][c][e] = 0.f;
  }

  for (int64_t k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done (and Q is in)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const int64_t kg = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kg < Skv) {
        kv = to_float(kb[kg * ks.s + d]);
        vv = to_float(vb[kg * vs.s + d]);
      }
      Ks[c * DP + d] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    float s[RQ][8];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * RQ + i) * DP + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[(tx + 8 * j) * DP + d]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          s[i][j] += qv[i].x * kk.x;
          s[i][j] += qv[i].y * kk.y;
          s[i][j] += qv[i].z * kk.z;
          s[i][j] += qv[i].w * kk.w;
        }
      }
    }

    // Mask, then the online softmax update of each row.
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int64_t qg = q0 + ty * RQ + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t kg = k0 + tx + 8 * j;
        const bool ok = kg < Skv && (!causal || kg <= qg) && (window <= 0 || kg > qg - window);
        s[i][j] = ok ? s[i][j] * sm_scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no -inf - -inf
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][c][e] *= alpha;
    }

    // acc += P V: key c's probability for row i lives in lane c % 8 of the
    // group, register j = c / 8.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int src = 0; src < 8; ++src) {
        const int c = src + 8 * j;
        float p[RQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i) p[i] = __shfl_sync(0xffffffffu, s[i][j], group_base | src);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float* vrow = &Vs[c * D + cc * 8 * VEC + tx * VEC];
          float vv[VEC];
          if constexpr (VEC == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow);
            vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) vv[e] = vrow[e];
          }
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][cc][e] += p[i] * vv[e];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int64_t qg = q0 + ty * RQ + i;
    if (qg >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = ob + qg * os.s;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[cc * 8 * VEC + tx * VEC + e] = from_float<T>(acc[i][cc][e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
           int64_t Sq, int64_t Skv, Strides qs, Strides ks, Strides vs, Strides os,
           int causal, int64_t window, float sm_scale, cudaStream_t stream) {
  using Sh = Shape<D>;
  const int64_t tiles = (Sq + Sh::kBQ - 1) / Sh::kBQ;
  if (tiles > 2147483647LL || H > 65535 || B > 65535) return int(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(Sh::kSmemBytes));
  if (err != cudaSuccess) return int(err);
  flash_kernel<T, D><<<dim3(unsigned(tiles), unsigned(H), unsigned(B)), kThreads,
                       Sh::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, Sq, Skv, qs, ks, vs, os, causal, window, sm_scale);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int H,
               int KV, int64_t Sq, int64_t Skv, Strides qs, Strides ks, Strides vs,
               Strides os, int causal, int64_t window, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, causal, window, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, causal, window, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, causal, window, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, causal, window, sm_scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, causal, window, sm_scale, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and o share one type).
// Strides are in elements, for the batch, head and sequence dimensions.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int64_t Sq,
    int64_t Skv, int D, int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
    int64_t kss, int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
    int64_t oss, int causal, int64_t window, float sm_scale, int dtype, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0)
    return int(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, causal, window,
                             sm_scale, stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KV, Sq, Skv, qs, ks, vs, os, causal,
                                     window, sm_scale, stream);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
