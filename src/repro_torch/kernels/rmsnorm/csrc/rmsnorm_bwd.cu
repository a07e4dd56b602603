// Gradient of the fused RMS norm on Hopper (sm_90a).
//
// Replaces no TPU kernel: `_rmsnorm_kernel` (src/repro/kernels/rmsnorm/
// kernel.py) has no backward, since JAX differentiates the jnp model.  The
// port's model calls the forward kernel (rmsnorm.cu), so training needs this
// gradient.  For each row of x [N, D] with upstream gradient g [N, D] (x's
// type), all in f32:
//
//   r  = 1 / sqrt(mean(x^2) + eps)        gs = g * (1 + scale)
//   dx = r * gs - (x * r^3) * mean(x * gs)
//   dscale = sum over rows of g * (x * r)
//
// What bounds it: bytes.  x and g are read once and dx written once, with
// a few FP32 operations an element: (3 N D sizeof(x) + 2 D sizeof(scale))
// / 3.35 TB/s, 9.4 us at recurrentgemma-2b's [2048, 2560] bf16.
//
// Design.  The first version borrowed the forward's plan (one row a block,
// at most 264 blocks each walking N / 264 rows one after another, two
// block-wide barriers a row, nothing of the next row in flight) and summed
// dscale's 264 partial rows in a launch of D / 256 blocks: 29 % of the bound.
// This one has a plan of its own (kernel.backward_plan(D, dtype)):
//  * A row is cut into units of 16 bytes of x (one element where D is not a
//    multiple of that) and a row's threads (a multiple of 32) hold up to
//    kPer = 4 units of x and of g each: a row of 2,560 bf16 is 3 warps, one
//    of 1,024 a single warp.
//  * A block holds `groups` row groups (up to 384 threads in all); a lane,
//    one group of one block, walks rows lane, lane + lanes, ...  It keeps
//    `ring` rows in flight: one thread of the group has the TMA unit copy
//    each whole row of x and of g into a slot of shared memory, completing
//    on the slot's mbarrier, and refills the slot with the row `ring` steps
//    on as soon as the group holds the current one in registers.  Rows that
//    are not whole 16-byte units, or whose ring would not fit, take the
//    register path: the next row loaded into registers under the current
//    one (at 8 bf16 a unit it spills 244 bytes, and no config's width takes
//    it).  The grid is kernel.backward_blocks(N, plan): a row a lane, at
//    most 128 blocks.  At N = 2,048 and D = 2,560: 128 blocks of 4 groups
//    of 96 threads, a ring of 2, 4 rows a lane (the fastest of the plans
//    timed on the H100; more blocks, or the register path, were slower).
//  * A row's sums of x^2 and x * gs reduce by warp shuffles, then, where a
//    row spans warps, through shared memory behind a named barrier of the
//    row's own warps (bar.sync 1 + group): no block-wide barrier a row.
//    The exchange slots alternate between rows, so one barrier a row does.
//  * dscale: each thread sums g * (x * r) over its lane's rows for the
//    columns it owns, in registers; at the end the block adds its groups'
//    sums in group order through shared memory and writes one row of
//    `partial` [blocks, D]; the second launch sums those rows column by
//    column, 32 columns a block of 8 warps (warp w takes rows w, w + 8, ...
//    in order, then warp 0 adds the 8 sums in order): D / 32 blocks.
// No atomics.  A row's dx depends on that row, D and the type only (the
// plan is a function of D and the type); dscale on N, D and the types only
// (the grid is a function of N and the plan, never of the card's SM count),
// so a replayed training step gives the same bits, on any card.
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
constexpr int kMaxBlock = 512;
constexpr int kMaxGroups = 8;  // named barriers 1..8
constexpr int kPer = 4;        // units of x (and of g) a thread holds
constexpr int kColWarps = 8;

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

// Barrier of one row group's `threads` threads (a multiple of 32).
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename T, int kUnit>
struct RowRegs {
  Pack<T, kUnit> x[kPer], g[kPer];
};

// x's and g's units of `row` that thread `tid` of a row group holds; zeros
// past the row's end or past N.
template <typename T, int kUnit>
__device__ __forceinline__ void load_row(RowRegs<T, kUnit>& r, const T* __restrict__ x,
                                         const T* __restrict__ g, int64_t row, int64_t rows,
                                         int cols, int units, int tid, int threads) {
  using XP = Pack<T, kUnit>;
  const XP* xr = reinterpret_cast<const XP*>(x + row * cols);
  const XP* gr = reinterpret_cast<const XP*>(g + row * cols);
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int u = tid + p * threads;
    if (row < rows && u < units) {
      r.x[p] = xr[u];
      r.g[p] = gr[u];
    } else {
#pragma unroll
      for (int e = 0; e < kUnit; ++e) {
        r.x[p].v[e] = from_float<T>(0.f);
        r.g[p].v[e] = from_float<T>(0.f);
      }
    }
  }
}

// 1 + scale of unit u's kUnit columns, from shared memory: 16-byte loads
// where a unit spans 4 or 8 floats (a thread's 32 bytes in scalar loads
// would be an 8-way bank conflict).
template <int kUnit>
__device__ __forceinline__ void load_weights(const float* sw, int u, float (&w)[kUnit]) {
  if constexpr (kUnit % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kUnit / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(sw)[u * (kUnit / 4) + q];
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kUnit; ++e) w[e] = sw[u * kUnit + e];
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed; a wait past 10 s
// traps, so a lost copy fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t start, now;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(start));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (now - start > 10000000000ull) __trap();
  }
}

// Row `row` of x and of g into a ring slot, completing on `bar`; a row
// past N completes the barrier's phase without bytes.
template <typename T>
__device__ __forceinline__ void ring_load(uint32_t slot, uint32_t bar, const T* x, const T* g,
                                          int64_t row, int64_t rows, int cols) {
  const uint32_t bytes = uint32_t(cols * sizeof(T));
  if (row >= rows) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
    return;
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(2 * bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(slot), "l"(x + row * cols), "r"(bytes), "r"(bar) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(slot + bytes), "l"(g + row * cols), "r"(bytes), "r"(bar) : "memory");
}

// The rows of a block's lanes.  kRing: each lane keeps `ring` rows of x
// and g in flight, copied whole into shared memory by the TMA unit (rows of
// a multiple of 16 bytes); otherwise it loads the next row into registers
// under the current one.
template <typename T, typename S, int kUnit, bool kRing>
__global__ void __launch_bounds__(kMaxBlock)
rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ g, const S* __restrict__ scale,
                 T* __restrict__ dx, float* __restrict__ partial, int64_t rows, int cols,
                 int threads, int64_t iters, int ring, float eps) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);  // 1 + scale, [cols]
  float* red = sw + cols;                       // each group's dscale sums, [groups][cols]
  __shared__ float2 pair[2][kMaxBlock / kWarp];
  using XP = Pack<T, kUnit>;
  const int groups = blockDim.x / threads;
  const int group = threadIdx.x / threads, tid = threadIdx.x % threads;
  const int64_t lanes = int64_t(gridDim.x) * groups;
  const int64_t lane = int64_t(blockIdx.x) * groups + group;
  const int units = cols / kUnit;
  const int warps = threads / kWarp, lane_in_warp = threadIdx.x % kWarp;
  const float inv_cols = 1.0f / float(cols);
  // The ring: per group `ring` slots of [x row | g row], then a barrier each.
  T* slots = reinterpret_cast<T*>(red + groups * cols) + size_t(group) * ring * 2 * cols;
  const uint32_t bars = uint32_t(__cvta_generic_to_shared(
                            reinterpret_cast<T*>(red + groups * cols) +
                            size_t(groups) * ring * 2 * cols)) + 8 * group * ring;

  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    sw[c] = __fadd_rn(1.0f, to_float(scale[c]));
  if constexpr (kRing) {
    if (tid == 0) {
      for (int k = 0; k < ring; ++k) mbar_init(bars + 8 * k, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  if constexpr (kRing) {
    if (tid == 0)
      for (int64_t k = 0; k < ring && k < iters; ++k)
        ring_load(uint32_t(__cvta_generic_to_shared(slots + k * 2 * cols)), bars + 8 * k, x, g,
                  lane + k * lanes, rows, cols);
  }

  float acc[kPer][kUnit];
#pragma unroll
  for (int p = 0; p < kPer; ++p)
#pragma unroll
    for (int e = 0; e < kUnit; ++e) acc[p][e] = 0.f;

  // This lane's rows in order.  Every thread of a group runs every step
  // (the group's barrier).
  RowRegs<T, kUnit> cur, nxt;
  if constexpr (!kRing) load_row(cur, x, g, lane, rows, cols, units, tid, threads);
  for (int64_t it = 0; it < iters; ++it) {
    const int64_t row = lane + it * lanes;
    const int slot = int(it % ring);
    if constexpr (kRing) {
      mbar_wait(bars + 8 * slot, uint32_t(it / ring) & 1);
      load_row(cur, slots + size_t(slot) * 2 * cols, slots + size_t(slot) * 2 * cols + cols,
               int64_t(0), int64_t(1), cols, units, tid, threads);
    } else if (it + 1 < iters) {
      load_row(nxt, x, g, row + lanes, rows, cols, units, tid, threads);
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int u = tid + p * threads;
      if (u < units) {
        float w[kUnit];
        load_weights<kUnit>(sw, u, w);
#pragma unroll
        for (int e = 0; e < kUnit; ++e) {
          const float f = to_float(cur.x[p].v[e]);
          ss = __fadd_rn(ss, __fmul_rn(f, f));
          dot = __fadd_rn(dot, __fmul_rn(f, __fmul_rn(to_float(cur.g[p].v[e]), w[e])));
        }
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    float2* part_slot = pair[it & 1] + group * warps;
    if (warps > 1) {  // the same for every thread of the block
      if (lane_in_warp == 0) part_slot[tid / kWarp] = make_float2(ss, dot);
      group_sync(1 + group, threads);
    } else {
      __syncwarp();
    }
    // Every thread of the group holds its part of the row: the slot takes
    // the lane's row `ring` steps on.
    if constexpr (kRing) {
      if (tid == 0 && it + ring < iters) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        ring_load(uint32_t(__cvta_generic_to_shared(slots + size_t(slot) * 2 * cols)),
                  bars + 8 * slot, x, g, row + ring * lanes, rows, cols);
      }
    }
    if (warps > 1) {
      const float2 mine =
          lane_in_warp < warps ? part_slot[lane_in_warp] : make_float2(0.f, 0.f);
      ss = mine.x;
      dot = mine.y;
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
    }
    if (row < rows) {
      const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_cols), eps));
      const float r3 = __fmul_rn(__fmul_rn(r, r), r);
      const float mean_dot = __fmul_rn(dot, inv_cols);
      XP* orow = reinterpret_cast<XP*>(dx + row * cols);
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int u = tid + p * threads;
        if (u < units) {
          XP res;
          float w[kUnit];
          load_weights<kUnit>(sw, u, w);
#pragma unroll
          for (int e = 0; e < kUnit; ++e) {
            const float f = to_float(cur.x[p].v[e]), gf = to_float(cur.g[p].v[e]);
            const float gs = __fmul_rn(gf, w[e]);
            const float t = __fmul_rn(__fmul_rn(f, r3), mean_dot);
            res.v[e] = from_float<T>(__fsub_rn(__fmul_rn(r, gs), t));
            acc[p][e] = __fadd_rn(acc[p][e], __fmul_rn(gf, __fmul_rn(f, r)));
          }
          orow[u] = res;
        }
      }
    }
    if constexpr (!kRing) cur = nxt;
  }

  // The block's dscale sums: its groups' in group order, one row of partial.
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int u = tid + p * threads;
    if (u < units)
#pragma unroll
      for (int e = 0; e < kUnit; ++e) red[group * cols + u * kUnit + e] = acc[p][e];
  }
  __syncthreads();
  float* prow = partial + int64_t(blockIdx.x) * cols;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float s = red[c];
    for (int k = 1; k < groups; ++k) s = __fadd_rn(s, red[k * cols + c]);
    prow[c] = s;
  }
}

// dscale from partial [blocks, D]: 32 columns a block; warp w sums rows w,
// w + 8, ... in order, then warp 0 adds the 8 sums in order.
template <typename S>
__global__ void __launch_bounds__(kColWarps * kWarp)
rmsnorm_bwd_cols(const float* __restrict__ partial, S* __restrict__ dscale, int blocks, int cols) {
  __shared__ float sums[kColWarps][kWarp];
  const int w = threadIdx.x / kWarp, l = threadIdx.x % kWarp;
  const int col = blockIdx.x * kWarp + l;
  float s = 0.f;
  if (col < cols)
    for (int b = w; b < blocks; b += kColWarps) s = __fadd_rn(s, partial[int64_t(b) * cols + col]);
  sums[w][l] = s;
  __syncthreads();
  if (w == 0 && col < cols) {
    float t = sums[0][l];
#pragma unroll
    for (int k = 1; k < kColWarps; ++k) t = __fadd_rn(t, sums[k][l]);
    dscale[col] = from_float<S>(t);
  }
}

template <typename T, typename S, int kUnit>
int launch_unit(const void* x, const void* g, const void* scale, void* dx, void* dscale,
                float* partial, int64_t rows, int cols, int threads, int groups, int ring,
                int blocks, float eps, cudaStream_t stream) {
  const int block = groups * threads;
  if (block > kMaxBlock || groups > kMaxGroups || int64_t(threads) * kPer * kUnit < cols ||
      ring < 0 || (ring > 0 && (kUnit == 1 || (cols * sizeof(T)) % 16)))
    return int(cudaErrorInvalidValue);
  const int64_t lanes = int64_t(blocks) * groups;
  const int64_t iters = (rows + lanes - 1) / lanes;
  const size_t smem = sizeof(float) * size_t(cols) * (1 + groups) +
                      size_t(groups) * ring * (2 * cols * sizeof(T) + 8);
  auto kernel = ring > 0 ? rmsnorm_bwd_rows<T, S, kUnit, true>
                         : rmsnorm_bwd_rows<T, S, kUnit, false>;
  if (smem + sizeof(float2) * kMaxBlock / kWarp * 2 > 48 * 1024) {  // beside `pair`
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<blocks, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const S*>(scale),
      static_cast<T*>(dx), partial, rows, cols, threads, iters, ring > 0 ? ring : 1, eps);
  const int err = int(cudaGetLastError());
  if (err != 0) return err;
  rmsnorm_bwd_cols<S><<<(cols + kWarp - 1) / kWarp, kColWarps * kWarp, 0, stream>>>(
      partial, static_cast<S*>(dscale), blocks, cols);
  return int(cudaGetLastError());
}

template <typename T, typename S>
int launch(const void* x, const void* g, const void* scale, void* dx, void* dscale,
           float* partial, int64_t rows, int cols, int unit, int threads, int groups, int ring,
           int blocks, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (unit == kVec) {
    if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(g) % 16 ||
        reinterpret_cast<uintptr_t>(dx) % 16)
      return int(cudaErrorMisalignedAddress);
    return launch_unit<T, S, kVec>(x, g, scale, dx, dscale, partial, rows, cols, threads, groups,
                                   ring, blocks, eps, stream);
  }
  if (unit == 1)
    return launch_unit<T, S, 1>(x, g, scale, dx, dscale, partial, rows, cols, threads, groups,
                                ring, blocks, eps, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x, g and dx share one type; scale
// and dscale another).  The plan (unit, threads, groups, ring) is
// kernel.backward_plan(D, x's type); `blocks` comes from
// kernel.backward_blocks(N, plan), and `partial` holds `blocks` rows of D
// floats.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* g, const void* scale, void* dx,
                                  void* dscale, void* partial, int64_t rows, int64_t cols,
                                  int x_dtype, int scale_dtype, int unit, int threads, int groups,
                                  int ring, int blocks, float eps, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || cols > 2147483647LL || unit <= 0 || cols % unit ||
      threads < kWarp || threads % kWarp || groups < 1 || blocks < 1)
    return int(cudaErrorInvalidValue);
  const int c = int(cols);
  float* part = static_cast<float*>(partial);
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, g, scale, dx, dscale, part, rows, c, unit, threads, groups,
                                ring, blocks, eps, stream);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, g, scale, dx, dscale, part, rows, c, unit, threads,
                                        groups, ring, blocks, eps, stream);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, g, scale, dx, dscale, part, rows, c, unit, threads,
                                        groups, ring, blocks, eps, stream);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, g, scale, dx, dscale, part, rows, c, unit,
                                                threads, groups, ring, blocks, eps, stream);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rmsnorm_bwd_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
