// RG-LRU backward on Hopper (sm_90a): the adjoint recurrence as one reverse-order
// chunked scan.
//
// The gradient of the scan `_rglru_kernel` (src/repro/kernels/rglru/kernel.py:32;
// the TPU kernel had no backward: the JAX package differentiates its jnp scan with
// jax.grad).  It replaces the forward kernel (rglru.cu) run on reversed inputs, a
// construction that took a cat, three flips with contiguous copies, the scan and
// the products of `ref._grads`: some 15 passes over [B, S, W] in 6-7 launches.
// For a, h [B, S, W] (the forward's inputs and states), gh [B, S, W] (the gradient
// of h), all of one dtype, g_last [B, W] f32 (of h_last) and an optional h0 [B, W]:
//
//     g_t = a_{t+1} * g_{t+1} + gh_t,   g_{S-1} = 1 * g_last + gh_{S-1},
//     db_t = g_t,   da_t = g_t * h_{t-1} (h_{-1} = h0, or 0),   dh0 = a_0 * g_0,
//
// carried in f32; da and db are written in f32, dh0 in h0's dtype.
//
// What bounds it: bytes.  Four f32 operations per element against reading a, h and
// gh once and writing da and db once: 20 bytes an f32 element.  A training call of
// recurrentgemma-2b at [1, 2048, 2560] moves 105 MB, 31.3 us at 3.35 TB/s.
//
// Design.  The forward's plan and layout (rglru.cu's head note), run from the end:
// `kernel.chunk_plan(S, W)`, a warp per (stripe of 32 channels, chunk) with lane =
// channel, a stripe's chunks the warps of a cluster of up to 8 CTAs along grid.y.
// Chunks are counted from the end of S: reversed chunk k holds the steps t from
// S-1-kL down to max(0, S-(k+1)L), so the ragged chunk is the one that holds t = 0.
// One launch:
//
//   1. Each warp walks its chunk from its last step down, from zero: A = prod of the
//      coefficients a_{t+1} (1 at t = S-1), l = the reverse scan of gh.
//   2. The (A, l) pairs cross the cluster through distributed shared memory
//      between two cluster.sync(), as in the forward.
//   3. Each warp carries g into its chunk in reversed chunk order from g_last,
//      g_in(k) = A(k-1) * g_in(k-1) + l(k-1), and
//   4. rescans its chunk from g_in, writing db_t = g_t and da_t = g_t * h_{t-1};
//      the warp that holds t = 0 writes dh0.
//
// Each step reads one row past the chunk's edge (a at t+1, h at t-1); those rows are
// loaded with the tile.  Loads go in tiles of kTile = 16 steps, all issued before
// the tile's dependent steps.  A chunk of up to kHold = 32 steps (every S up to
// 2,048: L = max(16, ceil(S / 64))) keeps its coefficients and gh in registers
// (64 floats a thread) from step 1 to step 4, so a, gh and h each cross device
// memory once: the bound's 20 bytes an element.  A longer chunk reads a and gh
// again in step 4 (28 bytes an element), as the forward does.  ptxas gives the
// kernel 127-128 registers a thread and no spills, so an SM holds two CTAs of 256
// threads.  At the training shape: L = 32, C = 64, 80 x 8 CTAs of 8 warps.  S <= 16
// is one chunk, the sequential scan, launched plainly (no cluster) over CTAs of 128
// channels.
//
// Rounding: every product and sum is rounded on its own (__fmul_rn, __fadd_rn; no
// fma), in the order of the construction it replaces, `ref.rglru_scan_backward` over
// the forward's chunked scan (`ref.rglru_scan_chunked` at the plan's L): the
// coefficient 1 at t = S-1 is multiplied as it is there (a product by 1 is exact),
// and da_0 is g_0 * 0 without h0, so the sign of a zero is the construction's.  So
// the kernel equals that construction, and `ref.rglru_scan_backward_chunked`, bit
// for bit at every shape.
//
// The entry point launches on the caller's stream, allocates nothing and returns
// the launch's error, or cudaGetLastError().

#include <cooperative_groups.h>

#include "rglru_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kHold = 2 * kTile;  // steps a chunk keeps in registers from step 1 to 4

// The n <= kTile steps t, t-1, ..., t-n+1 of one channel into registers: each
// step's coefficient a_{t+1} (1 at t = S-1) and its input gh_t, all loads issued
// before any is used.
template <typename T>
__device__ __forceinline__ void load_rev_tile(const T* ap, const T* gp, int64_t t, int n,
                                              int64_t S, int64_t W, float* cv, float* gv) {
  const T* ac = ap + (t + 1) * W;
  const T* gc = gp + t * W;
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    if (k == n) break;
    cv[k] = t + 1 - k < S ? to_float(*ac) : 1.f;
    gv[k] = to_float(*gc);
    ac -= W;
    gc -= W;
  }
}

// h_{t-1}, ..., h_{t-n} of one channel in f32; h_{-1} is `first` (h0, or 0).
template <typename T>
__device__ __forceinline__ void load_prev_tile(const T* hp, int64_t t, int n, int64_t W,
                                               float first, float* pv) {
  const T* hc = hp + (t - 1) * W;
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    if (k == n) break;
    pv[k] = t - k > 0 ? to_float(*hc) : first;
    hc -= W;
  }
}

// n <= kTile steps of the rescan from g, writing db and da at t, t-1, ...
__device__ __forceinline__ float rescan_tile(const float* cv, const float* gv,
                                             const float* pv, int n, float g, bool live,
                                             int64_t W, float*& dap, float*& dbp) {
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    if (k == n) break;
    g = step(cv[k], g, gv[k]);
    if (live) {
      *dbp = g;
      *dap = __fmul_rn(g, pv[k]);
    }
    dap -= W;
    dbp -= W;
  }
  return g;
}

// A CTA owns `stripe` channels (one a thread) of blockDim.x / stripe reversed
// chunks.  Shared memory (C > 1 only): this CTA's chunks' pairs, [chunks a CTA]
// [stripe], then the stripe's earlier reversed chunks' pairs, [C - 1][stripe].
// h0_dtype: -1 = absent (zeros, no dh0), 0 = float32, 1 = bfloat16.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                 const T* __restrict__ gh, const float* __restrict__ g_last,
                 const void* __restrict__ h0, int h0_dtype, float* __restrict__ da,
                 float* __restrict__ db, void* __restrict__ dh0, int64_t S, int64_t W,
                 int64_t L, int C, int stripe) {
  extern __shared__ float2 smem[];
  const int lane = threadIdx.x % stripe, slot = threadIdx.x / stripe;
  const int per_cta = blockDim.x / stripe;
  const int64_t w = int64_t(blockIdx.x) * stripe + lane;
  const bool live = w < W;
  const int64_t row = blockIdx.z;
  const int c = blockIdx.y * per_cta + slot;  // this thread's reversed chunk; c >= C idle
  // Steps s = S-1-t of the reversed order: the chunk holds s0 <= s < s1, that is
  // t from hi down to S - s1.
  const int64_t s0 = c * L < S ? c * L : S, s1 = s0 + L < S ? s0 + L : S;
  const int64_t hi = S - 1 - s0;
  const int steps = int(s1 - s0);
  // A channel past W reads the last one's inputs and stores nothing.
  const int64_t base = row * S * W + (live ? w : W - 1);
  const T* ap = a + base;
  const T* hp = h + base;
  const T* gp = gh + base;
  float g = live ? g_last[row * W + w] : 0.f;
  const float first = live ? load_state(h0, h0_dtype, row * W + w) : 0.f;

  float cv[kHold], gv[kHold];
  bool held = false;  // the chunk's coefficients and gh are already in cv and gv
  if (C > 1) {  // the same for every thread of the grid
    cg::cluster_group cluster = cg::this_cluster();
    float2* pairs = smem;
    float2* carried = smem + per_cta * stripe;
    // 1. The chunk's pair, from zero, from its last step down.
    float A = 1.f, l = 0.f;
    if (steps <= kHold) {
#pragma unroll
      for (int i = 0; i < kHold / kTile; ++i) {
        const int n = steps - i * kTile;
        load_rev_tile(ap, gp, hi - i * kTile, n < 0 ? 0 : n, S, W, cv + i * kTile,
                      gv + i * kTile);
      }
#pragma unroll
      for (int k = 0; k < kHold; ++k) {
        if (k == steps) break;
        A = __fmul_rn(A, cv[k]);
        l = step(cv[k], l, gv[k]);
      }
      held = true;
    } else {
      for (int s = 0; s < steps; s += kTile) {
        const int n = tile_len(s, steps);
        load_rev_tile(ap, gp, hi - s, n, S, W, cv, gv);
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
          if (k == n) break;
          A = __fmul_rn(A, cv[k]);
          l = step(cv[k], l, gv[k]);
        }
      }
    }
    pairs[slot * stripe + lane] = make_float2(A, l);
    cluster.sync();
    // 2. The pairs of every reversed chunk before this CTA's last; chunk j lives in
    //    the shared memory of the cluster's CTA j / per_cta (rank = blockIdx.y).
    const int need = min(C, int(blockIdx.y + 1) * per_cta) - 1;
    for (int i = threadIdx.x; i < need * stripe; i += blockDim.x) {
      const int j = i / stripe;
      const float2* src = cluster.map_shared_rank(pairs, j / per_cta);
      carried[i] = src[(j % per_cta) * stripe + i % stripe];
    }
    cluster.sync();
    // 3. The carry, in reversed chunk order from g_last.
    if (c < C)
      for (int j = 0; j < c; ++j) {
        const float2 p = carried[j * stripe + lane];
        g = step(p.x, g, p.y);
      }
  }

  // 4. The rescan from the carried g, writing db and da.
  float* dap = da + row * S * W + w + hi * W;
  float* dbp = db + row * S * W + w + hi * W;
  float pv[kTile];
  if (held) {
#pragma unroll
    for (int i = 0; i < kHold / kTile; ++i) {
      const int n = steps - i * kTile;
      if (n <= 0) break;
      const int m = n < kTile ? n : kTile;
      load_prev_tile(hp, hi - i * kTile, m, W, first, pv);
      g = rescan_tile(cv + i * kTile, gv + i * kTile, pv, m, g, live, W, dap, dbp);
    }
  } else {
    for (int s = 0; s < steps; s += kTile) {
      const int n = tile_len(s, steps);
      load_rev_tile(ap, gp, hi - s, n, S, W, cv, gv);
      load_prev_tile(hp, hi - s, n, W, first, pv);
      g = rescan_tile(cv, gv, pv, n, g, live, W, dap, dbp);
    }
  }
  // The last reversed chunk ends at t = 0: g is g_0.
  if (live && c == C - 1 && h0_dtype >= 0) {
    const float d = __fmul_rn(to_float(a[row * S * W + w]), g);
    if (h0_dtype == 0)
      static_cast<float*>(dh0)[row * W + w] = d;
    else
      static_cast<__nv_bfloat16*>(dh0)[row * W + w] = __float2bfloat16_rn(d);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, of a, h and gh alike; h0_dtype -1 means
// h0 is absent, and then dh0 is too.  The plan is kernel.chunk_plan(S, W), as the
// forward's; a plan that does not cover [0, S) chunk by chunk and W stripe by
// stripe, or does not fit a cluster, is refused, and so is S = 0 (nothing to
// launch: the wrapper returns zeros).
extern "C" int rglru_bwd_launch(const void* a, const void* h, const void* gh,
                                const void* g_last, const void* h0, void* da, void* db,
                                void* dh0, int64_t B, int64_t S, int64_t W, int dtype,
                                int h0_dtype, int64_t L, int C, int per_cta, int ctas,
                                int stripe, int64_t stripes, cudaStream_t stream) {
  if (S < 1 || !plan_ok(B, S, W, L, C, per_cta, ctas, stripe, stripes, h0, h0_dtype) ||
      (dh0 != nullptr) != (h0 != nullptr))
    return int(cudaErrorInvalidValue);
#define RGLRU_BWD_LAUNCH(T)                                                              \
  launch_plan(rglru_bwd_kernel<T>, B, C, per_cta, ctas, stripe, stripes, stream,          \
              static_cast<const T*>(a), static_cast<const T*>(h),                         \
              static_cast<const T*>(gh), static_cast<const float*>(g_last), h0, h0_dtype, \
              static_cast<float*>(da), static_cast<float*>(db), dh0, S, W, L, C, stripe)
  if (dtype == 0) return RGLRU_BWD_LAUNCH(float);
  if (dtype == 1) return RGLRU_BWD_LAUNCH(__nv_bfloat16);
#undef RGLRU_BWD_LAUNCH
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rglru_bwd_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
