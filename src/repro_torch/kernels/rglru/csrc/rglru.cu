// RG-LRU linear recurrence on Hopper (sm_90a): a chunked parallel scan over S.
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
// bytes at 3.35 TB/s.  A prefill launch of recurrentgemma-2b in f32 at S = 3460,
// W = 2560 moves 106 MB, 32 us.
//
// Design.  The TPU kernel walks time serially over a channel stripe; here one thread
// walking all of S puts a memory latency on every few steps, and a batch-1 prefill
// of W = 2560 has only 20 blocks of 128 channels for 132 SMs.  So S is cut into C
// chunks of L steps (`chunk_plan` in kernel.py, from S and W only, never from B).
// A warp owns one (stripe of 32 channels, chunk): lane = channel, so each step's
// loads and stores are 32 neighbouring elements.  A stripe's chunks are the warps
// of a thread block cluster: `per_cta` chunks a CTA, `ctas` CTAs a cluster along
// grid.y (at most 8 x 8 = 64 chunks).  One launch:
//
//   1. Each warp scans its chunk from zero: A = prod a_t, l = the scan from h = 0.
//   2. The pairs (A, l) go to shared memory; after cluster.sync() each CTA copies
//      the pairs of the chunks before its last one from the cluster's CTAs through
//      distributed shared memory, and a second cluster.sync() keeps every CTA's
//      shared memory alive until all such reads are done.  The cluster's CTAs are
//      scheduled together, so no flag in device memory and no second launch.
//   3. Each warp carries the state into its chunk in chunk order,
//      h_in(c) = A(c-1) * h_in(c-1) + l(c-1) from h_in(0) = h0, and
//   4. rescans its chunk from h_in with the plain step, writing every h; the last
//      chunk writes h_last.
//
// Loads go in tiles of kTile = 16 steps, all issued before the tile's dependent
// steps, so a tile waits on one memory latency.  L = max(16, ceil(S / 64)): every
// prompt up to 1,024 tokens has chunks of one tile, which stay in registers from
// step 1 to step 4, so a, b and h each cross device memory once (12 bytes an f32
// element, the bound's count).  A longer chunk reads a and b again in step 4, 20
// bytes an element at most; the first read was moments before, so part of the
// second comes from the 50 MB L2 (how much is not measured).  Staging the chunk in
// shared memory for step 4 instead was no faster on the H100: the staged chunks
// leave an SM fewer resident CTAs than the registers do.  At S = 3460, W = 2560:
// L = 55, C = 63, 80 x 8
// CTAs of 8 warps, 5,040 warps; at S = 79: L = 16, C = 5, 400 CTAs of one warp.
//
// A decode tick (S = 1) is one chunk: the sequential scan, launched plainly (no
// cluster, no shared memory) over CTAs of 128 channels.  Its cost is the launch:
// `chip_smoke.py` times as many launches at [1, 1, 1] (`launch_floor_ms`) beside
// the tick class.
//
// Rounding: every product and sum is rounded on its own (__fmul_rn, __fadd_rn; no
// fma), in the order steps 1 to 4 give.  Within a chunk the rescan is the plain
// version's own sequence of roundings; only the carried h_in differs from the
// sequential h, by the rounding of the (A, l) pairs.  So the kernel equals
// `ref.rglru_scan_chunked` at the plan's L bit for bit, and equals the sequential
// `rglru_scan_reference` bit for bit where S <= L (one chunk: every decode tick).
// Against the sequential scan the carry's error decays like any other rounding of h:
// within the reference test's 1e-5 in f32, which tests/test_torch_rglru.py checks
// for `rglru_scan_chunked` against the JAX reference at S = 3000, with the model's
// gates and with a up to 0.9999.
//
// The entry point launches on the caller's stream, allocates nothing and returns
// the launch's error, or cudaGetLastError().

#include <cooperative_groups.h>

#include "rglru_common.cuh"

namespace cg = cooperative_groups;

namespace {

// The n <= kTile steps from t of one channel into registers, all loads issued
// before any is used.
template <typename TA, typename TB>
__device__ __forceinline__ void load_tile(const TA* ap, const TB* bp, int64_t t, int n,
                                          int64_t W, float* av, float* bv) {
  ap += t * W;
  bp += t * W;
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    if (k == n) break;
    av[k] = to_float(*ap);
    bv[k] = to_float(*bp);
    ap += W;
    bp += W;
  }
}

// A CTA owns `stripe` channels (one a thread) of blockDim.x / stripe chunks.
// Shared memory (C > 1 only): this CTA's chunks' pairs, [chunks a CTA][stripe],
// then the stripe's earlier chunks' pairs, [C - 1][stripe].
// h0_dtype: -1 = absent (zeros), 0 = float32, 1 = bfloat16.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kMaxThreads)
rglru_kernel(const TA* __restrict__ a, const TB* __restrict__ b, const void* __restrict__ h0,
             int h0_dtype, TA* __restrict__ h, float* __restrict__ h_last, int64_t S,
             int64_t W, int64_t L, int C, int stripe) {
  extern __shared__ float2 smem[];
  const int lane = threadIdx.x % stripe, slot = threadIdx.x / stripe;
  const int per_cta = blockDim.x / stripe;
  const int64_t w = int64_t(blockIdx.x) * stripe + lane;
  const bool live = w < W;
  const int64_t row = blockIdx.z;
  const int c = blockIdx.y * per_cta + slot;  // this thread's chunk; c >= C is idle
  const int64_t t0 = c * L < S ? c * L : S, t1 = t0 + L < S ? t0 + L : S;
  // A channel past W reads the last one's inputs and stores nothing.
  const TA* ap = a + row * S * W + (live ? w : W - 1);
  const TB* bp = b + row * S * W + (live ? w : W - 1);

  float hv = live ? load_state(h0, h0_dtype, row * W + w) : 0.f;

  float av[kTile], bv[kTile];
  bool held = false;  // the chunk is one tile, already in av and bv
  if (C > 1) {  // the same for every thread of the grid
    cg::cluster_group cluster = cg::this_cluster();
    float2* pairs = smem;
    float2* carried = smem + per_cta * stripe;
    // 1. The chunk's pair, from zero.
    float A = 1.f, l = 0.f;
    for (int64_t t = t0; t < t1; t += kTile) {
      const int n = tile_len(t, t1);
      load_tile(ap, bp, t, n, W, av, bv);
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        if (k == n) break;
        A = __fmul_rn(A, av[k]);
        l = step(av[k], l, bv[k]);
      }
    }
    held = t1 - t0 <= kTile;
    pairs[slot * stripe + lane] = make_float2(A, l);
    cluster.sync();
    // 2. The pairs of every chunk before this CTA's last; chunk j lives in the
    //    shared memory of the cluster's CTA j / per_cta (rank = blockIdx.y).
    const int need = min(C, int(blockIdx.y + 1) * per_cta) - 1;
    for (int i = threadIdx.x; i < need * stripe; i += blockDim.x) {
      const int j = i / stripe;
      const float2* src = cluster.map_shared_rank(pairs, j / per_cta);
      carried[i] = src[(j % per_cta) * stripe + i % stripe];
    }
    cluster.sync();
    // 3. The carry, in chunk order.
    if (c < C)
      for (int j = 0; j < c; ++j) {
        const float2 p = carried[j * stripe + lane];
        hv = step(p.x, hv, p.y);
      }
  }

  // 4. The rescan from the carried state.
  TA* hp = h + row * S * W + w + t0 * W;
  for (int64_t t = t0; t < t1; t += kTile) {
    const int n = tile_len(t, t1);
    if (!held) load_tile(ap, bp, t, n, W, av, bv);
    held = false;
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      if (k == n) break;
      hv = step(av[k], hv, bv[k]);
      if (live) *hp = from_float<TA>(hv);
      hp += W;
    }
  }
  if (live && c == C - 1) h_last[row * W + w] = hv;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; h0_dtype -1 means h0 is absent.  The plan
// (chunk length L, chunks C, chunks a CTA, CTAs a cluster, channels a CTA, CTAs
// across W) comes from kernel.chunk_plan; a plan that does not cover [0, S) chunk
// by chunk and W stripe by stripe, or does not fit a cluster, is refused.
extern "C" int rglru_launch(const void* a, const void* b, const void* h0, void* h,
                            void* h_last, int64_t B, int64_t S, int64_t W, int a_dtype,
                            int b_dtype, int h0_dtype, int64_t L, int C, int per_cta,
                            int ctas, int stripe, int64_t stripes, cudaStream_t stream) {
  if (!plan_ok(B, S, W, L, C, per_cta, ctas, stripe, stripes, h0, h0_dtype))
    return int(cudaErrorInvalidValue);
  auto* hl = static_cast<float*>(h_last);
#define RGLRU_LAUNCH(TA, TB)                                                              \
  launch_plan(rglru_kernel<TA, TB>, B, C, per_cta, ctas, stripe, stripes, stream,          \
              static_cast<const TA*>(a), static_cast<const TB*>(b), h0, h0_dtype,          \
              static_cast<TA*>(h), hl, S, W, L, C, stripe)
  if (a_dtype == 0 && b_dtype == 0) return RGLRU_LAUNCH(float, float);
  if (a_dtype == 0 && b_dtype == 1) return RGLRU_LAUNCH(float, __nv_bfloat16);
  if (a_dtype == 1 && b_dtype == 0) return RGLRU_LAUNCH(__nv_bfloat16, float);
  if (a_dtype == 1 && b_dtype == 1) return RGLRU_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef RGLRU_LAUNCH
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rglru_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
