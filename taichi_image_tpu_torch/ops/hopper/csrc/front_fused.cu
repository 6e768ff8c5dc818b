// K7<bf16>: front-fused demosaic + Reinhard map, (N, 4, hh, wh) bf16
// phase planes -> pre-gamma p (N, 12, hh, wh) bf16 + the per-image max of
// the f32 p, (N,) f32.
//
// Replaces taichi_image_tpu/ops/pallas/demosaic.py::_stencil_kernel with
// `tonemap` (via demosaic_reinhard_stencil, pallas_call at
// demosaic.py:466). The TPU kernel writes per-tile max partials that XLA
// reduces; here the kernel finishes the reduction itself.
//
// Bound: 8 bytes of phases read and 24 bytes of p written per half-res
// pixel (0.119 ms for 6 x 4K at 3.35 TB/s), against K2 + K3's 8 + 24 +
// 24 + 24: the x12 round trip through device memory is what the fusion
// saves. But K7 runs K2's instructions and K3's per pixel (the stencil's
// ~250 and four maps of ~150), so on this card instruction issue, not
// bytes, bounds it, and the saved bytes buy little: the design spends no
// instruction on loading, indexing or code that a pixel can avoid:
//   - K2's tile, block and loader (stencil.cuh): a block of 32 x 8
//     threads stages a 32 x (32 kV) half-res tile with its halo by
//     16-byte cp.async copies, each thread slides a 3 x (kV + 2) window
//     per phase along a run of kV pixels, and only edge tiles evaluate the
//     border factors. K2 and K7 run the same stencil instructions in the
//     same order, so the x12 that K7 rounds to bf16 is the x12 that K2
//     would store;
//   - the map from a slot: each output phase's channels, rounded to bf16,
//     go to the thread's slot in shared memory, and one rolled loop maps
//     the slot's 4 * kV pixels with K3's map (tonemap.cuh reinhard_pixel,
//     color_adapt == 0), kU at a time, writing p back in place; each p
//     channel's run then leaves as one vector store. Inlined 4 * kV times
//     (the map in registers), the map's code made the run's loop some
//     10,000 instructions at kV = 4, which ran 45% slower than this loop
//     of one map's copies at the same occupancy, most likely because the
//     loop no longer fit the instruction cache;
//   - kV = 2 at three blocks per SM (85 registers), two maps in flight:
//     measured faster than kV = 4 at two blocks (K2's shape) and than one
//     or four maps in flight (PERF.md §6);
//   - the per-image max is K3's: a block max folded into the image's
//     word with one atomicMax, and the image's last block decodes it
//     (block_max_finish, given the block's linear thread index and the
//     image's gridDim.x * gridDim.y blocks), so the call is one memset and
//     one kernel.
// p and the max are therefore bitwise equal to K2<bf16> -> K3<bf16>.
// A frame whose rows are not whole 16-byte copies, or an unaligned
// tensor, stages and stores element by element (the launcher picks `vec`);
// the arithmetic is the same. The metering that sets the map's scalars
// must run before this kernel, from ops/bayer.demosaic_samples. The top
// and bottom factors apply at the finish spec's gated rows, as in K2
// (stencil.cuh RowGates); K7 stores every row it reads.
#include "stencil.cuh"
#include "tonemap.cuh"

namespace {

using T = __nv_bfloat16;
constexpr int kV = 2;          // pixels per run
constexpr int kMinBlocks = 3;  // blocks per SM: 85 registers a thread
constexpr int kU = 2;          // maps in flight
static_assert(tit::kTileThreads == tit::kThreads,
              "block_max_finish reduces blocks of kThreads threads");

// A thread's slot in shared memory: the 12 channels of its run, each a
// run of kV values kPitch elements (one run per thread of the block) from
// the next, so that a warp's accesses to one channel are consecutive.
struct Slots {
  static constexpr int kPitch = tit::kTileThreads * kV;
  static constexpr int kBytes = 12 * kPitch * static_cast<int>(sizeof(T));
};

// One thread's run: pixels (i, j0 .. j0 + kV) from the staged tile, its
// slot at `slot`.
template <int kVariant, bool kBorder>
__device__ __forceinline__ void fused_run(
    const T* __restrict__ s, int rr, int c0, int i, int j0, int hh, int wh,
    tit::RowGates g, bool vec, const tit::StencilParams& sp,
    const tit::MapScalars& ms, T* __restrict__ slot, T* __restrict__ pb,
    float& lmax) {
  using R = tit::Run<T, kV>;
  constexpr int kPitch = Slots::kPitch;
  {
    // K2's stencil, each output phase's channels rounded to bf16 into the
    // slot: the x12 run that K2 stores
    float win[4][3][kV + 2];
    tit::load_window<T, kV>(s, rr, c0, win);
    const bool top = i == g.top, bot = i == g.bot;
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) {
      float o[3][kV];
      tit::stencil_run_phase<kVariant, kBorder, kV>(win, ph, top, bot, j0,
                                                    wh, sp, o);
#pragma unroll
      for (int c = 0; c < 3; ++c) R::store(slot + (ph * 3 + c) * kPitch, o[c]);
    }
  }
  // K3's map on each (phase, pixel) of the slot, p back in its place: kU
  // copies of the map's code, not 4 * kV
#pragma unroll 1
  for (int m0 = 0; m0 < 4 * kV; m0 += kU) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int m = m0 + u, k = m % kV;
      T* px = slot + (m / kV) * 3 * kPitch + k;
      float q[3], pv[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = tit::load_f32(px[c * kPitch]);
      tit::reinhard_pixel<false>(q, ms, pv);
      const bool in = vec || j0 + k < wh;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (in) lmax = fmaxf(lmax, pv[c]);
        px[c * kPitch] = tit::store_rn<T>(pv[c]);
      }
    }
  }
  const int plane = hh * wh;
  const int at = i * wh + j0;
#pragma unroll
  for (int ch = 0; ch < 12; ++ch) {
    const T* from = slot + ch * kPitch;
    T* dst = pb + ch * plane + at;
    if (vec) {
      unsigned w[R::kWords];
      R::load_words(from, w);
      R::store_words(dst, w);
    } else {
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        if (j0 + k < wh) dst[k] = from[k];
      }
    }
  }
}

template <int kVariant>
__global__ void __launch_bounds__(tit::kTileThreads, kMinBlocks)
    front_fused_kernel(const T* __restrict__ x, T* __restrict__ p,
                       unsigned* __restrict__ scratch, float* __restrict__ mx,
                       int hh, int wh, tit::RowGates g, int vec,
                       const __grid_constant__ tit::StencilParams sp,
                       const float* __restrict__ scal) {
  using Tl = tit::StencilTile<T, kV>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const int x0 = blockIdx.x * Tl::kTileW;
  const int y0 = blockIdx.y * tit::kTileH;
  const int b = blockIdx.z, n = gridDim.z;
  const int plane = hh * wh;
  const T* xb = x + static_cast<size_t>(b) * 4 * plane;
  const int tid = threadIdx.y * tit::kRunsX + threadIdx.x;
  T* slot = reinterpret_cast<T*>(smem + Tl::kBytes) + tid * kV;
  tit::stage_tile<T, kV>(s, xb, x0, y0, hh, wh, vec, tid);
  const tit::MapScalars ms = tit::load_map_scalars<false>(scal);
  const bool edge = tit::tile_on_edge<T, kV>(x0, y0, g, wh);
  const int c0 = threadIdx.x * kV, j0 = x0 + c0;
  T* pb = p + static_cast<size_t>(b) * 12 * plane;
  float lmax = -INFINITY;
  if (j0 < wh) {
    for (int rr = threadIdx.y; rr < tit::kTileH; rr += tit::kRowsY) {
      const int i = y0 + rr;
      if (i >= hh) break;
      if (edge) {
        fused_run<kVariant, true>(s, rr, c0, i, j0, hh, wh, g, vec, sp, ms,
                                  slot, pb, lmax);
      } else {
        fused_run<kVariant, false>(s, rr, c0, i, j0, hh, wh, g, vec, sp, ms,
                                   slot, pb, lmax);
      }
    }
  }
  // every thread of the block reaches the max, the ones off the frame too
  tit::block_max_finish(lmax, scratch + b, scratch + n + b, mx + b,
                        gridDim.x * gridDim.y, tid);
}

}  // namespace

extern "C" int tit_front_fused_bf16(const void* x, void* p, void* scratch,
                                    void* mx, int n, int hh, int wh,
                                    const float* params, int has_ccm,
                                    int variant, int top_row, int bot_row,
                                    const void* scal, cudaStream_t stream) {
  using Tl = tit::StencilTile<T, kV>;
  constexpr int kBytes = Tl::kBytes + Slots::kBytes;
  static_assert(Tl::kBytes % 16 == 0, "the slots start 16-byte aligned");
  if (static_cast<long long>(n) * hh * wh == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!tit::image_fits_int32(hh, wh) || n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const tit::StencilParams sp = tit::stencil_params_from(params, has_ccm);
  cudaError_t err = tit::clear_max(scratch, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = wh % Tl::kS == 0 && tit::aligned16(x) && tit::aligned16(p);
  const dim3 grid((wh + Tl::kTileW - 1) / Tl::kTileW,
                  (hh + tit::kTileH - 1) / tit::kTileH, n);
  const dim3 block(tit::kRunsX, tit::kRowsY);
  return tit::with_variant(variant, [&](auto v) {
    auto* kernel = front_fused_kernel<decltype(v)::value>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, block, kBytes, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(p),
        static_cast<unsigned*>(scratch), static_cast<float*>(mx), hh, wh,
        tit::RowGates{top_row, bot_row}, vec, sp,
        static_cast<const float*>(scal));
    return static_cast<int>(cudaGetLastError());
  });
}
