// The demosaic stencil, shared by K2 (demosaic.cu) and the front-fused K7
// (front_fused.cu) so that both run the same instructions in the same
// order, from the tile in shared memory to the finished channels. What
// bounds both on this card is the instruction stream beside the bytes
// (below): so the loader spends no instruction a pixel can avoid. The
// pieces, in the order a kernel calls them:
//   - StencilTile: a block of kRunsX x kRowsY threads takes kTileH rows
//     of kRunsX * kV half-res pixels of one image (blockIdx = column
//     tile, row tile, image; no division per pixel);
//   - stage_tile: the tile's four phase planes with a one-pixel halo,
//     staged in shared memory by 16-byte cp.async copies all in flight at
//     once, zero-filled outside the frame (the padding that the border
//     factors renormalize), or element by element for a frame whose rows
//     are not whole copies;
//   - load_window: a thread's 3 x (kV + 2) window of each phase for a
//     run of kV consecutive pixels of a row, one vector load per row;
//   - stencil_run_phase: the 3 finished channels of one output phase for
//     the kV pixels of the run (stencil_phase on each pixel's 36 taps),
//     with the border factors only where the caller asks (edge tiles).
// The rows where the top and bottom factors apply are the finish spec's
// top_row and bot_row (RowGates): 0 and hh - 1 for a whole frame; in a
// row band read with one halo row on each side (models/large.py), the
// image's first row is row 1 of the first band and its last row is row hb
// of the last band, and a band edge that is another band's row has the
// gate -1, which no row matches. Columns always end at the frame's edge,
// since a band spans the image's full width.
//
// Arithmetic order matches taichi_image_tpu/ops/pallas/demosaic.py
// _stencil_kernel and the plain twin
// (ops/hopper/demosaic.demosaic_stencil_plain), bitwise without a CCM:
//   1. the nonzero-weight taps in (q, u, v) order, from -0, then
//      * inv_full[oc];
//   2. the border factor rvf * cvv, then the four corner multiplies;
//   3. the CCM as v0*c0 + v1*c1 + v2*c2 (no FMA: built with --fmad=false);
//   4. clip to [0, 1].
// Channel index = out_phase * 3 + rgb, output phases in
// ops/bayer._PHASE_PARITY order ((0,0), (1,0), (0,1), (1,1) in (row, col));
// input phases are in row-major parity order (q = (row%2)*2 + col%2).
//
// Bound: each half-res pixel is 4 values in and 12 out (32 bytes in bf16),
// so memory bounds the stencil only while its arithmetic stays under
// about 10 f32 instructions per byte moved (the H100's ~33 T f32
// instructions/s over 3.35 TB/s): ~320 per bf16 pixel. Multiplying all 13
// diamond taps of all 12 channels costs 312 mul/add per pixel (no FMA),
// as long as the bytes on their own. The weights of a Bayer pattern and
// method leave 84 (MHC) or 28 (bilinear) of those 156 taps nonzero, so
// each (pattern, method) is a compile-time variant whose tap masks drop
// the rest: the plain twin skips zero weights too, and a sum that starts
// at -0 and adds only the nonzero taps is the twin's sum, sign of zero
// included. The weight values still come from the parameter block at run
// time. What is left, about 250 instructions per MHC pixel with the loads
// and stores, is still close to the bytes' time, which is why K2 keeps
// its loads in flight while it computes (demosaic.cu).
#pragma once

#include <cstddef>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace tit {

// kTaps[p]: the 13 positions q*9 + u*3 + v of output phase p's diamond
// in the 4 x 3 x 3 neighbourhood, ascending ((q, u, v) order).
// ops/hopper/demosaic.py builds the same table from ops/bayer and the
// CPU tests hold the two equal.
__host__ __device__ constexpr int tap_index(int p, int i) {
  constexpr int kTaps[4][13] = {
      {1, 3, 4, 5, 7, 12, 13, 19, 22, 27, 28, 30, 31},
      {4, 7, 12, 13, 15, 16, 19, 21, 22, 23, 25, 30, 31},
      {4, 5, 10, 12, 13, 14, 16, 19, 20, 22, 23, 28, 31},
      {4, 5, 7, 8, 13, 16, 22, 23, 28, 30, 31, 32, 34}};
  return kTaps[p][i];
}

// The tap-mask variants: bit k of kTapMasks[v][oc] is set where channel
// oc's weight at tap_index(oc / 3, k) is nonzero. Variant
// v = pattern * 2 + method, patterns RGGB, GRBG, GBRG, BGGR and methods
// mhc, bilinear (ops/hopper/demosaic.VARIANTS, which looks a weight
// table's variant up and refuses one that is not here; the CPU tests hold
// this table to ops/bayer._demosaic_tables).
constexpr int kVariants = 8;
__host__ __device__ constexpr unsigned tap_mask(int variant, int oc) {
  constexpr unsigned kTapMasks[kVariants][12] = {
      {0x4, 0x1ff, 0x1e1f, 0x7ff, 0x100, 0x1ffc, 0x7ff, 0x10, 0x1ffc,
       0x1f0f, 0x1ff0, 0x400},
      {0x4, 0x1e0, 0x1e00, 0x3, 0x100, 0x1800, 0x3, 0x10, 0x1800, 0xf,
       0xf0, 0x400},
      {0x1e7f, 0x4, 0x1f9f, 0x7fc, 0x1fc3, 0x100, 0x10, 0x187f, 0x7fc,
       0x1f3f, 0x400, 0x1fcf},
      {0x60, 0x4, 0x180, 0x3c, 0x1803, 0x100, 0x10, 0x1803, 0x780, 0x30,
       0x400, 0xc0},
      {0x1f9f, 0x4, 0x1e7f, 0x100, 0x1fc3, 0x7fc, 0x7fc, 0x187f, 0x10,
       0x1fcf, 0x400, 0x1f3f},
      {0x180, 0x4, 0x60, 0x100, 0x1803, 0x3c, 0x780, 0x1803, 0x10, 0xc0,
       0x400, 0x30},
      {0x1e1f, 0x1ff, 0x4, 0x1ffc, 0x100, 0x7ff, 0x1ffc, 0x10, 0x7ff,
       0x400, 0x1ff0, 0x1f0f},
      {0x1e00, 0x1e0, 0x4, 0x1800, 0x100, 0x3, 0x1800, 0x10, 0x3, 0x400,
       0xf0, 0xf}};
  return kTapMasks[variant][oc];
}

// Run f(std::integral_constant<int, v>) for the run-time variant v: the
// launchers instantiate one kernel per variant through it.
template <typename F>
int with_variant(int variant, F&& f) {
  switch (variant) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One f32 block passed by value as a __grid_constant__ kernel parameter
// (it lands in the constant parameter bank; every thread reads the same
// weight at once).
struct StencilParams {
  float w[12][13];      // weights[oc] at tap_index(oc / 3, i)
  float inv_full[12];   // f32(1 / sum of weights)
  float topf[12];
  float botf[12];
  float leftf[12];
  float rightf[12];
  float cvals[4][12];   // tl, tr, bl, br corner corrections
  float ccm[9];         // row-major 3x3, used when has_ccm
  int has_ccm;
};

constexpr int kParamFloats = 12 * 13 + 12 * 5 + 4 * 12 + 9;
static_assert(offsetof(StencilParams, has_ccm) == kParamFloats * sizeof(float),
              "StencilParams must be a packed float block");

// The frame edges a pixel lies on; only pixels on an edge take the
// border and corner factors.
struct Edges {
  bool top, bot, left, right;
};

// The rows of the frame that take the top and the bottom factors; -1
// for an edge that lies in another band.
struct RowGates {
  int top, bot;
};

// The 3 finished channels of output phase ph of one pixel from its 36
// taps, clipped to [0, 1] and not yet rounded to the working dtype.
// kBorder = false skips the border factors, which are exactly 1 away from
// the edges.
template <int kVariant, bool kBorder>
__device__ __forceinline__ void stencil_phase(int ph, const float t[36],
                                              Edges e, const StencilParams& p,
                                              float out[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int oc = ph * 3 + c;
    float a = -0.0f;  // -0 + s == s for every s: same as starting at a tap
#pragma unroll
    for (int k = 0; k < 13; ++k) {
      if (tap_mask(kVariant, oc) >> k & 1u) {
        a = a + t[tap_index(ph, k)] * p.w[oc][k];
      }
    }
    float val = a * p.inv_full[oc];
    if (kBorder) {
      const float rvf =
          (e.top ? p.topf[oc] : 1.0f) * (e.bot ? p.botf[oc] : 1.0f);
      const float cvv =
          (e.left ? p.leftf[oc] : 1.0f) * (e.right ? p.rightf[oc] : 1.0f);
      float f = rvf * cvv;
      if (e.top && e.left) f = f * p.cvals[0][oc];
      if (e.top && e.right) f = f * p.cvals[1][oc];
      if (e.bot && e.left) f = f * p.cvals[2][oc];
      if (e.bot && e.right) f = f * p.cvals[3][oc];
      val = val * f;
    }
    out[c] = val;
  }
  if (p.has_ccm) {
    float cc[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      cc[d] = out[0] * p.ccm[d * 3 + 0] + out[1] * p.ccm[d * 3 + 1] +
              out[2] * p.ccm[d * 3 + 2];
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) out[d] = cc[d];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = fminf(fmaxf(out[c], 0.0f), 1.0f);
}

// The tile of K2 and K7: kTileH x kTileW half-res pixels for a block of
// kRunsX x kRowsY threads, each thread taking runs of kV pixels of a row.
// Staged in shared memory as four phase planes of kSH rows (a halo row on
// each side) by kSW columns (a halo copy of kS elements on each side, so
// every copy is 16-byte aligned in both memories).
constexpr int kRunsX = 32;   // threads across a tile row: a warp
constexpr int kRowsY = 8;    // warps of a block
constexpr int kTileThreads = kRunsX * kRowsY;
constexpr int kTileH = 32;   // half-res rows of a tile

template <typename T, int kV>
struct StencilTile {
  static constexpr int kTileW = kRunsX * kV;   // half-res columns
  static constexpr int kS = 16 / sizeof(T);    // elements per 16-byte copy
  static constexpr int kSW = kTileW + 2 * kS;
  static constexpr int kSH = kTileH + 2;
  static constexpr int kBytes = 4 * kSH * kSW * static_cast<int>(sizeof(T));
  static_assert(kTileW % kS == 0, "a tile row is whole 16-byte copies");
};

// Stage the tile at (y0, x0) of image xb (4 phase planes of hh x wh) and
// its halo in s, zero outside the frame, then __syncthreads. vec: rows
// are whole 16-byte copies and xb is 16-byte aligned (cp.async), else
// element by element. tid is the thread's linear index in the block.
template <typename T, int kV>
__device__ __forceinline__ void stage_tile(T* __restrict__ s,
                                           const T* __restrict__ xb, int x0,
                                           int y0, int hh, int wh, bool vec,
                                           int tid) {
  using Tl = StencilTile<T, kV>;
  const int plane = hh * wh;
  if (vec) {
    constexpr int kCopies = Tl::kSW / Tl::kS;
#pragma unroll 4
    for (int k = tid; k < 4 * Tl::kSH * kCopies; k += kTileThreads) {
      const int row = k / kCopies, cv = k - row * kCopies;  // q * kSH + r
      const int q = row / Tl::kSH, r = row - q * Tl::kSH;
      const int y = y0 - 1 + r, xc = x0 - Tl::kS + cv * Tl::kS;
      const bool in = y >= 0 && y < hh && xc >= 0 && xc < wh;
      // a copy of 0 source bytes fills the 16 bytes with zeros
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(s + row * Tl::kSW + cv * Tl::kS));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst),
                   "l"(in ? xb + q * plane + y * wh + xc : xb),
                   "r"(in ? 16 : 0));
    }
    asm volatile("cp.async.wait_all;\n" ::);
  } else {
    constexpr int kCols = Tl::kTileW + 2;
    const T zero = store_rn<T>(0.0f);
    for (int k = tid; k < 4 * Tl::kSH * kCols; k += kTileThreads) {
      const int row = k / kCols, c = k - row * kCols;
      const int q = row / Tl::kSH, r = row - q * Tl::kSH;
      const int y = y0 - 1 + r, xc = x0 - 1 + c;
      const bool in = y >= 0 && y < hh && xc >= 0 && xc < wh;
      s[row * Tl::kSW + Tl::kS - 1 + c] =
          in ? xb[q * plane + y * wh + xc] : zero;
    }
  }
  __syncthreads();
}

// Whether the tile of rows y0 .. y0 + kTileH from column x0 holds a
// gated row or the frame's first or last column: only such tiles
// evaluate the border and corner factors.
template <typename T, int kV>
__device__ __forceinline__ bool tile_on_edge(int x0, int y0, RowGates g,
                                             int wh) {
  const auto in_tile = [y0](int r) { return r >= y0 && r < y0 + kTileH; };
  return in_tile(g.top) || in_tile(g.bot) || x0 == 0 ||
         x0 + StencilTile<T, kV>::kTileW >= wh;
}

// A run's window: the 3 x (kV + 2) values of each phase around pixels
// (rr, c0 .. c0 + kV) of the staged tile (rr, c0 tile-relative), as f32.
template <typename T, int kV>
__device__ __forceinline__ void load_window(const T* __restrict__ s, int rr,
                                            int c0,
                                            float win[4][3][kV + 2]) {
  using Tl = StencilTile<T, kV>;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const T* row = s + (q * Tl::kSH + rr + u) * Tl::kSW + Tl::kS + c0;
      Run<T, kV>::load(row, win[q][u] + 1);
      win[q][u][0] = load_f32(row[-1]);
      win[q][u][kV + 1] = load_f32(row[kV]);
    }
  }
}

// Output phase ph's 3 finished channels (clipped, not yet rounded) of the
// run's kV pixels (j0 .. j0 + kV of a row of a frame wh wide), from its
// window; top and bot: whether the row is a gated row (RowGates), which
// the caller finds once per row.
template <int kVariant, bool kBorder, int kV>
__device__ __forceinline__ void stencil_run_phase(
    const float win[4][3][kV + 2], int ph, bool top, bool bot, int j0,
    int wh, const StencilParams& p, float o[3][kV]) {
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    float t[36];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int u = 0; u < 3; ++u) {
#pragma unroll
        for (int v = 0; v < 3; ++v) t[q * 9 + u * 3 + v] = win[q][u][k + v];
      }
    }
    const Edges edges{top, bot, j0 + k == 0, j0 + k == wh - 1};
    float v3[3];
    stencil_phase<kVariant, kBorder>(ph, t, edges, p, v3);
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c][k] = v3[c];
  }
}

// The host side of a launcher: the f32 block from the wrapper
// (ops/hopper/demosaic.stencil_params) plus the CCM flag.
inline StencilParams stencil_params_from(const float* params, int has_ccm) {
  StencilParams p;
  std::memcpy(&p, params, kParamFloats * sizeof(float));
  p.has_ccm = has_ccm;
  return p;
}

}  // namespace tit
