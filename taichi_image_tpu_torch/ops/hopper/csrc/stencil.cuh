// The demosaic stencil of one half-res pixel, shared by K2 (demosaic.cu)
// and the front-fused K7 (front_fused.cu) so that both run the same
// instructions in the same order.
//
// Arithmetic order matches taichi_image_tpu/ops/pallas/demosaic.py
// _stencil_kernel exactly, so the result is bitwise equal to the plain
// twin (ops/hopper/demosaic.demosaic_stencil_plain) without a CCM:
//   1. taps in (q, u, v) order, then * inv_full[oc] (a zero weight adds
//      t * 0 == +0, which leaves the sum's value unchanged);
//   2. the border factor rvf * cvv, then the four corner multiplies;
//   3. the CCM as v0*c0 + v1*c1 + v2*c2 (no FMA: built with --fmad=false);
//   4. clip to [0, 1].
// Channel index = out_phase * 3 + rgb, output phases in
// ops/bayer._PHASE_PARITY order ((0,0), (1,0), (0,1), (1,1) in (row, col));
// input phases are in row-major parity order (q = (row%2)*2 + col%2).
#pragma once

#include <cstddef>
#include <cstring>

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

// The 12 finished channels of half-res pixel (b, i, j), clipped to [0, 1]
// and not yet rounded to the working dtype.
template <typename T>
__device__ __forceinline__ void stencil_pixel(const T* __restrict__ x,
                                              long long b, int i, int j,
                                              int hh, int wh,
                                              const StencilParams& p,
                                              float out[12]) {
  const long long plane = static_cast<long long>(hh) * wh;
  // the 4 x 3 x 3 neighbourhood, zero outside the image (the zero
  // padding whose dropped taps the border factors renormalize)
  float t[36];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const int y = i + u - 1, xc = j + v - 1;
        const bool in = y >= 0 && y < hh && xc >= 0 && xc < wh;
        t[q * 9 + u * 3 + v] =
            in ? load_f32(x[(b * 4 + q) * plane +
                            static_cast<long long>(y) * wh + xc])
               : 0.0f;
      }
    }
  }

  const bool on_top = i == 0, on_bot = i == hh - 1;
  const bool on_left = j == 0, on_right = j == wh - 1;
  const bool corner[4] = {on_top && on_left, on_top && on_right,
                          on_bot && on_left, on_bot && on_right};

#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    float vals[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int oc = ph * 3 + c;
      float a = -0.0f;  // -0 + s == s for every s: same as starting at tap 0
#pragma unroll
      for (int k = 0; k < 13; ++k) a = a + t[tap_index(ph, k)] * p.w[oc][k];
      const float val = a * p.inv_full[oc];
      const float rvf = (on_top ? p.topf[oc] : 1.0f) * (on_bot ? p.botf[oc] : 1.0f);
      const float cvv = (on_left ? p.leftf[oc] : 1.0f) * (on_right ? p.rightf[oc] : 1.0f);
      float f = rvf * cvv;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (corner[k]) f = f * p.cvals[k][oc];
      }
      vals[c] = val * f;
    }
    if (p.has_ccm) {
      float cc[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        cc[d] = vals[0] * p.ccm[d * 3 + 0] + vals[1] * p.ccm[d * 3 + 1] +
                vals[2] * p.ccm[d * 3 + 2];
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) vals[d] = cc[d];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[ph * 3 + c] = fminf(fmaxf(vals[c], 0.0f), 1.0f);
    }
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
