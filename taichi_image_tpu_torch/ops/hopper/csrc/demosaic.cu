// K2<T>: demosaic stencil with in-kernel finish and metering samples,
// (N, 4, hh, wh) phase planes of T (bf16, f16 or f32) -> (N, 12, hh, wh)
// phase-RGB of T plus the stride-`step` sample of channels 0..2,
// (N, 3, hs, ws) of T.
//
// Replaces taichi_image_tpu/ops/pallas/demosaic.py::_stencil_kernel with
// `finish` and `sample_step` (via demosaic_stencil, pallas_call at
// demosaic.py:377): its bf16 and f32 finishes, and its q16_io branch of
// the Camera16 route, whose 16-bit fixed-point codes stand in for the f16
// that Mosaic cannot load or store. The TPU kernel DMAs halo tiles and
// emits the sample through one-hot MXU dots; here one thread computes all
// 12 channels of one half-res pixel straight from device memory (the
// 3x3 x 4-phase neighbourhood of neighbouring threads overlaps and is
// served by L1).
//
// Bound: memory on paper (4 * sizeof(T) bytes of phases read and
// 12 * sizeof(T) bytes of x12 written per half-res pixel; f32 moves twice
// the bytes of bf16 and f16 with the same arithmetic and registers).
// Every output phase reads the same 13
// diamond positions whatever the Bayer pattern or method, so those
// positions are fixed at compile time (kTaps) and only their weights come
// from the parameter block: 13 multiply-adds per channel and no run-time
// test of the weights, which had made a first version instruction-bound.
//
// Arithmetic order matches _stencil_kernel exactly, so the result is
// bitwise equal to the plain twin without a CCM:
//   1. taps in (q, u, v) order, then * inv_full[oc] (a zero weight adds
//      t * 0 == +0, which leaves the sum's value unchanged);
//   2. the border factor rvf * cvv, then the four corner multiplies;
//   3. the CCM as v0*c0 + v1*c1 + v2*c2 (no FMA: built with --fmad=false);
//   4. clip to [0, 1], then round once to T (the sample is that T value).
// Channel index = out_phase * 3 + rgb, output phases in
// ops/bayer._PHASE_PARITY order ((0,0), (1,0), (0,1), (1,1) in (row, col));
// input phases are in row-major parity order (q = (row%2)*2 + col%2).
#include <cstddef>
#include <cstring>

#include "common.cuh"

namespace {

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

// One f32 block passed by value (it lands in the kernel's constant
// parameter bank; every thread reads the same weight at once).
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

template <typename T>
__global__ void stencil_kernel(const T* __restrict__ x, T* __restrict__ out,
                               T* __restrict__ samp, int n,
                               int hh, int wh, int step, int hs, int ws,
                               const StencilParams p) {
  const long long plane = static_cast<long long>(hh) * wh;
  const long long total = static_cast<long long>(n) * plane;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(idx % wh);
    const int i = static_cast<int>((idx / wh) % hh);
    const long long b = idx / plane;

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
              in ? tit::load_f32(x[(b * 4 + q) * plane +
                                   static_cast<long long>(y) * wh + xc])
                 : 0.0f;
        }
      }
    }

    const bool on_top = i == 0, on_bot = i == hh - 1;
    const bool on_left = j == 0, on_right = j == wh - 1;
    const bool corner[4] = {on_top && on_left, on_top && on_right,
                            on_bot && on_left, on_bot && on_right};
    const bool sampled = step > 0 && i % step == 0 && j % step == 0;

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
        const int oc = ph * 3 + c;
        const T o = tit::store_rn<T>(fminf(fmaxf(vals[c], 0.0f), 1.0f));
        out[(b * 12 + oc) * plane + static_cast<long long>(i) * wh + j] = o;
        if (ph == 0 && sampled) {
          samp[((b * 3 + c) * hs + i / step) * static_cast<long long>(ws) +
               j / step] = o;
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* out, void* samp, int n, int hh, int wh,
           int step, const float* params, int has_ccm, cudaStream_t stream) {
  StencilParams p;
  std::memcpy(&p, params, kParamFloats * sizeof(float));
  p.has_ccm = has_ccm;
  const long long total = static_cast<long long>(n) * hh * wh;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int hs = step > 0 ? (hh + step - 1) / step : 0;
  const int ws = step > 0 ? (wh + step - 1) / step : 0;
  stencil_kernel<T><<<tit::grid_for(total), tit::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(samp),
      n, hh, wh, step, hs, ws, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TIT_STENCIL_LAUNCHER(suffix, T)                                      \
  extern "C" int tit_demosaic_stencil_##suffix(                              \
      const void* x, void* out, void* samp, int n, int hh, int wh, int step, \
      const float* params, int has_ccm, cudaStream_t stream) {               \
    return launch<T>(x, out, samp, n, hh, wh, step, params, has_ccm,         \
                     stream);                                                \
  }
TIT_FOR_EACH_DTYPE(TIT_STENCIL_LAUNCHER)
