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
// positions are fixed at compile time (tap_index) and only their weights
// come from the parameter block: 13 multiply-adds per channel and no
// run-time test of the weights, which had made a first version
// instruction-bound.
//
// The stencil itself (stencil.cuh, shared with the front-fused K7) gives
// the clipped f32 channels; each is rounded once to T, and the sample is
// that T value.
#include "stencil.cuh"

namespace {

template <typename T>
__global__ void stencil_kernel(const T* __restrict__ x, T* __restrict__ out,
                               T* __restrict__ samp, int n,
                               int hh, int wh, int step, int hs, int ws,
                               const __grid_constant__ tit::StencilParams p) {
  const long long plane = static_cast<long long>(hh) * wh;
  const long long total = static_cast<long long>(n) * plane;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(idx % wh);
    const int i = static_cast<int>((idx / wh) % hh);
    const long long b = idx / plane;
    float v[12];
    tit::stencil_pixel(x, b, i, j, hh, wh, p, v);
    const bool sampled = step > 0 && i % step == 0 && j % step == 0;
#pragma unroll
    for (int oc = 0; oc < 12; ++oc) {
      const T o = tit::store_rn<T>(v[oc]);
      out[(b * 12 + oc) * plane + static_cast<long long>(i) * wh + j] = o;
      if (oc < 3 && sampled) {
        samp[((b * 3 + oc) * hs + i / step) * static_cast<long long>(ws) +
             j / step] = o;
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* out, void* samp, int n, int hh, int wh,
           int step, const float* params, int has_ccm, cudaStream_t stream) {
  const tit::StencilParams p = tit::stencil_params_from(params, has_ccm);
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
