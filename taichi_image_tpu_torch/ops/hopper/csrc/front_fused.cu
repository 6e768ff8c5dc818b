// K7<bf16>: front-fused demosaic + Reinhard map, (N, 4, hh, wh) bf16
// phase planes -> pre-gamma p (N, 12, hh, wh) bf16 + the per-image max of
// the f32 p, (N,) f32.
//
// Replaces taichi_image_tpu/ops/pallas/demosaic.py::_stencil_kernel with
// `tonemap` (via demosaic_reinhard_stencil, pallas_call at
// demosaic.py:466). One thread takes one half-res pixel: its 36 taps
// straight from device memory (stencil_taps) and K2's arithmetic on them
// (stencil_finish, of the same tap-mask variant as K2: stencil.cuh), each
// finished channel rounded to bf16 in registers (the x12 the composed
// route would have stored), then the K3 map (tonemap.cuh) on each output
// phase's three channels; the per-image max
// is K3's block reduction, ordered-uint atomicMax and last-block decode
// (tonemap.cuh block_max_finish). Both pieces are the composed kernels'
// own device code, so p and the max are bitwise equal to K2<bf16> ->
// K3<bf16>. The TPU kernel writes per-tile max partials that XLA
// reduces; here the kernel finishes the reduction itself.
//
// Bound: memory on paper, 8 bytes of phases read and 24 bytes of p
// written per half-res pixel, against K2 + K3's 8 + 24 + 24 + 24: the
// x12 round trip through device memory is what the fusion saves. Only the
// color_adapt == 0 map is fused (the JAX route's gate). The metering
// that sets the map's scalars must run before this kernel, from
// ops/bayer.demosaic_samples.
#include "stencil.cuh"
#include "tonemap.cuh"

namespace {

using T = __nv_bfloat16;

template <int kVariant>
__global__ void front_fused_kernel(const T* __restrict__ x,
                                   T* __restrict__ p,
                                   unsigned* __restrict__ scratch,
                                   float* __restrict__ mx, int hh, int wh,
                                   const __grid_constant__ tit::StencilParams sp,
                                   const float* __restrict__ scal) {
  const int b = blockIdx.y, n = gridDim.y;
  const int plane = hh * wh;
  const T* xb = x + static_cast<size_t>(b) * 4 * plane;
  T* pb = p + static_cast<size_t>(b) * 12 * plane;
  const tit::MapScalars s = tit::load_map_scalars<false>(scal);
  float lmax = -INFINITY;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < plane;
       idx += gridDim.x * blockDim.x) {
    const int i = idx / wh;
    const int j = idx - i * wh;
    float t[36], v[12];
    tit::stencil_taps(xb, i, j, hh, wh, t);
    tit::stencil_finish<kVariant, true>(
        t, tit::Edges{i == 0, i == hh - 1, j == 0, j == wh - 1}, sp, v);
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) {
      float q[3], pv[3];
      // quantize-then-map: the composed route stores x12 in bf16 first
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q[c] = tit::load_f32(tit::store_rn<T>(v[ph * 3 + c]));
      }
      tit::reinhard_pixel<false>(q, s, pv);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lmax = fmaxf(lmax, pv[c]);
        pb[(ph * 3 + c) * plane + idx] = tit::store_rn<T>(pv[c]);
      }
    }
  }
  tit::block_max_finish(lmax, scratch + b, scratch + n + b, mx + b,
                        gridDim.x);
}

}  // namespace

extern "C" int tit_front_fused_bf16(const void* x, void* p, void* scratch,
                                    void* mx, int n, int hh, int wh,
                                    const float* params, int has_ccm,
                                    int variant, const void* scal,
                                    cudaStream_t stream) {
  if (static_cast<long long>(n) * hh * wh == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!tit::image_fits_int32(hh, wh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const tit::StencilParams sp = tit::stencil_params_from(params, has_ccm);
  cudaError_t err = tit::clear_max(scratch, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // up to 1024 blocks per image
  const dim3 grid(tit::grid_for(static_cast<long long>(hh) * wh, 1024), n);
  return tit::with_variant(variant, [&](auto v) {
    front_fused_kernel<decltype(v)::value><<<grid, tit::kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(p),
        static_cast<unsigned*>(scratch), static_cast<float*>(mx), hh, wh, sp,
        static_cast<const float*>(scal));
    return static_cast<int>(cudaGetLastError());
  });
}
