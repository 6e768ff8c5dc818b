// K3<T>: Reinhard map + per-image max, (N, C, hh, wh) of T (bf16, f16 or
// f32; C % 3 == 0) -> p of T and the same shape + the per-image max of
// the f32 p, (N,) f32.
//
// Replaces the TPU's Reinhard map kernels, ops/pallas/reinhard.py:
//   bf16: _bf16_kernel_dma (reinhard_map_bf16_dma, pallas_call at :274);
//   f32:  _kernel (reinhard_map_pallas, :124);
//   f16:  _q16_kernel_dma (reinhard_map_q16_dma, :625), the Camera16
//         route, and _packed_kernel(_dma) (reinhard_map_packed(_dma),
//         :482 and :441). Those read and write 16-bit fixed-point codes or
//         f16 bits packed two per i32 because Mosaic has no f16 I/O; here
//         the f16 is loaded and stored natively.
// The TPU kernels double-buffer tiles through VMEM and write per-tile max
// partials that XLA reduces afterwards; here one thread maps one
// (n, group k, i, j) pixel (3 channels) and the per-image max is a block
// reduction followed by one atomicMax per block.
//
// Bound: memory on paper (3 * sizeof(T) bytes read and written per
// pixel), with one exp2f + log2f per pixel (three with color_adapt > 0)
// close behind. The p store rounds once to nearest even; an f16 p below
// 6.1e-5 is a subnormal and is kept (no -ftz, no fast math).
//
// The pixel map, the block max and the ordered max encoding are in
// tonemap.cuh, shared with the front-fused K7.
#include "tonemap.cuh"

namespace {

template <typename T, bool CA>
__global__ void map_kernel(const T* __restrict__ x, T* __restrict__ p,
                           unsigned* __restrict__ mx_enc, int ng, int hh,
                           int wh, const float* __restrict__ scal) {
  const long long b = blockIdx.y;
  const long long plane = static_cast<long long>(hh) * wh;
  const long long per_image = ng * plane;
  const tit::MapScalars s = tit::load_map_scalars<CA>(scal);
  float lmax = -INFINITY;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < per_image; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long k = idx / plane;
    const long long base = (b * ng + k) * 3 * plane + (idx - k * plane);
    float xv[3], pv[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) xv[c] = tit::load_f32(x[base + c * plane]);
    tit::reinhard_pixel<CA>(xv, s, pv);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lmax = fmaxf(lmax, pv[c]);
      p[base + c * plane] = tit::store_rn<T>(pv[c]);
    }
  }
  tit::block_max_into(lmax, mx_enc + b);
}

template <typename T>
int launch(const void* x, void* p, void* mx_enc, void* mx, int n, int ng,
           int hh, int wh, const void* scal, int ca_mode,
           cudaStream_t stream) {
  if (static_cast<long long>(n) * ng * hh * wh == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = tit::clear_max(mx_enc, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // up to 1024 blocks per image: few atomics, many pixels per thread
  const dim3 grid(tit::grid_for(static_cast<long long>(ng) * hh * wh, 1024), n);
  const auto* xin = static_cast<const T*>(x);
  auto* pout = static_cast<T*>(p);
  auto* enc = static_cast<unsigned*>(mx_enc);
  const auto* s = static_cast<const float*>(scal);
  if (ca_mode) {
    map_kernel<T, true><<<grid, tit::kThreads, 0, stream>>>(xin, pout, enc,
                                                            ng, hh, wh, s);
  } else {
    map_kernel<T, false><<<grid, tit::kThreads, 0, stream>>>(xin, pout, enc,
                                                             ng, hh, wh, s);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tit::decode_max(enc, mx, n, stream));
}

}  // namespace

#define TIT_MAP_LAUNCHER(suffix, T)                                          \
  extern "C" int tit_reinhard_map_##suffix(                                  \
      const void* x, void* p, void* mx_enc, void* mx, int n, int ng, int hh, \
      int wh, const void* scal, int ca_mode, cudaStream_t stream) {          \
    return launch<T>(x, p, mx_enc, mx, n, ng, hh, wh, scal, ca_mode,         \
                     stream);                                                \
  }
TIT_FOR_EACH_DTYPE(TIT_MAP_LAUNCHER)
