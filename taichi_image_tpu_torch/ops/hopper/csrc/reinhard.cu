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
// The scalars (reinhard_scal / reinhard_scal_ca, computed in torch on
// the device) arrive as a device pointer, so the launch needs no host
// sync: [m0, range, map_key, mean, exp(-intensity), light_adapt] and,
// with ca_mode, [color_adapt, cmean_r, cmean_g, cmean_b].
//
// p can be negative (a channel below m0), so the max uses an ordered
// unsigned encoding of the float (negative floats bit-inverted, positive
// ones with the sign bit set); 0 is below every encoded float and is the
// initial value. NaN p is zeroed before the max and the store.
#include <cmath>

#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned encode_ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float decode_ordered(unsigned e) {
  return __uint_as_float((e & 0x80000000u) ? (e & 0x7FFFFFFFu) : ~e);
}

__device__ __forceinline__ float pow_exp2(float base, float k) {
  // exp2(k * log2(b)): the TPU kernel's pow lowering (reinhard.py:218-222)
  return exp2f(k * log2f(base));
}

template <typename T, bool CA>
__global__ void map_kernel(const T* __restrict__ x, T* __restrict__ p,
                           unsigned* __restrict__ mx_enc, int ng, int hh,
                           int wh, const float* __restrict__ scal) {
  const long long b = blockIdx.y;
  const long long plane = static_cast<long long>(hh) * wh;
  const long long per_image = ng * plane;
  const float m0 = scal[0], rng = scal[1], mk = scal[2], mean = scal[3];
  const float eni = scal[4], la = scal[5];
  float lmax = -INFINITY;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < per_image; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long k = idx / plane;
    const long long s = idx - k * plane;
    const long long base = (b * ng + k) * 3 * plane + s;
    float sc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sc[c] = (tit::load_f32(x[base + c * plane]) - m0) / rng;
    }
    const float gray = 0.299f * sc[0] + 0.587f * sc[1] + 0.114f * sc[2];
    float adapt = 0.0f;
    if (!CA) adapt = pow_exp2(eni * (mean + la * (gray - mean)), mk);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (CA) {
        const float ca = scal[6], cmean = scal[7 + c];
        const float adapt_color = gray + ca * (sc[c] - gray);
        adapt = pow_exp2(eni * (cmean + la * (adapt_color - cmean)), mk);
      }
      float pv = sc[c] * (1.0f / (adapt + sc[c]));
      if (pv != pv) pv = 0.0f;  // NaN (no fast math: the compare is kept)
      lmax = fmaxf(lmax, pv);
      p[base + c * plane] = tit::store_rn<T>(pv);
    }
  }

  // block max: warp shuffles, then one warp over the per-warp maxima
  __shared__ float warp_max[tit::kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = lmax;
  __syncthreads();
  if (warp == 0) {
    lmax = lane < tit::kThreads / 32 ? warp_max[lane] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
    }
    if (lane == 0) atomicMax(mx_enc + b, encode_ordered(lmax));
  }
}

__global__ void decode_max_kernel(const unsigned* __restrict__ mx_enc,
                                  float* __restrict__ mx, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) mx[i] = decode_ordered(mx_enc[i]);
}

template <typename T>
int launch(const void* x, void* p, void* mx_enc, void* mx, int n, int ng,
           int hh, int wh, const void* scal, int ca_mode,
           cudaStream_t stream) {
  if (static_cast<long long>(n) * ng * hh * wh == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(mx_enc, 0, sizeof(unsigned) * n, stream);
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
  decode_max_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      enc, static_cast<float*>(mx), n);
  return static_cast<int>(cudaGetLastError());
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
