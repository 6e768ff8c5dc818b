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
// partials that XLA reduces afterwards; here the kernel finishes the max.
//
// Bound: the bytes on paper, 6 * sizeof(T) per pixel (0.178 ms for
// 6 x 4K bf16 at 3.35 TB/s), but the map's instructions per pixel take
// longer than its bytes in bf16 and f16 (tonemap.cuh): bytes and
// instructions must overlap, and no instruction may go to indexing. So:
//   - The map needs no rows: it maps the same offset of the three channel
//     planes of an (image, group), each hh * wh contiguous elements. The
//     grid is (blocks, groups, images); a block's base pointer is
//     computed once in 64 bits, and a grid-stride loop walks the plane
//     with 32-bit offsets, no division. The launcher gives each
//     (image, group) its share of one wave of the card (SMs x resident
//     blocks), so an image sees a few hundred atomics, not tens of
//     thousands.
//   - Each thread maps runs of kV = 16 / sizeof(T) consecutive elements
//     (8 for bf16/f16, 4 for f32) of the three planes, loaded and stored
//     as 16-byte vectors (tit::Run), one run per pass with the next run's
//     three loads in flight while it is mapped. Occupancy is what hides
//     the loads' latency behind the long map: two runs a pass (80
//     registers, 3 blocks an SM) measured slower than one run with the
//     next prefetched (4 blocks), and a third run spilled in f32.
//   - The map's divisions are written out so that the reciprocal of the
//     uniform range is refined once per thread and one range test
//     covers a pixel's three channels, bitwise the same (tonemap.cuh);
//     a zero x - m0 stays on the fast path.
//   - The per-image max is finished by the image's last block
//     (block_max_finish): one memset and one kernel per call.
// A plane whose length is not a whole number of runs, or an unaligned
// tensor, takes the element-by-element loop of the same kernel with the
// same arithmetic (the launcher picks kVec from the sizes and pointers).
// The p store rounds once to nearest even; an f16 p below 6.1e-5 is a
// subnormal and is kept (no -ftz, no fast math).
#include "tonemap.cuh"

namespace {

template <typename T, bool CA, bool kVec>
__global__ void __launch_bounds__(tit::kThreads)
    map_kernel(const T* __restrict__ x, T* __restrict__ p,
               unsigned* __restrict__ scratch, float* __restrict__ mx,
               int plane, const float* __restrict__ scal) {
  const int b = blockIdx.z, n = gridDim.z;
  const size_t base =
      (static_cast<size_t>(b) * gridDim.y + blockIdx.y) * 3 * plane;
  const T* __restrict__ xb = x + base;
  T* __restrict__ pb = p + base;
  const tit::MapScalars s = tit::load_map_scalars<CA>(scal);
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  float lmax = -INFINITY;
  if constexpr (kVec) {
    constexpr int kV = 16 / sizeof(T);
    using R = tit::Run<T, kV>;
    const int runs = plane / kV;
    unsigned w[3][4];  // the run being mapped, as loaded
    if (first < runs) {
#pragma unroll
      for (int c = 0; c < 3; ++c) R::load_words(xb + c * plane + first * kV, w[c]);
    }
    for (int r = first; r < runs; r += stride) {
      // the next run's loads are in flight while this one is mapped
      unsigned next[3][4];
      if (r + stride < runs) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          R::load_words(xb + c * plane + (r + stride) * kV, next[c]);
        }
      }
      float f[3][kV];
#pragma unroll
      for (int c = 0; c < 3; ++c) R::unpack(w[c], f[c]);
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        const float xv[3] = {f[0][k], f[1][k], f[2][k]};
        float pv[3];
        tit::reinhard_pixel<CA>(xv, s, pv);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          lmax = fmaxf(lmax, pv[c]);
          f[c][k] = pv[c];
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) R::store(pb + c * plane + r * kV, f[c]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int m = 0; m < 4; ++m) w[c][m] = next[c][m];
      }
    }
  } else {
    for (int e = first; e < plane; e += stride) {
      float xv[3], pv[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) xv[c] = tit::load_f32(xb[c * plane + e]);
      tit::reinhard_pixel<CA>(xv, s, pv);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lmax = fmaxf(lmax, pv[c]);
        pb[c * plane + e] = tit::store_rn<T>(pv[c]);
      }
    }
  }
  tit::block_max_finish(lmax, scratch + b, scratch + n + b, mx + b,
                        gridDim.x * gridDim.y, threadIdx.x);
}

template <typename T, bool CA, bool kVec>
cudaError_t launch_map(const T* x, T* p, unsigned* scratch, float* mx, int n,
                       int ng, int plane, const float* scal,
                       cudaStream_t stream) {
  // one wave of the current device, shared out over the (image, group)
  // pairs
  static tit::PerDevice waves;
  int resident = 0;
  const cudaError_t err = tit::resident_blocks(
      map_kernel<T, CA, kVec>, tit::kThreads, 0, waves, resident);
  if (err != cudaSuccess) return err;
  const long long per_block =
      static_cast<long long>(tit::kThreads) * (kVec ? 16 / sizeof(T) : 1);
  long long blocks = (plane + per_block - 1) / per_block;
  const long long share = resident / (static_cast<long long>(n) * ng);
  if (blocks > share) blocks = share < 1 ? 1 : share;
  const dim3 grid(static_cast<unsigned>(blocks), ng, n);
  map_kernel<T, CA, kVec><<<grid, tit::kThreads, 0, stream>>>(
      x, p, scratch, mx, plane, scal);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* p, void* scratch, void* mx, int n, int ng,
           int hh, int wh, const void* scal, int ca_mode,
           cudaStream_t stream) {
  const long long plane = static_cast<long long>(hh) * wh;
  if (n * plane * ng == 0) return static_cast<int>(cudaErrorInvalidValue);
  // 32-bit offsets within an image; images and groups on the grid's
  // y and z axes
  if (3LL * ng * plane > 0x7FFFFFFFLL || n > 65535 || ng > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = tit::clear_max(scratch, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pl = static_cast<int>(plane);
  const bool vec = pl % (16 / sizeof(T)) == 0 && tit::aligned16(x) &&
                   tit::aligned16(p);
  const auto* xin = static_cast<const T*>(x);
  auto* pout = static_cast<T*>(p);
  auto* sc = static_cast<unsigned*>(scratch);
  auto* m = static_cast<float*>(mx);
  const auto* s = static_cast<const float*>(scal);
  if (ca_mode) {
    err = vec ? launch_map<T, true, true>(xin, pout, sc, m, n, ng, pl, s, stream)
              : launch_map<T, true, false>(xin, pout, sc, m, n, ng, pl, s,
                                           stream);
  } else {
    err = vec ? launch_map<T, false, true>(xin, pout, sc, m, n, ng, pl, s,
                                           stream)
              : launch_map<T, false, false>(xin, pout, sc, m, n, ng, pl, s,
                                            stream);
  }
  return static_cast<int>(err);
}

}  // namespace

#define TIT_MAP_LAUNCHER(suffix, T)                                           \
  extern "C" int tit_reinhard_map_##suffix(                                   \
      const void* x, void* p, void* scratch, void* mx, int n, int ng, int hh, \
      int wh, const void* scal, int ca_mode, cudaStream_t stream) {           \
    return launch<T>(x, p, scratch, mx, n, ng, hh, wh, scal, ca_mode,         \
                     stream);                                                 \
  }
TIT_FOR_EACH_DTYPE(TIT_MAP_LAUNCHER)
