// Planar I420 on Hopper, two forms, each writing Y (N, h', w') and VU
// (N, 2, h'/2, w'/2), V then U. Both replace the XLA conversion
// taichi_image_tpu/models/camera_isp.py:1406 (yuv420_from_planar_u8), the
// I420 tail of the resize and odd-stride routes: per pixel x = u8 / 255
// (the wrapper's per-device table of k / 255, divided in IEEE), channels
// reversed: each of the Y, U and V rows of the BT.601 matrix as ((m0 b +
// m1 g) + m2 r) + offset; Y = trunc(clip(min(1, y) * 255, 0, 255)); per
// 2x2 block the mean ((tl + tr) + bl) + br, * 0.25, of U and of V (the
// matrix before the mean), then the same clamp and truncation.
// ops/hopper/yuv420.py's twins sum in the same order; nothing is
// contracted (--fmad=false).
//
//   - yuv420_planar: planar u8 RGB (N, 3, h, w), h and w even, no
//     transform (the odd-stride route, after K4 RGB). Bound: memory, 3
//     bytes read and 1.5 written per pixel (56.0 MB at 6 x 1920 x 1080,
//     0.0167 ms at 3.35 TB/s). A thread takes kB = 8 blocks of one block
//     row: per row and channel one 16-byte load, per row one 16-byte Y
//     store, per chroma plane one 8-byte store (issuing all six loads
//     before the first row's arithmetic was slower). Row 0's loads are in
//     flight while the block copies the table into shared memory. The
//     grid is one run per thread over each image's block rows in turn, so
//     no block column is left part empty (a 2-D grid of 32-run columns
//     left a quarter of the last one idle at 1920 wide). A width that is
//     not a whole number of runs, or a plane not 16-byte aligned, takes
//     the byte-by-byte loads and stores of the same kernel.
//   - yuv420_planar_tone<T>: the resize route's whole tail in one pass,
//     from K3's untransformed planar p of T (N, 3, h, w) and its
//     per-image max, or the resized image and [m0, inv_range]: K4's tone
//     (finish.cuh tone_u8), the output transform (one of the eight, as
//     (swap, flip_y, flip_x)) and the conversion, the u8 RGB never
//     written. It replaces the JAX resize route's XLA tail,
//     reinhard_apply_ca or linear_apply_ca, _transform_planar and
//     yuv420_from_planar_u8 (camera_isp.py:1721-1727, :1790-1792). The
//     chroma sums the four pixels of each output block in the output's
//     order. finish.cuh's I420 tile (kPlanar) runs it. Bound: memory,
//     3 sizeof(T) bytes read and 1.5 written per pixel (93.3 MB at 6 x
//     1920 x 1080 bf16, 0.0279 ms; f32 168.0 MB, 0.0501 ms).
#include <climits>
#include <cstring>

#include "finish.cuh"

namespace {

using tit::Yuv;
using tit::yuv_u8;

constexpr int kB = 8;  // 2x2 blocks per thread: 16 pixels of two rows

// One chroma plane's bytes cq[k] of a run at crow: an 8-byte store with
// `vec`, else the n bytes of the run.
__device__ __forceinline__ void store_chroma_run(uint8_t* crow,
                                                 const unsigned (&cq)[kB],
                                                 int vec, int n) {
  if (vec) {
    *reinterpret_cast<uint2*>(crow) =
        make_uint2(cq[0] | cq[1] << 8 | cq[2] << 16 | cq[3] << 24,
                   cq[4] | cq[5] << 8 | cq[6] << 16 | cq[7] << 24);
  } else {
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      if (k >= n) break;
      crow[k] = static_cast<uint8_t>(cq[k]);
    }
  }
}

// The 16 bytes of each channel of one row of a run at p (channels a plane
// apart), four to a word: a 16-byte load each with `vec`, else the 2n bytes
// of the run and zeros.
__device__ __forceinline__ void load_run_row(const uint8_t* p, int plane,
                                             int vec, int n, uint4 (&px)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint8_t* pc = p + c * plane;
    if (vec) {
      px[c] = *reinterpret_cast<const uint4*>(pc);
    } else {
      unsigned wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 2 * kB; ++e) {
        if (e < 2 * n) wd[e >> 2] |= static_cast<unsigned>(pc[e]) << (8 * (e & 3));
      }
      px[c] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
}

__device__ __forceinline__ unsigned byte_at(const uint4& v, int e) {
  const unsigned w = e < 4 ? v.x : e < 8 ? v.y : e < 12 ? v.z : v.w;
  return (w >> (8 * (e & 3))) & 0xFFu;
}

// Block 256 threads over one image's runs (grid.x) and images (grid.y).
__global__ void __launch_bounds__(256)
    yuv420_planar_kernel(const uint8_t* __restrict__ rgb,
                         const float* __restrict__ inv255g,
                         uint8_t* __restrict__ yp, uint8_t* __restrict__ vu,
                         int h, int w, int vec, Yuv cv) {
  __shared__ float inv255[256];
  const int b = blockIdx.y, hb = h >> 1, wb = w >> 1;
  const int runs = (wb + kB - 1) / kB;  // runs of a block row
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int bi = idx / runs, bj0 = (idx - bi * runs) * kB;
  const bool live = bi < hb;
  const int n = min(kB, wb - bj0);  // blocks in this run
  const int plane = h * w;
  const uint8_t* src = rgb + static_cast<size_t>(b) * 3 * plane + 2 * bi * w +
                       2 * bj0;
  uint4 px[3];  // the run's 16 bytes of each channel in one row
  if (live) load_run_row(src, plane, vec, n, px);
  inv255[threadIdx.x] = inv255g[threadIdx.x];
  __syncthreads();
  if (!live) return;
  uint8_t* yrow = yp + static_cast<size_t>(b) * plane + 2 * bi * w + 2 * bj0;
  float su[kB], sv[kB];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r) load_run_row(src + w, plane, vec, n, px);
    unsigned yq[2 * kB];
#pragma unroll
    for (int e = 0; e < 2 * kB; ++e) {
      const float xb = inv255[byte_at(px[2], e)];
      const float xg = inv255[byte_at(px[1], e)];
      const float xr = inv255[byte_at(px[0], e)];
      yq[e] = yuv_u8(TIT_YUV_ROW(cv, y, xb, xg, xr));
      const float u = TIT_YUV_ROW(cv, u, xb, xg, xr);
      const float v = TIT_YUV_ROW(cv, v, xb, xg, xr);
      const int k = e >> 1;  // tl, tr on row 0, then bl, br
      su[k] = (r == 0 && (e & 1) == 0) ? u : su[k] + u;
      sv[k] = (r == 0 && (e & 1) == 0) ? v : sv[k] + v;
    }
    uint8_t* yr = yrow + r * w;
    if (vec) {
      unsigned wd[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        wd[m] = yq[4 * m] | yq[4 * m + 1] << 8 | yq[4 * m + 2] << 16 |
                yq[4 * m + 3] << 24;
      }
      *reinterpret_cast<uint4*>(yr) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 2 * kB; ++e) {
        if (e >= 2 * n) break;
        yr[e] = static_cast<uint8_t>(yq[e]);
      }
    }
  }
  unsigned vq[kB], uq[kB];
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    vq[k] = yuv_u8(sv[k] * 0.25f);
    uq[k] = yuv_u8(su[k] * 0.25f);
  }
  uint8_t* vrow = vu + static_cast<size_t>(b) * 2 * hb * wb + bi * wb + bj0;
  store_chroma_run(vrow, vq, vec, n);
  store_chroma_run(vrow + hb * wb, uq, vec, n);
}

// The tonemap form: n images of (3, h, w) of T, h and w even.
template <typename T>
int launch_tone(const void* x, const void* scal, void* y, void* vu, int n,
                int h, int w, int linear, int tone, float inv_gamma,
                int swap, int flip_y, int flip_x, const float* coef,
                const void* inv255, cudaStream_t stream) {
  if (static_cast<long long>(n) * h * w == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int hh = h / 2, wh = w / 2;
  if (h % 2 || w % 2 || !tit::image_fits_int32(hh, wh) || n > 65535 ||
      (hh + 7) / 8 > 65535 ||  // the grid's y: tiles of 8 or 16 block rows
      !tit::tone_ok(tone)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Yuv cv;
  memcpy(&cv, coef, sizeof(cv));
  const tit::Finish f{hh, wh, flip_y, flip_x, 0, inv_gamma};
  const auto* xin = static_cast<const T*>(x);
  const auto* s = static_cast<const float*>(scal);
  const auto* tab = static_cast<const float*>(inv255);
  auto* yo = static_cast<uint8_t*>(y);
  auto* vo = static_cast<uint8_t*>(vu);
  return static_cast<int>(
      swap ? tit::launch_i420_tiles<T, tit::I420::kPlanar, true>(
                 xin, s, tab, yo, vo, n, f, linear, tone, cv, stream)
           : tit::launch_i420_tiles<T, tit::I420::kPlanar, false>(
                 xin, s, tab, yo, vo, n, f, linear, tone, cv, stream));
}

}  // namespace

extern "C" int tit_yuv420_planar(const void* rgb, void* y, void* vu, int n,
                                 int h, int w, const float* coef,
                                 const void* inv255, cudaStream_t stream) {
  if (static_cast<long long>(n) * h * w == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (3LL * h * w > INT_MAX || n > 65535 || h % 2 || w % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = w % (2 * kB) == 0 && tit::aligned16(rgb) &&
                  tit::aligned16(y) && tit::aligned16(vu);
  Yuv cv;
  static_assert(sizeof(Yuv) == 12 * sizeof(float), "Yuv is 12 floats");
  memcpy(&cv, coef, sizeof(cv));
  const long long runs = static_cast<long long>(h / 2) * ((w / 2 + kB - 1) / kB);
  const dim3 grid(static_cast<unsigned>((runs + 255) / 256), n);
  yuv420_planar_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const uint8_t*>(rgb), static_cast<const float*>(inv255),
      static_cast<uint8_t*>(y), static_cast<uint8_t*>(vu), h, w, vec, cv);
  return static_cast<int>(cudaGetLastError());
}

#define TIT_YUV420_TONE_LAUNCHER(suffix, T)                                  \
  extern "C" int tit_yuv420_planar_tone_##suffix(                            \
      const void* x, const void* scal, void* y, void* vu, int n, int h,      \
      int w, int linear, int tone, float inv_gamma, int swap, int flip_y,    \
      int flip_x, const float* coef, const void* inv255,                     \
      cudaStream_t stream) {                                                 \
    return launch_tone<T>(x, scal, y, vu, n, h, w, linear, tone,             \
                          inv_gamma, swap, flip_y, flip_x, coef, inv255,     \
                          stream);                                           \
  }
TIT_FOR_EACH_DTYPE(TIT_YUV420_TONE_LAUNCHER)
