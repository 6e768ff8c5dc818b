// yuv420_planar: planar u8 RGB (N, 3, h, w), h and w even -> planar I420
// u8: Y (N, h, w) and VU (N, 2, h/2, w/2), V then U.
//
// Replaces the XLA conversion taichi_image_tpu/models/camera_isp.py:1406
// (yuv420_from_planar_u8), the I420 tail of the resize and odd-stride
// routes. Per pixel x = u8 / 255 (from a per-block table of k / 255
// divided in IEEE), channels reversed: each of the Y, U and V rows of the
// BT.601 matrix as ((m0 b + m1 g) + m2 r) + offset; Y =
// trunc(clip(min(1, y) * 255, 0, 255)); per 2x2 block the mean ((tl + tr)
// + bl) + br, * 0.25, of U and of V (the matrix before the mean), then the
// same clamp and truncation. ops/hopper/yuv420.py's yuv420_planar_plain
// sums in the same order; nothing is contracted (--fmad=false).
//
// Bound: memory, 3 bytes read and 1.5 written per pixel (56.0 MB at 6 x
// 1920 x 1080, 0.0167 ms at 3.35 TB/s). A thread takes kB = 8 blocks of one
// block row: per row and channel one 16-byte load, per row one 16-byte Y
// store, per chroma plane one 8-byte store (issuing all six loads before
// the first row's arithmetic was slower). A width that is not a whole
// number of runs, or a plane not 16-byte aligned, takes the byte-by-byte
// loads and stores of the same kernel.
#include <climits>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kB = 8;  // 2x2 blocks per thread: 16 pixels of two rows

// The rows of the conversion on (b, g, r) and their offsets
// (ops/hopper/yuv420.py coefficients).
struct Yuv {
  float y[3], u[3], v[3];
  float off_y, off_u, off_v;
};

// ((m0 b + m1 g) + m2 r) + off for the row (y, u or v) of cv
#define YUV_ROW(cv, row, b, g, r) \
  (((cv.row[0] * (b) + cv.row[1] * (g)) + cv.row[2] * (r)) + cv.off_##row)

// trunc(clip(min(1, v) * 255, 0, 255))
__device__ __forceinline__ unsigned yuv_u8(float v) {
  return __float2uint_rz(fminf(fmaxf(fminf(v, 1.0f) * 255.0f, 0.0f), 255.0f));
}

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

// Block (32, 8) over (runs, block rows), grid z over images.
__global__ void __launch_bounds__(256)
    yuv420_planar_kernel(const uint8_t* __restrict__ rgb,
                         uint8_t* __restrict__ yp, uint8_t* __restrict__ vu,
                         int h, int w, int vec, Yuv cv) {
  __shared__ float inv255[256];
  inv255[threadIdx.y * blockDim.x + threadIdx.x] =
      __fdiv_rn(static_cast<float>(threadIdx.y * blockDim.x + threadIdx.x),
                255.0f);
  __syncthreads();
  const int b = blockIdx.z, hb = h >> 1, wb = w >> 1;
  const int bi = blockIdx.y * blockDim.y + threadIdx.y;
  const int bj0 = (blockIdx.x * blockDim.x + threadIdx.x) * kB;
  if (bi >= hb || bj0 >= wb) return;
  const int n = min(kB, wb - bj0);  // blocks in this run
  const int plane = h * w;
  const uint8_t* src = rgb + static_cast<size_t>(b) * 3 * plane + 2 * bi * w +
                       2 * bj0;
  uint8_t* yrow = yp + static_cast<size_t>(b) * plane + 2 * bi * w + 2 * bj0;
  float su[kB], sv[kB];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    unsigned px[3][2 * kB];  // the run's 16 bytes of each channel
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint8_t* p = src + c * plane + r * w;
      if (vec) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        const unsigned wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 2 * kB; ++e) {
          px[c][e] = (wd[e >> 2] >> (8 * (e & 3))) & 0xFFu;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2 * kB; ++e) {
          px[c][e] = e < 2 * n ? p[e] : 0u;
        }
      }
    }
    unsigned yq[2 * kB];
#pragma unroll
    for (int e = 0; e < 2 * kB; ++e) {
      const float xb = inv255[px[2][e]], xg = inv255[px[1][e]];
      const float xr = inv255[px[0][e]];
      yq[e] = yuv_u8(YUV_ROW(cv, y, xb, xg, xr));
      const float u = YUV_ROW(cv, u, xb, xg, xr);
      const float v = YUV_ROW(cv, v, xb, xg, xr);
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

}  // namespace

extern "C" int tit_yuv420_planar(const void* rgb, void* y, void* vu, int n,
                                 int h, int w, const float* coef,
                                 cudaStream_t stream) {
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
  const dim3 block(32, 8);
  const dim3 grid((w / 2 + block.x * kB - 1) / (block.x * kB),
                  (h / 2 + block.y - 1) / block.y, n);
  yuv420_planar_kernel<<<grid, block, 0, stream>>>(
      static_cast<const uint8_t*>(rgb), static_cast<uint8_t*>(y),
      static_cast<uint8_t*>(vu), h, w, vec, cv);
  return static_cast<int>(cudaGetLastError());
}
