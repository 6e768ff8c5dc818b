// K12<T>: bilinear resize straight from 12-channel phase form,
// (N, 12, hh, wh) x12 of T (bf16, f16 or f32) -> planar (N, 3, h', w') of
// T.
//
// Replaces taichi_image_tpu/ops/pallas/resize.py::_kernel (via
// resize_x12_bf16, pallas_call at resize.py:205) for bf16, and the XLA
// gather route models/camera_isp.py::_resize_from_phases for f16 and f32.
// The TPU kernel writes the separable bilinear taps as banded bf16 weight
// matrices for the MXU, because Mosaic has no fast gather; that rounds
// the weights and the row-stage intermediate to bf16. Here every output
// is the reference's own arithmetic in f32 (_resize_from_phases): the row
// taps first,
//   left  = top(r_lo, c_lo) + f * (bot(r_hi, c_lo) - top(r_lo, c_lo)),
//   right = top(r_lo, c_hi) + f * (bot(r_hi, c_hi) - top(r_lo, c_hi)),
// then out = left + g * (right - left), rounded once to T; all four taps
// are read even where f or g is 0 (0 * (bot - top) is not 0 for a NaN or
// inf tap). Full-res pixel (r, col) of color c is channel
// ((col % 2) * 2 + r % 2) * 3 + c of x12 at (r / 2, col / 2). Built with
// --fmad=false, so each product and sum rounds as the plain twin's do:
// bitwise equal. The taps (r_lo, r_hi, r_f for the output rows, c_lo,
// c_hi, c_f for the columns, full-res positions) come from
// ops/interpolate._axis_samples and live on the device, cached by the
// wrapper per shape and scale.
//
// Bound: memory on paper (x12 read about once and the output written
// once: 0.111 ms at x0.5 from 6 x 4K in bf16 at 3.35 TB/s), but a kernel
// that spends tens of instructions per output on indexing is bound by
// instruction issue instead: the f32 instance then moves twice the bytes
// in the same time. So nothing per output goes to indexing:
//   - the grid is (column tile, row tile, image), a tile kTileH output
//     rows by kRunsX * kV columns for a block of kRunsX x kRowsY threads,
//     with 32-bit offsets inside an image and no division anywhere;
//   - a thread takes a run of kV = 16 / sizeof(T) consecutive output
//     columns of kTileH / kRowsY rows, for all three colors: it loads its
//     column taps once and folds them (parity, half-res column) into
//     offsets that it reuses for every row and color; a row's taps are
//     uniform across the warp;
//   - each color's run is one 16-byte store where w' and the pointer
//     allow it, else an element path of the same arithmetic.
// Two paths share that arithmetic; the wrapper (ops/hopper/resize.py
// plan) picks one per resize, and PERF.md §6 has each one's time:
//   - aligned: a resize that halves both axes exactly (the resize to 1920
//     from 3840) has output (i, j) on half-res (i, j) in all four phases,
//     so a run's taps of a color are four 16-byte loads and x12 is read
//     exactly once: the bytes bound is reachable;
//   - direct: any other resize gathers its taps from device memory
//     through L1. Staging each tile's source window in shared memory by
//     cp.async first was slower on the downscales (x0.5, x0.37), where a
//     source value feeds about one output, and won only on upscales, which
//     are not a route the ISP runs; so nothing is staged.
// The tile geometry (kRunsX, kTileH) comes from resize.py as -D flags, so
// the wrapper's plan and the kernel read it from one place.
#include "common.cuh"

#if !defined(TIT_RESIZE_RUNS_X) || !defined(TIT_RESIZE_TILE_H)
#error "ops/hopper/resize.py builds this source with the tile geometry"
#endif

namespace {

constexpr int kRunsX = TIT_RESIZE_RUNS_X;  // threads across a tile row
constexpr int kRowsY = 8;                  // rows of threads of a block
constexpr int kTileH = TIT_RESIZE_TILE_H;  // output rows of a tile

template <typename T>
struct Geo {
  static constexpr int kV = 16 / sizeof(T);   // output columns per thread
  static constexpr int kTileW = kRunsX * kV;  // output columns of a tile
};

struct Frame {
  int hh, wh, h_out, w_out;
  int vec_out;  // 16-byte stores
};

struct Taps {
  const int* __restrict__ r_lo;
  const int* __restrict__ r_hi;
  const float* __restrict__ r_f;
  const int* __restrict__ c_lo;
  const int* __restrict__ c_hi;
  const float* __restrict__ c_f;
};

// The tile at (oy0, ox0), gathered from xb: 12 channel planes of
// `plane` elements.
template <typename T>
__device__ __forceinline__ void resize_tile(const T* __restrict__ xb,
                                            int plane, int ox0, int oy0,
                                            const Frame& f, const Taps& tp,
                                            T* __restrict__ ob) {
  constexpr int kV = Geo<T>::kV;
  const int ox = ox0 + threadIdx.x * kV;
  if (ox >= f.w_out) return;
  // the run's column taps as offsets: parity * 6 planes + half-res column
  int lo[kV], hi[kV];
  float g[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const int o = min(ox + k, f.w_out - 1);
    const int cl = tp.c_lo[o], ch = tp.c_hi[o];
    lo[k] = (cl & 1) * 6 * plane + (cl >> 1);
    hi[k] = (ch & 1) * 6 * plane + (ch >> 1);
    g[k] = tp.c_f[o];
  }
  const int out_plane = f.h_out * f.w_out;
  const int oy_end = min(oy0 + kTileH, f.h_out);
  for (int oy = oy0 + threadIdx.y; oy < oy_end; oy += kRowsY) {
    const int rl = tp.r_lo[oy], rh = tp.r_hi[oy];
    const float fr = tp.r_f[oy];
    // parity * 3 planes + half-res row
    const int top = (rl & 1) * 3 * plane + (rl >> 1) * f.wh;
    const int bot = (rh & 1) * 3 * plane + (rh >> 1) * f.wh;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T* sc = xb + c * plane;
      float o[kV];
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        const float tl = tit::load_f32(sc[top + lo[k]]);
        const float bl = tit::load_f32(sc[bot + lo[k]]);
        const float tr = tit::load_f32(sc[top + hi[k]]);
        const float br = tit::load_f32(sc[bot + hi[k]]);
        const float left = tl + fr * (bl - tl);
        const float right = tr + fr * (br - tr);
        o[k] = left + g[k] * (right - left);
      }
      T* dst = ob + c * out_plane + oy * f.w_out + ox;
      if (f.vec_out) {
        tit::Run<T, kV>::store(dst, o);
      } else {
#pragma unroll
        for (int k = 0; k < kV; ++k) {
          if (ox + k < f.w_out) dst[k] = tit::store_rn<T>(o[k]);
        }
      }
    }
  }
}

// The aligned tile: output (oy, ox) of color c has its four taps at
// half-res (oy, ox) in channels c, 3 + c, 6 + c and 9 + c, so a run's taps
// are four 16-byte loads.
template <typename T>
__device__ __forceinline__ void resize_tile_aligned(
    const T* __restrict__ xb, int plane, int ox0, int oy0, const Frame& f,
    const Taps& tp, T* __restrict__ ob) {
  constexpr int kV = Geo<T>::kV;
  using R = tit::Run<T, kV>;
  const int ox = ox0 + threadIdx.x * kV;
  if (ox >= f.w_out) return;
  float g[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) g[k] = tp.c_f[ox + k];
  const int out_plane = f.h_out * f.w_out;
  const int oy_end = min(oy0 + kTileH, f.h_out);
  for (int oy = oy0 + threadIdx.y; oy < oy_end; oy += kRowsY) {
    const float fr = tp.r_f[oy];
    const T* at = xb + oy * f.wh + ox;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float tl[kV], bl[kV], tr[kV], br[kV], o[kV];
      R::load(at + c * plane, tl);
      R::load(at + (3 + c) * plane, bl);
      R::load(at + (6 + c) * plane, tr);
      R::load(at + (9 + c) * plane, br);
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        const float left = tl[k] + fr * (bl[k] - tl[k]);
        const float right = tr[k] + fr * (br[k] - tr[k]);
        o[k] = left + g[k] * (right - left);
      }
      R::store(ob + c * out_plane + oy * f.w_out + ox, o);
    }
  }
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kRunsX * kRowsY)
    resize_kernel(const T* __restrict__ x, T* __restrict__ out, Frame f,
                  Taps tp) {
  const int ox0 = blockIdx.x * Geo<T>::kTileW, oy0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;
  const int plane = f.hh * f.wh;
  const T* xb = x + static_cast<size_t>(b) * 12 * plane;
  T* ob = out + static_cast<size_t>(b) * 3 * f.h_out * f.w_out;
  if constexpr (kAligned) {
    resize_tile_aligned<T>(xb, plane, ox0, oy0, f, tp, ob);
  } else {
    resize_tile<T>(xb, plane, ox0, oy0, f, tp, ob);
  }
}

template <typename T>
int launch(const void* x, void* out, int n, int hh, int wh, int h_out,
           int w_out, const void* r_lo, const void* r_hi, const void* r_f,
           const void* c_lo, const void* c_hi, const void* c_f, int aligned,
           cudaStream_t stream) {
  using G = Geo<T>;
  if (static_cast<long long>(n) * h_out * w_out == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (!tit::image_fits_int32(hh, wh) ||
      3LL * h_out * w_out > 0x7FFFFFFFLL || n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Frame f{hh, wh, h_out, w_out,
                w_out % G::kV == 0 && tit::aligned16(out)};
  // the aligned path loads and stores whole runs: the wrapper's plan asks
  // for it only where they are
  if (aligned && !(h_out == hh && w_out == wh && f.vec_out &&
                   tit::aligned16(x))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Taps tp{static_cast<const int*>(r_lo), static_cast<const int*>(r_hi),
                static_cast<const float*>(r_f), static_cast<const int*>(c_lo),
                static_cast<const int*>(c_hi), static_cast<const float*>(c_f)};
  const dim3 grid((w_out + G::kTileW - 1) / G::kTileW,
                  (h_out + kTileH - 1) / kTileH, n);
  const dim3 block(kRunsX, kRowsY);
  const auto* xin = static_cast<const T*>(x);
  auto* o = static_cast<T*>(out);
  if (aligned) {
    resize_kernel<T, true><<<grid, block, 0, stream>>>(xin, o, f, tp);
  } else {
    resize_kernel<T, false><<<grid, block, 0, stream>>>(xin, o, f, tp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// aligned: take the aligned path (the taps are the half-res grid itself,
// and x12's and the output's rows are whole 16-byte runs), else the
// direct one.
#define TIT_RESIZE_LAUNCHER(suffix, T)                                        \
  extern "C" int tit_resize_x12_##suffix(                                     \
      const void* x, void* out, int n, int hh, int wh, int h_out, int w_out,  \
      const void* r_lo, const void* r_hi, const void* r_f, const void* c_lo,  \
      const void* c_hi, const void* c_f, int aligned, cudaStream_t stream) {  \
    return launch<T>(x, out, n, hh, wh, h_out, w_out, r_lo, r_hi, r_f, c_lo, \
                     c_hi, c_f, aligned, stream);                             \
  }
TIT_FOR_EACH_DTYPE(TIT_RESIZE_LAUNCHER)
