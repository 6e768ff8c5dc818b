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
// emits the sample through one-hot MXU dots.
//
// Bound: memory, 4 values of T in and 12 out per half-res pixel (0.120 ms
// for 6 x 4K in bf16 at 3.35 TB/s, 0.241 ms in f32), with the f32
// arithmetic close behind: 84 live taps of an MHC variant are 168
// multiplies and adds per channel set (no FMA), about 250 instructions
// per pixel, 0.10 ms of dispatch at 6 x 4K. The design keeps loads in
// flight while the arithmetic runs, and spends as few instructions per
// pixel as it can (the tile, its loader and the run window are
// stencil.cuh's, which K7 shares):
//   - a block of 32 x 8 threads takes a tile of 32 x 128 half-res pixels
//     of one image (blockIdx = column tile, row tile, image) and stages
//     the four phase planes of the tile with a one-pixel halo in shared
//     memory through 16-byte cp.async copies, all in flight at once, with
//     zeros outside the frame (the padding that the border factors
//     renormalize);
//   - __launch_bounds__(256, 2) holds a thread to 128 registers, so two
//     blocks share an SM and one stages its tile while the other computes;
//   - each thread finishes kV = 4 consecutive pixels of a row from the
//     3 x 6 window of each phase (f32 in registers), and writes each of
//     the 12 channels as one 4 * sizeof(T)-byte store: a warp writes a
//     whole 128-pixel row of a channel, 256 or 512 contiguous bytes. Four
//     pixels, not eight: the 16-bit types' eight-pixel window does not
//     fit in 128 registers without spilling;
//   - only the nonzero taps of the Bayer pattern and method are summed
//     (stencil.cuh's compile-time tap-mask variants, one kernel each);
//   - only tiles on the frame's edge evaluate the border and corner
//     factors; interior tiles skip them;
//   - all indexing is 32-bit within an image, with no division per pixel.
// A frame whose row is not a whole number of 16-byte copies, or a plane
// that is not 16-byte aligned, stages and stores element by element
// instead (the launcher picks `vec` from the sizes and pointers); the
// arithmetic is the same. Each channel is rounded once to T, and the
// sample is that T value.
//
// Banded mode (the large-frame band loop, models/large.py): the input is
// a row band with one halo row on each side, the top and bottom factors
// apply at the finish spec's gated rows (stencil.cuh RowGates), and the
// kernel stores only rows r0 .. r0 + ho of the hh it reads, as an
// (N, 12, ho, wh) output whose sample is taken from the stored rows. The
// grid covers the stored rows only, so a band's halo rows cost their
// reads and nothing else, and no slice of the output is copied. A whole
// frame is r0 = 0, ho = hh with the gates at rows 0 and hh - 1. The
// kernel counts rows in the stored frame (the launcher moves the gates
// there), and only the staging adds r0. The frame's nine ints are a
// __grid_constant__ parameter, read where they are used: passed as a
// plain parameter, the f16 MHC instantiations spilled 40 bytes each at
// the 128 registers of __launch_bounds__(256, 2).
#include "stencil.cuh"

namespace {

constexpr int kV = 4;  // pixels per thread
template <typename T>
using Tile = tit::StencilTile<T, kV>;

// hh x wh read, rows r0 .. r0 + ho stored (and sampled from), the top and
// bottom factors at stored rows g
struct Frame {
  int hh, wh, step, hs, ws, r0, ho;
  tit::RowGates g;
};

// One thread's run: pixels (i, j0 .. j0 + kV) of the stored rows from the
// staged tile, pixel j0 at tile row rr, column c0.
template <typename T, int kVariant, bool kBorder>
__device__ __forceinline__ void stencil_run(
    const T* __restrict__ s, int rr, int c0, int i, int j0, const Frame& f,
    bool vec, const tit::StencilParams& p, T* __restrict__ outb,
    T* __restrict__ sampb) {
  float win[4][3][kV + 2];  // the 3 x (kV + 2) window of each phase
  tit::load_window<T, kV>(s, rr, c0, win);
  const int plane = f.ho * f.wh;
  const int at = i * f.wh + j0;
  const bool top = i == f.g.top, bot = i == f.g.bot;
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    float o[3][kV];
    tit::stencil_run_phase<kVariant, kBorder, kV>(win, ph, top, bot, j0, f.wh,
                                                  p, o);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T* dst = outb + (ph * 3 + c) * plane + at;
      if (vec) {
        tit::Run<T, kV>::store(dst, o[c]);
      } else {
#pragma unroll
        for (int k = 0; k < kV; ++k) {
          if (j0 + k < f.wh) dst[k] = tit::store_rn<T>(o[c][k]);
        }
      }
    }
    // the sampled pixels of the run: k0, k0 + step, ...
    if (ph == 0 && f.step > 0 && i % f.step == 0) {
      const int m = j0 % f.step;
      int kn = m ? f.step - m : 0, jn = (j0 + kn) / f.step;
      const int srow = (i / f.step) * f.ws;
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        if (k == kn && j0 + k < f.wh) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            sampb[c * f.hs * f.ws + srow + jn] = tit::store_rn<T>(o[c][k]);
          }
          kn += f.step;
          ++jn;
        }
      }
    }
  }
}

template <typename T, int kVariant>
__global__ void __launch_bounds__(tit::kTileThreads, 2)
    stencil_kernel(const T* __restrict__ x, T* __restrict__ out,
                   T* __restrict__ samp, const __grid_constant__ Frame f,
                   int vec,
                   const __grid_constant__ tit::StencilParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const int x0 = blockIdx.x * Tile<T>::kTileW;
  const int y0 = blockIdx.y * tit::kTileH;  // a stored row
  const int b = blockIdx.z;
  const T* xb = x + static_cast<size_t>(b) * 4 * f.hh * f.wh;
  tit::stage_tile<T, kV>(s, xb, x0, y0 + f.r0, f.hh, f.wh, vec,
                         threadIdx.y * tit::kRunsX + threadIdx.x);
  const bool edge = tit::tile_on_edge<T, kV>(x0, y0, f.g, f.wh);
  const int c0 = threadIdx.x * kV, j0 = x0 + c0;
  if (j0 >= f.wh) return;
  T* outb = out + static_cast<size_t>(b) * 12 * f.ho * f.wh;
  T* sampb = samp + static_cast<size_t>(b) * 3 * f.hs * f.ws;
  for (int rr = threadIdx.y; rr < tit::kTileH; rr += tit::kRowsY) {
    const int i = y0 + rr;
    if (i >= f.ho) break;
    if (edge) {
      stencil_run<T, kVariant, true>(s, rr, c0, i, j0, f, vec, p, outb,
                                     sampb);
    } else {
      stencil_run<T, kVariant, false>(s, rr, c0, i, j0, f, vec, p, outb,
                                      sampb);
    }
  }
}

template <typename T>
int launch(const void* x, void* out, void* samp, int n, int hh, int wh,
           int step, const float* params, int has_ccm, int variant,
           int top_row, int bot_row, int r0, int ho, cudaStream_t stream) {
  using Tl = Tile<T>;
  if (static_cast<long long>(n) * ho * wh == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (!tit::image_fits_int32(hh, wh) || n > 65535 || r0 < 0 || ho < 0 ||
      r0 + ho > hh) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const tit::StencilParams p = tit::stencil_params_from(params, has_ccm);
  Frame f{hh, wh, step, step > 0 ? (ho + step - 1) / step : 0,
          step > 0 ? (wh + step - 1) / step : 0, r0, ho,
          // in stored rows; a gate below 0 (none, or on a halo row) is
          // -1, which no stored row matches
          tit::RowGates{top_row >= r0 ? top_row - r0 : -1,
                        bot_row >= r0 ? bot_row - r0 : -1}};
  // 16-byte copies of whole rows (so every plane and row starts aligned)
  // and kV-element stores
  const int vec = wh % Tl::kS == 0 && tit::aligned16(x) &&
                  tit::aligned16(out);
  const dim3 grid((wh + Tl::kTileW - 1) / Tl::kTileW,
                  (ho + tit::kTileH - 1) / tit::kTileH, n);
  const dim3 block(tit::kRunsX, tit::kRowsY);
  return tit::with_variant(variant, [&](auto v) {
    auto* kernel = stencil_kernel<T, decltype(v)::value>;
    // f32 tiles take 74 KB, above the 48 KB of static shared memory
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, block, Tl::kBytes, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(samp),
        f, vec, p);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

#define TIT_STENCIL_LAUNCHER(suffix, T)                                      \
  extern "C" int tit_demosaic_stencil_##suffix(                              \
      const void* x, void* out, void* samp, int n, int hh, int wh, int step, \
      const float* params, int has_ccm, int variant, int top_row,            \
      int bot_row, int r0, int ho, cudaStream_t stream) {                    \
    return launch<T>(x, out, samp, n, hh, wh, step, params, has_ccm,         \
                     variant, top_row, bot_row, r0, ho, stream);             \
  }
TIT_FOR_EACH_DTYPE(TIT_STENCIL_LAUNCHER)
