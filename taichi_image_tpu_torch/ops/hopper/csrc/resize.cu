// K12<T>: bilinear resize straight from 12-channel phase form,
// (N, 12, hh, wh) x12 of T (bf16, f16 or f32) -> planar (N, 3, h', w') of
// T.
//
// Replaces taichi_image_tpu/ops/pallas/resize.py::_kernel (via
// resize_x12_bf16, pallas_call at resize.py:205) for bf16, and the XLA
// gather route models/camera_isp.py::_resize_from_phases for f16 and f32.
// The TPU kernel writes the separable bilinear taps as banded bf16 weight
// matrices for the MXU, because Mosaic has no fast gather; that rounds
// the weights and the row-stage intermediate to bf16. Here each thread
// computes one output pixel by the reference's own arithmetic in f32
// (_resize_from_phases): the row taps first,
//   left  = top(r_lo, c_lo) + f * (bot(r_hi, c_lo) - top(r_lo, c_lo)),
//   right = top(r_lo, c_hi) + f * (bot(r_hi, c_hi) - top(r_lo, c_hi)),
// then out = left + g * (right - left), rounded once to T. Full-res pixel
// (r, col) of color c is channel ((col % 2) * 2 + r % 2) * 3 + c of x12 at
// (r / 2, col / 2). Built with --fmad=false, so each product and sum
// rounds as the plain twin's do: bitwise equal.
//
// The taps (r_lo, r_hi, r_f for the output rows, c_lo, c_hi, c_f for the
// columns, full-res positions) come from ops/interpolate._axis_samples and
// live on the device, cached by the wrapper per shape and scale.
//
// Bound: memory. One T stored and four taps loaded per output pixel; at
// x0.5 (6x4K -> 1920x1080) the four taps of a pixel are the four phase
// channels of one color at one half-res position, so x12 is read about
// once in all, and consecutive threads read consecutive positions.
#include "common.cuh"

namespace {

template <typename T>
__global__ void resize_kernel(const T* __restrict__ x, T* __restrict__ out,
                              int n, int hh, int wh, int h_out, int w_out,
                              const int* __restrict__ r_lo,
                              const int* __restrict__ r_hi,
                              const float* __restrict__ r_f,
                              const int* __restrict__ c_lo,
                              const int* __restrict__ c_hi,
                              const float* __restrict__ c_f) {
  const long long plane = static_cast<long long>(hh) * wh;
  const long long out_plane = static_cast<long long>(h_out) * w_out;
  const long long total = static_cast<long long>(n) * 3 * out_plane;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int ox = static_cast<int>(idx % w_out);
    const int oy = static_cast<int>((idx / w_out) % h_out);
    const long long bc = idx / out_plane;  // b * 3 + c
    const int c = static_cast<int>(bc % 3);
    const T* xb = x + (bc / 3) * 12 * plane;
    const int rl = r_lo[oy], rh = r_hi[oy];
    const int cl = c_lo[ox], ch = c_hi[ox];
    const float f = r_f[oy], g = c_f[ox];
    auto at = [&](int r, int col) {
      const int chan = ((col & 1) * 2 + (r & 1)) * 3 + c;
      return tit::load_f32(xb[chan * plane +
                              static_cast<long long>(r >> 1) * wh +
                              (col >> 1)]);
    };
    const float tl = at(rl, cl), bl = at(rh, cl);
    const float tr = at(rl, ch), br = at(rh, ch);
    const float left = tl + f * (bl - tl);
    const float right = tr + f * (br - tr);
    out[idx] = tit::store_rn<T>(left + g * (right - left));
  }
}

template <typename T>
int launch(const void* x, void* out, int n, int hh, int wh, int h_out,
           int w_out, const void* r_lo, const void* r_hi, const void* r_f,
           const void* c_lo, const void* c_hi, const void* c_f,
           cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * 3 * h_out * w_out;
  if (total == 0) return static_cast<int>(cudaSuccess);
  resize_kernel<T><<<tit::grid_for(total), tit::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, hh, wh, h_out, w_out,
      static_cast<const int*>(r_lo), static_cast<const int*>(r_hi),
      static_cast<const float*>(r_f), static_cast<const int*>(c_lo),
      static_cast<const int*>(c_hi), static_cast<const float*>(c_f));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TIT_RESIZE_LAUNCHER(suffix, T)                                        \
  extern "C" int tit_resize_x12_##suffix(                                     \
      const void* x, void* out, int n, int hh, int wh, int h_out, int w_out,  \
      const void* r_lo, const void* r_hi, const void* r_f, const void* c_lo,  \
      const void* c_hi, const void* c_f, cudaStream_t stream) {               \
    return launch<T>(x, out, n, hh, wh, h_out, w_out, r_lo, r_hi, r_f, c_lo, \
                     c_hi, c_f, stream);                                      \
  }
TIT_FOR_EACH_DTYPE(TIT_RESIZE_LAUNCHER)
