// K4<T>: tonemap finish, (N, 12, hh, wh) p or x12 of T (bf16, f16 or
// f32) -> planar u8 (N, 3, 2hh, 2wh), or (N, 3, 2wh, 2hh) under a
// transform that swaps the axes. Two modes:
//   reinhard: o = p / max(1e-6, max_out[n]), exp2(log2(o) * inv_gamma)
//             when gamma != 1, trunc(clip(255 o, 0, 255));
//   linear:   y = max((x - m0) * inv_range, 0), the same gamma,
//             trunc(clip(clip(y, 0, 1) * 255, 0, 255)), with
//             scal = [m0, inv_range] computed on the device;
// then the 2x2 phase->planar interleave and the output transform.
//
// Replaces taichi_image_tpu/ops/pallas/finish.py::_finish_kernel, both
// modes (via finish_planar_u8, pallas_call at finish.py:199). The TPU
// kernel packs four bytes into i32 words through one-hot MXU dots because
// Mosaic cannot store u8; Hopper stores the bytes directly. The working
// dtype changes only the load. The transform (one of the eight of
// ops/interpolate.ImageTransform, as (swap, flip_y, flip_x) of
// models/camera_isp._TRANSFORM_SFF) only moves the store addresses: JAX's
// planar_from_phases_transformed folds it into the interleave transpose
// the same way.
//
// Bound: memory. 12 * sizeof(T) bytes read and 12 bytes of u8 written per
// half-res pixel. One thread per (n, c, i, j) holds the 2x2 output quad
// in registers and writes it as two 2-byte stores: channel pc*6 + pr*3 + c
// feeds input pixel (y, x) = (2i + pr, 2j + pc), stored at (y', x') with
// y' = flip_y ? H-1-y : y and x' = flip_x ? W-1-x : x, at out[y', x'] or,
// with swap, out[x', y']. Without swap the pairs along x stay adjacent;
// with swap the pairs along y do, and neighbouring threads then store
// into different rows (strided 2-byte stores: correct, not fast).
//
// The division is a true IEEE division and the u8 convert truncates
// toward zero (XLA's f32->u8 convert, camera_isp.py:1106); fmaxf maps a
// NaN (log2 of a negative p at gamma != 1) to 0.
#include "common.cuh"

namespace {

template <typename T, bool kLinear>
__global__ void finish_kernel(const T* __restrict__ x,
                              const float* __restrict__ scal,
                              uint8_t* __restrict__ out, int n, int hh,
                              int wh, int apply_gamma, float inv_gamma,
                              int swap, int flip_y, int flip_x) {
  const long long plane = static_cast<long long>(hh) * wh;
  const long long total = static_cast<long long>(n) * 3 * plane;
  const long long h = 2LL * hh, w = 2LL * wh;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(idx % wh);
    const int i = static_cast<int>((idx / wh) % hh);
    const long long bc = idx / plane;  // b * 3 + c
    const int c = static_cast<int>(bc % 3);
    const long long b = bc / 3;
    float mx = 0.0f, m0 = 0.0f, inv_range = 0.0f;
    if (kLinear) {
      m0 = scal[0];
      inv_range = scal[1];
    } else {
      mx = fmaxf(1e-6f, scal[b]);
    }
    const T* xb = x + b * 12 * plane + static_cast<long long>(i) * wh + j;
    uint8_t v[2][2];  // [pr][pc]
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
      for (int pc = 0; pc < 2; ++pc) {
        const float xv = tit::load_f32(xb[(pc * 6 + pr * 3 + c) * plane]);
        float s;
        if (kLinear) {
          float y = fmaxf((xv - m0) * inv_range, 0.0f);
          if (apply_gamma) y = exp2f(log2f(y) * inv_gamma);
          s = fminf(fmaxf(fminf(fmaxf(y, 0.0f), 1.0f) * 255.0f, 0.0f), 255.0f);
        } else {
          float o = xv / mx;
          if (apply_gamma) o = exp2f(log2f(o) * inv_gamma);
          s = fminf(fmaxf(255.0f * o, 0.0f), 255.0f);
        }
        v[pr][pc] = static_cast<uint8_t>(__float2uint_rz(s));
      }
    }
    uint8_t* ob = out + bc * h * w;
    if (!swap) {
      // rows y = 2i + pr of width w; the pair x = 2j, 2j + 1
      const long long x0 = flip_x ? w - 2 - 2LL * j : 2LL * j;
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const long long y = 2LL * i + pr;
        const long long row = flip_y ? h - 1 - y : y;
        *reinterpret_cast<uchar2*>(ob + row * w + x0) =
            flip_x ? make_uchar2(v[pr][1], v[pr][0])
                   : make_uchar2(v[pr][0], v[pr][1]);
      }
    } else {
      // rows x' of width h; the pair y = 2i, 2i + 1
      const long long y0 = flip_y ? h - 2 - 2LL * i : 2LL * i;
#pragma unroll
      for (int pc = 0; pc < 2; ++pc) {
        const long long xx = 2LL * j + pc;
        const long long row = flip_x ? w - 1 - xx : xx;
        *reinterpret_cast<uchar2*>(ob + row * h + y0) =
            flip_y ? make_uchar2(v[1][pc], v[0][pc])
                   : make_uchar2(v[0][pc], v[1][pc]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* scal, void* out, int n, int hh,
           int wh, int linear, int apply_gamma, float inv_gamma, int swap,
           int flip_y, int flip_x, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * 3 * hh * wh;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const auto* xin = static_cast<const T*>(x);
  const auto* s = static_cast<const float*>(scal);
  auto* o = static_cast<uint8_t*>(out);
  const unsigned grid = tit::grid_for(total);
  if (linear) {
    finish_kernel<T, true><<<grid, tit::kThreads, 0, stream>>>(
        xin, s, o, n, hh, wh, apply_gamma, inv_gamma, swap, flip_y, flip_x);
  } else {
    finish_kernel<T, false><<<grid, tit::kThreads, 0, stream>>>(
        xin, s, o, n, hh, wh, apply_gamma, inv_gamma, swap, flip_y, flip_x);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TIT_FINISH_LAUNCHER(suffix, T)                                        \
  extern "C" int tit_finish_planar_u8_##suffix(                               \
      const void* x, const void* scal, void* out, int n, int hh, int wh,      \
      int linear, int apply_gamma, float inv_gamma, int swap, int flip_y,     \
      int flip_x, cudaStream_t stream) {                                      \
    return launch<T>(x, scal, out, n, hh, wh, linear, apply_gamma, inv_gamma, \
                     swap, flip_y, flip_x, stream);                           \
  }
TIT_FOR_EACH_DTYPE(TIT_FINISH_LAUNCHER)
