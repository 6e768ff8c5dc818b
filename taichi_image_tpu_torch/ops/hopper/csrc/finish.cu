// K4<T>: tonemap finish, (N, 12, hh, wh) pre-gamma p of T (bf16, f16 or
// f32) + per-image max (N,) f32 -> planar u8 (N, 3, 2hh, 2wh):
// o = p / max(1e-6, max_out[n]), exp2(log2(o) * inv_gamma) when
// gamma != 1, trunc(clip(255 o, 0, 255)), and the 2x2 phase->planar
// interleave.
//
// Replaces taichi_image_tpu/ops/pallas/finish.py::_finish_kernel (via
// finish_planar_u8, pallas_call at finish.py:199). The TPU kernel packs
// four bytes into i32 words through one-hot MXU dots because Mosaic
// cannot store u8; Hopper stores the bytes directly. The working dtype
// changes only the load.
//
// Bound: memory. 12 * sizeof(T) bytes of p read and 12 bytes of u8
// written per half-res pixel. One thread per (n, c, i, j) writes the 2x2
// output quad as two 2-byte stores; channel pc*6 + pr*3 + c feeds output
// pixel (2i + pr, 2j + pc).
//
// The division is a true IEEE division and the u8 convert truncates
// toward zero (XLA's f32->u8 convert, camera_isp.py:1106); fmaxf maps a
// NaN (log2 of a negative p at gamma != 1) to 0.
#include "common.cuh"

namespace {

template <typename T>
__global__ void finish_kernel(const T* __restrict__ x,
                              const float* __restrict__ max_out,
                              uint8_t* __restrict__ out, int n, int hh,
                              int wh, int apply_gamma, float inv_gamma) {
  const long long plane = static_cast<long long>(hh) * wh;
  const long long total = static_cast<long long>(n) * 3 * plane;
  const long long row = 2LL * wh;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(idx % wh);
    const int i = static_cast<int>((idx / wh) % hh);
    const long long bc = idx / plane;  // b * 3 + c
    const int c = static_cast<int>(bc % 3);
    const long long b = bc / 3;
    const float mx = fmaxf(1e-6f, max_out[b]);
    const T* xb = x + b * 12 * plane + static_cast<long long>(i) * wh + j;
    uint8_t* ob = out + (bc * 2 * hh + 2LL * i) * row + 2LL * j;
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      uint8_t v[2];
#pragma unroll
      for (int pc = 0; pc < 2; ++pc) {
        float o = tit::load_f32(xb[(pc * 6 + pr * 3 + c) * plane]) / mx;
        if (apply_gamma) o = exp2f(log2f(o) * inv_gamma);
        const float s = fminf(fmaxf(255.0f * o, 0.0f), 255.0f);
        v[pc] = static_cast<uint8_t>(__float2uint_rz(s));
      }
      *reinterpret_cast<uchar2*>(ob + pr * row) = make_uchar2(v[0], v[1]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* max_out, void* out, int n, int hh,
           int wh, int apply_gamma, float inv_gamma, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * 3 * hh * wh;
  if (total == 0) return static_cast<int>(cudaSuccess);
  finish_kernel<T><<<tit::grid_for(total), tit::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(max_out),
      static_cast<uint8_t*>(out), n, hh, wh, apply_gamma, inv_gamma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TIT_FINISH_LAUNCHER(suffix, T)                                     \
  extern "C" int tit_finish_planar_u8_##suffix(                            \
      const void* x, const void* max_out, void* out, int n, int hh, int wh, \
      int apply_gamma, float inv_gamma, cudaStream_t stream) {             \
    return launch<T>(x, max_out, out, n, hh, wh, apply_gamma, inv_gamma,   \
                     stream);                                              \
  }
TIT_FOR_EACH_DTYPE(TIT_FINISH_LAUNCHER)
