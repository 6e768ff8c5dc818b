// K1<T>: packed12 decode, (N, H, 1.5W) u8 -> (N, 4, H/2, W/2) CFA phase
// planes of T (bf16, f16 or f32), in-phase order (row % 2) * 2 + col % 2.
//
// Replaces taichi_image_tpu/ops/pallas/decode.py::_decode_kernel: the
// bf16 form (decode12_phases_bf16, pallas_call at decode.py:145) and the
// q16 form of the Camera16 route (decode12_phases_q16, decode.py:185),
// whose raw 12-bit codes in i32 exist only because the TPU's Mosaic
// toolchain cannot store f16. The f32 form replaces the XLA decode of
// camera_isp.py:960-972. The TPU kernel de-strides the 3-byte groups with
// one-hot MXU dots over 384-byte lane groups; on Hopper each thread
// simply reads its 3 bytes.
//
// Bound: memory. 3 bytes read and 2 * sizeof(T) bytes written per column
// pair; one thread per (n, row y, column pair j), neighbouring threads on
// neighbouring byte triples and output elements, so loads and stores
// coalesce within a warp.
//
// Value = f32(code) * scale, scale = f32(1/4095) passed from the host,
// rounded once to T (round to nearest even): bitwise equal to the JAX
// decode, which multiplies in f32 and casts (camera_isp.py:971-972,
// decode.py:143).
#include "common.cuh"

namespace {

template <typename T>
__global__ void decode12_kernel(const uint8_t* __restrict__ raw,
                                T* __restrict__ out, int n, int h, int wb,
                                int ids, float scale) {
  const int wh = wb / 3;
  const long long plane = static_cast<long long>(h / 2) * wh;
  const long long total = static_cast<long long>(n) * h * wh;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(idx % wh);
    const long long r = idx / wh;
    const int y = static_cast<int>(r % h);
    const long long b = r / h;
    const uint8_t* p = raw + (b * h + y) * wb + 3LL * j;
    const unsigned b0 = p[0], b1 = p[1], b2 = p[2];
    unsigned even, odd;
    if (!ids) {
      even = ((b1 & 0xFu) << 8) | b0;
      odd = (b2 << 4) | (b1 >> 4);
    } else {
      even = (b0 << 4) | (b2 & 0xFu);
      odd = (b1 << 4) | (b2 >> 4);
    }
    const int q = y & 1;
    T* o = out + b * 4 * plane + static_cast<long long>(y >> 1) * wh + j;
    o[(2 * q) * plane] = tit::store_rn<T>(static_cast<float>(even) * scale);
    o[(2 * q + 1) * plane] = tit::store_rn<T>(static_cast<float>(odd) * scale);
  }
}

template <typename T>
int launch(const void* raw, void* out, int n, int h, int wb, int ids,
           float scale, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * h * (wb / 3);
  if (total == 0) return static_cast<int>(cudaSuccess);
  decode12_kernel<T><<<tit::grid_for(total), tit::kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(raw), static_cast<T*>(out), n, h, wb, ids,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TIT_DECODE_LAUNCHER(suffix, T)                                      \
  extern "C" int tit_decode12_##suffix(const void* raw, void* out, int n,  \
                                       int h, int wb, int ids, float scale, \
                                       cudaStream_t stream) {               \
    return launch<T>(raw, out, n, h, wb, ids, scale, stream);               \
  }
TIT_FOR_EACH_DTYPE(TIT_DECODE_LAUNCHER)
