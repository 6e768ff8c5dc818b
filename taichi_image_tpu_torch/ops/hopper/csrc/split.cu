// The CFA phase split, split_<S>_<T>: an unpacked CFA (N, H, W) of source
// type S (u16, f16 or f32) -> (N, 4, H/2, W/2) phase planes of T (bf16,
// f16 or f32), in-phase order (row % 2) * 2 + col % 2. K1's packed16
// mode, decode16_<T>, is one more source: (N, H, 2W) u8 packed16 bytes
// are (N, H, W) little-endian u16 pixels.
//
// Replaces the XLA decode of the unpacked formats in
// taichi_image_tpu/models/camera_isp.py:987-991 (cfa_phases, then the
// normalisation): u16 is f32(x) / 65535 as an IEEE division (the JAX
// route divides, where the packed routes multiply by a reciprocal); f16
// and f32 are cast to T, rounded to nearest even (f16 -> bf16 goes
// through f32, which is exact). packed16 replaces camera_isp.py:973-986:
// f32(hi * 256 + lo), exact, times f32(1/65535), rounded once to T. No
// TPU kernel existed: XLA split and converted in one fused pass.
//
// Bound: memory, 2 sizeof(S) bytes read and 2 sizeof(T) written per
// column pair (6 x 4K: 199.1 MB for 16-bit S and T, 0.0594 ms at 3.35
// TB/s; 298.6 MB with one side f32, 0.0891 ms; 398.1 MB f32 -> f32,
// 0.1188 ms). The grid is (row chunks, rows y, images) as in K1, so a
// block knows its row, phase pair and half-res row by bit operations and
// indexes an image in 32 bits. A thread takes kPairs = 4 column pairs:
// one 16-byte load of a 16-bit source (two of an f32 one), the even and
// odd values unpacked from the words, one run of kPairs stored into each
// of its two planes. A width that is not a whole number of runs (W % 8 !=
// 0) or an unaligned tensor takes the element path of the same kernel.
#include "common.cuh"

namespace {

constexpr int kSplitThreads = 128;
constexpr int kPairs = 4;

// The packed16 source: a little-endian u16 pixel, scaled by a multiply.
struct Packed16 {
  uint16_t bits;
};
// f32(1/65535), rounded once from the double quotient as the host's
// np.float32(1 / 65535) is (the twin's DECODE16_SCALE)
constexpr float kInv65535 = static_cast<float>(1.0 / 65535.0);

// A source element's f32 value from its bits: u16 over 65535 (the
// division rounded to nearest even, zeros kept off its slow path),
// packed16 times f32(1/65535), f16 and f32 exactly.
template <typename S>
__device__ __forceinline__ float value_of(unsigned bits) {
  if constexpr (std::is_same_v<S, uint16_t>) {
    return tit::div_rn_keep_zero(static_cast<float>(bits), 65535.0f);
  } else if constexpr (std::is_same_v<S, Packed16>) {
    return static_cast<float>(bits) * kInv65535;
  } else if constexpr (std::is_same_v<S, __half>) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
  } else {
    return __uint_as_float(bits);
  }
}

template <typename S, typename T, bool kVec>
__global__ void __launch_bounds__(kSplitThreads)
    split_kernel(const void* __restrict__ cfa, T* __restrict__ out, int h,
                 int w, int wh) {
  using Bits = std::conditional_t<sizeof(S) == 2, uint16_t, uint32_t>;
  const int y = blockIdx.y, b = blockIdx.z;
  const int plane = (h >> 1) * wh;
  const Bits* __restrict__ row = static_cast<const Bits*>(cfa) +
                                 static_cast<size_t>(b) * h * w + y * w;
  T* __restrict__ even_out = out + static_cast<size_t>(b) * 4 * plane +
                             2 * (y & 1) * plane + (y >> 1) * wh;
  T* __restrict__ odd_out = even_out + plane;
  if constexpr (kVec) {
    // the kPairs pairs' 2 kPairs elements as 32-bit words
    constexpr int kWords = 2 * kPairs * static_cast<int>(sizeof(S)) / 4;
    const int j = kPairs * (blockIdx.x * kSplitThreads + threadIdx.x);
    if (j >= wh) return;
    const uint4* src = reinterpret_cast<const uint4*>(row + 2 * j);
    unsigned wd[kWords];
#pragma unroll
    for (int m = 0; m < kWords / 4; ++m) {
      const uint4 v = src[m];
      wd[4 * m] = v.x;
      wd[4 * m + 1] = v.y;
      wd[4 * m + 2] = v.z;
      wd[4 * m + 3] = v.w;
    }
    float ev[kPairs], od[kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      if constexpr (sizeof(S) == 2) {  // a pair in one word, even low
        ev[k] = value_of<S>(wd[k] & 0xFFFFu);
        od[k] = value_of<S>(wd[k] >> 16);
      } else {
        ev[k] = value_of<S>(wd[2 * k]);
        od[k] = value_of<S>(wd[2 * k + 1]);
      }
    }
    tit::Run<T, kPairs>::store(even_out + j, ev);
    tit::Run<T, kPairs>::store(odd_out + j, od);
  } else {
    const int j = blockIdx.x * kSplitThreads + threadIdx.x;
    if (j >= wh) return;
    even_out[j] = tit::store_rn<T>(value_of<S>(row[2 * j]));
    odd_out[j] = tit::store_rn<T>(value_of<S>(row[2 * j + 1]));
  }
}

template <typename S, typename T>
int launch(const void* cfa, void* out, int n, int h, int w,
           cudaStream_t stream) {
  const int wh = w / 2;
  if (static_cast<long long>(n) * h * wh == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (static_cast<long long>(h) * w > 0x7FFFFFFFLL || h > 65535 ||
      n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // whole runs in every row: wh % 4 == 0, so every row starts on a
  // 16-byte boundary of the source and a run's boundary of each plane
  const bool vec = w % (2 * kPairs) == 0 && tit::aligned16(cfa) &&
                   tit::aligned16(out);
  const int per_block = vec ? kPairs * kSplitThreads : kSplitThreads;
  const dim3 grid((wh + per_block - 1) / per_block, h, n);
  auto* o = static_cast<T*>(out);
  if (vec) {
    split_kernel<S, T, true><<<grid, kSplitThreads, 0, stream>>>(cfa, o, h,
                                                                 w, wh);
  } else {
    split_kernel<S, T, false><<<grid, kSplitThreads, 0, stream>>>(cfa, o, h,
                                                                  w, wh);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TIT_SPLIT_LAUNCHERS(suffix, T)                                      \
  extern "C" int tit_split_u16_##suffix(const void* cfa, void* out, int n, \
                                        int h, int w, cudaStream_t stream) { \
    return launch<uint16_t, T>(cfa, out, n, h, w, stream);                  \
  }                                                                         \
  extern "C" int tit_split_f16_##suffix(const void* cfa, void* out, int n, \
                                        int h, int w, cudaStream_t stream) { \
    return launch<__half, T>(cfa, out, n, h, w, stream);                    \
  }                                                                         \
  extern "C" int tit_split_f32_##suffix(const void* cfa, void* out, int n, \
                                        int h, int w, cudaStream_t stream) { \
    return launch<float, T>(cfa, out, n, h, w, stream);                     \
  }
TIT_FOR_EACH_DTYPE(TIT_SPLIT_LAUNCHERS)

// packed16: wb bytes a row are wb / 2 u16 pixels (2-byte aligned: the
// wrapper copies a tensor that starts on an odd byte)
#define TIT_DECODE16_LAUNCHER(suffix, T)                                    \
  extern "C" int tit_decode16_##suffix(const void* raw, void* out, int n,  \
                                       int h, int wb, cudaStream_t stream) { \
    return launch<Packed16, T>(raw, out, n, h, wb / 2, stream);             \
  }
TIT_FOR_EACH_DTYPE(TIT_DECODE16_LAUNCHER)
