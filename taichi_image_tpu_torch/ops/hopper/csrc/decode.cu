// K1<T>: packed12 decode, (N, H, 1.5W) u8 -> (N, 4, H/2, W/2) CFA phase
// planes of T (bf16, f16 or f32), in-phase order (row % 2) * 2 + col % 2.
//
// Replaces taichi_image_tpu/ops/pallas/decode.py::_decode_kernel: the
// bf16 form (decode12_phases_bf16, pallas_call at decode.py:145) and the
// q16 form of the Camera16 route (decode12_phases_q16, decode.py:185),
// whose raw 12-bit codes in i32 exist only because the TPU's Mosaic
// toolchain cannot store f16. The f32 form replaces the XLA decode of
// camera_isp.py:960-972. The TPU kernel de-strides the 3-byte groups with
// one-hot MXU dots over 384-byte lane groups; on Hopper a thread unpacks
// its bytes with shifts in registers.
//
// Bound: memory, 3 bytes read and 2 * sizeof(T) bytes written per column
// pair (0.052 ms for 6 x 4K bf16 at 3.35 TB/s). With so few bytes per
// pair, any index arithmetic per pair, let alone a 64-bit division, costs
// more than the pair's bytes take to move. So:
//   - The grid is (row chunks, packed rows y, images): a block knows its
//     row and image from blockIdx, the phase pair q = y & 1 and the
//     half-res row y >> 1 follow by bit operations, and all offsets
//     within an image are 32-bit. No division or modulo anywhere.
//   - On the vector path a block stages a chunk of up to kChunk column
//     pairs of its row in shared memory, with 16-byte loads of
//     consecutive lanes on consecutive 16 bytes. Each thread then takes
//     kV = 16 / sizeof(T) consecutive pairs (8 for bf16/f16, 4 for f32):
//     3 kV bytes from shared memory (bank-conflict free), the kV even and
//     kV odd codes unpacked by shifts at compile-time offsets, one
//     16-byte store into each of its two planes, so that a warp's store
//     is 512 contiguous bytes. A thread that read its 48 bytes of 16
//     pairs straight from device memory (no staging) made its warp's
//     loads and stores 48 and 32-64 bytes apart a lane: each instruction
//     half-filled 32 sectors, and f32, with four stores a plane, ran at
//     a third of its bound.
//   - A row of wb bytes with wb % 48 != 0 (whose rows cannot all start
//     16-byte aligned) or an unaligned tensor takes the element path of
//     the same kernel: one column pair per thread, three byte loads, two
//     scalar stores (the launcher picks kVec from the sizes and pointers).
//
// Value = f32(code) * scale, scale = f32(1/4095) passed from the host,
// rounded once to T (round to nearest even): bitwise equal to the JAX
// decode, which multiplies in f32 and casts (camera_isp.py:971-972,
// decode.py:143).
//
// K1's packed16 mode, decode16<T>, is a source mode of the CFA split
// (csrc/split.cu): packed16 bytes are little-endian u16 pixels.
#include "common.cuh"

namespace {

constexpr int kDecodeThreads = 128;
// column pairs a block stages on the vector path (6144 bytes, the whole
// 3840-pixel row of a 4K frame)
constexpr int kChunk = 2048;

// The even and odd values of one column pair's bytes, standard or IDS
// layout.
template <bool kIds>
__device__ __forceinline__ void codes(unsigned b0, unsigned b1, unsigned b2,
                                      float scale, float& even, float& odd) {
  unsigned e, o;
  if constexpr (!kIds) {
    e = ((b1 & 0xFu) << 8) | b0;
    o = (b2 << 4) | (b1 >> 4);
  } else {
    e = (b0 << 4) | (b2 & 0xFu);
    o = (b1 << 4) | (b2 >> 4);
  }
  even = static_cast<float>(e) * scale;
  odd = static_cast<float>(o) * scale;
}

template <typename T, bool kVec, bool kIds>
__global__ void __launch_bounds__(kDecodeThreads)
    decode12_kernel(const uint8_t* __restrict__ raw, T* __restrict__ out,
                    int h, int wb, int wh, float scale) {
  const int y = blockIdx.y, b = blockIdx.z;
  const int plane = (h >> 1) * wh;
  const uint8_t* __restrict__ row =
      raw + static_cast<size_t>(b) * h * wb + y * wb;
  T* __restrict__ even_out = out + static_cast<size_t>(b) * 4 * plane +
                             2 * (y & 1) * plane + (y >> 1) * wh;
  T* __restrict__ odd_out = even_out + plane;
  if constexpr (kVec) {
    constexpr int kV = 16 / sizeof(T);
    using R = tit::Run<T, kV>;
    __shared__ alignas(16) uint8_t bytes[3 * kChunk];
    const int j0 = blockIdx.x * kChunk;
    const int pairs = min(kChunk, wh - j0);  // a multiple of 16
    const uint4* src = reinterpret_cast<const uint4*>(row + 3 * j0);
    for (int v = threadIdx.x; v < 3 * pairs / 16; v += kDecodeThreads) {
      reinterpret_cast<uint4*>(bytes)[v] = src[v];
    }
    __syncthreads();
    for (int u = threadIdx.x; u * kV < pairs; u += kDecodeThreads) {
      // the unit's 3 kV bytes as words: 8-byte reads for 24 bytes (a
      // half-warp's 16 reads then fall in distinct banks), 4-byte reads
      // for 12
      unsigned w[3 * kV / 4];
      if constexpr (kV == 8) {
        const uint2* q = reinterpret_cast<const uint2*>(bytes + 3 * kV * u);
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const uint2 d = q[m];
          w[2 * m] = d.x;
          w[2 * m + 1] = d.y;
        }
      } else {
        const unsigned* q =
            reinterpret_cast<const unsigned*>(bytes + 3 * kV * u);
#pragma unroll
        for (int m = 0; m < 3; ++m) w[m] = q[m];
      }
      float ev[kV], od[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        unsigned by[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int i = 3 * j + k;  // byte i of the unit, little-endian
          by[k] = (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
        }
        codes<kIds>(by[0], by[1], by[2], scale, ev[j], od[j]);
      }
      R::store(even_out + j0 + kV * u, ev);
      R::store(odd_out + j0 + kV * u, od);
    }
  } else {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= wh) return;
    const uint8_t* p = row + 3 * t;
    float even, odd;
    codes<kIds>(p[0], p[1], p[2], scale, even, odd);
    even_out[t] = tit::store_rn<T>(even);
    odd_out[t] = tit::store_rn<T>(odd);
  }
}

template <typename T, bool kVec, bool kIds>
cudaError_t launch_decode(const uint8_t* raw, T* out, int n, int h, int wb,
                          float scale, cudaStream_t stream) {
  const int wh = wb / 3;
  const int per_block = kVec ? kChunk : kDecodeThreads;
  const dim3 grid((wh + per_block - 1) / per_block, h, n);
  decode12_kernel<T, kVec, kIds><<<grid, kDecodeThreads, 0, stream>>>(
      raw, out, h, wb, wh, scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* raw, void* out, int n, int h, int wb, int ids,
           float scale, cudaStream_t stream) {
  const int wh = wb / 3;
  if (static_cast<long long>(n) * h * wh == 0) {
    return static_cast<int>(cudaSuccess);
  }
  // 32-bit offsets within an image; rows and images on the grid's y and
  // z axes
  if (static_cast<long long>(h) * wb > 0x7FFFFFFFLL || h > 65535 ||
      n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // whole 16-byte vectors in every row (wb % 48 == 0: wh % 16 == 0)
  const bool vec = wb % 48 == 0 && tit::aligned16(raw) &&
                   tit::aligned16(out);
  const auto* r = static_cast<const uint8_t*>(raw);
  auto* o = static_cast<T*>(out);
  cudaError_t err;
  if (vec) {
    err = ids ? launch_decode<T, true, true>(r, o, n, h, wb, scale, stream)
              : launch_decode<T, true, false>(r, o, n, h, wb, scale, stream);
  } else {
    err = ids ? launch_decode<T, false, true>(r, o, n, h, wb, scale, stream)
              : launch_decode<T, false, false>(r, o, n, h, wb, scale, stream);
  }
  return static_cast<int>(err);
}

}  // namespace

#define TIT_DECODE_LAUNCHER(suffix, T)                                      \
  extern "C" int tit_decode12_##suffix(const void* raw, void* out, int n,  \
                                       int h, int wb, int ids, float scale, \
                                       cudaStream_t stream) {               \
    return launch<T>(raw, out, n, h, wb, ids, scale, stream);               \
  }
TIT_FOR_EACH_DTYPE(TIT_DECODE_LAUNCHER)
