// Shared helpers of the Hopper kernels (built with nvcc for sm_90a,
// --fmad=false, no fast math; see ops/hopper/__init__.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace tit {

constexpr int kThreads = 256;

// Blocks for a grid-stride loop over `total` items.
inline unsigned grid_for(long long total, long long cap = 1LL << 20) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// Working-dtype I/O: every kernel computes in f32, loads a T exactly and
// stores one f32 result as T with a single round to nearest even (the
// rounding of torch's .to(T) and of XLA's convert). f16 subnormals are
// kept: nothing is built with -ftz or fast math.
__device__ __forceinline__ float load_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float load_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float load_f32(float v) { return v; }

template <typename T>
__device__ T store_rn(float f);
template <>
__device__ __forceinline__ __nv_bfloat16 store_rn<__nv_bfloat16>(float f) {
  return __float2bfloat16_rn(f);
}
template <>
__device__ __forceinline__ __half store_rn<__half>(float f) {
  return __float2half_rn(f);
}
template <>
__device__ __forceinline__ float store_rn<float>(float f) {
  return f;
}

// Runs of kN consecutive elements of T moved as one 4-, 8- or 16-byte
// vector access (kN * sizeof(T) bytes, aligned to that size). In the
// 32-bit words of a run the elements sit in address order, two 16-bit
// elements to a word (the low half first). Element indices are
// compile-time after unrolling, so the unpacking is shifts and moves
// between registers.
template <typename T, int kN>
struct Run {
  static constexpr int kWords = kN * static_cast<int>(sizeof(T)) / 4;
  static_assert(kWords == 1 || kWords == 2 || kWords == 4,
                "a run is 4, 8 or 16 bytes");

  // The kN elements at p, each converted exactly to f32.
  __device__ static __forceinline__ void load(const T* p, float* f) {
    unsigned w[kWords];
    load_words(p, w);
    unpack(w, f);
  }

  // The run's words as they lie in memory: a kernel can issue the loads
  // of several runs before it converts any of them.
  __device__ static __forceinline__ void load_words(const T* p, unsigned* w) {
    if constexpr (kWords == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else if constexpr (kWords == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    }
  }

  // The kN elements of the words w, each converted exactly to f32.
  __device__ static __forceinline__ void unpack(const unsigned* w, float* f) {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if constexpr (sizeof(T) == 4) {
        f[k] = __uint_as_float(w[k]);
      } else if constexpr (std::is_same_v<T, __half>) {
        f[k] = __half2float(__ushort_as_half(static_cast<unsigned short>(
            (k & 1) ? (w[k >> 1] >> 16) : (w[k >> 1] & 0xFFFFu))));
      } else {  // bf16 -> f32 is exact: the bits shifted up
        f[k] = __uint_as_float((k & 1) ? (w[k >> 1] & 0xFFFF0000u)
                                       : (w[k >> 1] << 16));
      }
    }
  }

  // f[0 .. kN) each rounded once to T (store_rn) and stored at p.
  __device__ static __forceinline__ void store(T* p, const float* f) {
    unsigned w[kWords];
#pragma unroll
    for (int m = 0; m < kWords; ++m) {
      if constexpr (sizeof(T) == 4) {
        w[m] = __float_as_uint(f[m]);
      } else {
        w[m] = pair16(f[2 * m], f[2 * m + 1]);
      }
    }
    store_words(p, w);
  }

  // The words w of a run (as load_words gives them) stored at p.
  __device__ static __forceinline__ void store_words(T* p, const unsigned* w) {
    if constexpr (kWords == 4) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (kWords == 2) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<unsigned*>(p) = w[0];
    }
  }

 private:
  // lo and hi each rounded to nearest even, in one word (lo in the low
  // half): one cvt.rn.{f16,bf16}x2.f32, the rounding of store_rn.
  __device__ static __forceinline__ unsigned pair16(float lo, float hi) {
    if constexpr (std::is_same_v<T, __half>) {
      const __half2 v = __floats2half2_rn(lo, hi);
      return __half_as_ushort(v.x) | static_cast<unsigned>(__half_as_ushort(v.y))
                                         << 16;
    } else {
      const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
      return __bfloat16_as_ushort(v.x) |
             static_cast<unsigned>(__bfloat16_as_ushort(v.y)) << 16;
    }
  }
};

// a / b rounded to nearest even, as `/` compiles it (PTX div.rn.f32). A
// zero dividend sends that division down its slow path, a subroutine
// call, and zeros are common in these images (clipped or dark pixels, a
// pixel at the metering minimum). For b > 0 the quotient of a zero is the
// zero itself, sign and all, so a zero divides 1 instead and is put back;
// every other zero dividend (b <= 0 or NaN) takes the true division, so
// the result is bitwise a / b. The division is PTX behind the select so
// that the compiler cannot fold the select into a select of two
// quotients, one of them the zero's.
__device__ __forceinline__ float div_rn_keep_zero(float a, float b) {
  const bool zero = a == 0.0f && b > 0.0f;
  float q;
  asm("div.rn.f32 %0, %1, %2;" : "=f"(q) : "f"(zero ? 1.0f : a), "f"(b));
  return zero ? a : q;
}

// The launchers index within one image in 32 bits: the 12 planes of an
// image must fit in an int (the wrappers refuse larger frames).
inline bool image_fits_int32(int hh, int wh) {
  return 12LL * hh * wh <= 0x7FFFFFFFLL;
}

// Whether 16-byte vector accesses at p (and every 16th byte after it)
// are aligned.
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A launcher's answer for each device, by device ordinal: 0 until that
// device is first asked. A device of ordinal kMaxDevices or more is asked
// at every launch.
constexpr int kMaxDevices = 64;
struct PerDevice {
  std::atomic<int> value[kMaxDevices];
};

// Blocks of `threads` threads, each with `smem` bytes of dynamic shared
// memory, that the current device holds at once for `kernel` (its SMs x
// the blocks an SM holds), into `blocks`: a grid-stride kernel given that
// many runs in one wave, a cooperative grid of at most that many blocks.
// Asked once a device, kept in the launcher's `cache` (zero-initialised,
// one per kernel). Returns the failed query's error, if any.
template <typename Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                                   PerDevice& cache, int& blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < kMaxDevices;
  blocks = kept ? cache.value[dev].load(std::memory_order_relaxed) : 0;
  if (blocks > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  }
  if (e != cudaSuccess) return e;
  blocks = sms * per_sm;
  if (kept) cache.value[dev].store(blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace tit

// X-macro over the working dtypes: X(suffix, T) once per instantiation,
// so each .cu declares its extern "C" launchers tit_<name>_<suffix> in
// one line. The suffixes are ops/hopper/__init__.py's DTYPE_SUFFIX.
#define TIT_FOR_EACH_DTYPE(X) \
  X(bf16, __nv_bfloat16)      \
  X(f16, __half)              \
  X(f32, float)
