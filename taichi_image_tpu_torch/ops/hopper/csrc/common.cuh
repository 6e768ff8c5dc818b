// Shared helpers of the Hopper kernels (built with nvcc for sm_90a,
// --fmad=false, no fast math; see ops/hopper/__init__.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace tit

// X-macro over the working dtypes: X(suffix, T) once per instantiation,
// so each .cu declares its extern "C" launchers tit_<name>_<suffix> in
// one line. The suffixes are ops/hopper/__init__.py's DTYPE_SUFFIX.
#define TIT_FOR_EACH_DTYPE(X) \
  X(bf16, __nv_bfloat16)      \
  X(f16, __half)              \
  X(f32, float)
