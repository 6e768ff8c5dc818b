// Shared helpers of the Hopper kernels (built with nvcc for sm_90a,
// --fmad=false, no fast math; see ops/hopper/__init__.py).
#pragma once

#include <cuda_bf16.h>
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

}  // namespace tit
