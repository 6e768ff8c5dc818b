// M<T>: the EMA metering update and the scalar vectors the tonemaps read,
// from the (N, C, hs, ws) metering sample of T (bf16, f16 or f32; C >= 3,
// any strides) and the previous vec9, with no host sync:
//   b      = lerp(t, [min(x), max(x)], prev[0:2])            (all C channels)
//   scaled = (x - b0) / (b1 - b0 + 1e-6)                     (channels 0-2)
//   gray   = 0.299 r + 0.587 g + 0.114 b, log_gray = log(max(gray, 1e-4))
//   stats  = [b, min(log_gray), max(log_gray),
//             sum(log_gray, gray, r, g, b) / n_total]
//   vec9   = lerp(t, stats, prev), lerp(t, a, b) = a + t (b - a);
// and from vec9 the map's scalars [m0, m1 - m0, 0.3 + 0.7 key^1.4, m5,
// exp(-intensity), light_adapt] (+ [color_adapt, cmean_r, cmean_g,
// cmean_b], cmean_c = m5 + color_adapt (m_{6+c} - m5)) with key = (m3 - m4)
// / (m3 - m2), and the linear tonemap's [m0, 1 / (m1 - m0)].
//
// Replaces what XLA fuses around the TPU kernels in the JAX step:
// taichi_image_tpu/models/camera_isp.py:996-1025 (metering_update_ca) and
// taichi_image_tpu/ops/pallas/reinhard.py:52-76 (reinhard_scal,
// reinhard_scal_ca, "computed in XLA"), plus the linear [m0, inv_range].
// The plain twin (ops/hopper/meter.py) is the torch code the port ran
// before: about 52 device operations a step.
//
// Bound: the main path's sample is 6 x 3 x 270 x 480 (4.67 MB in bf16,
// 1.39 us at 3.35 TB/s; 2.79 us in f32), which two launches of a
// block-wide pass and a last-block reduction cannot reach: on an H100 the
// bounds launch takes 10-11 us and the stats launch 12-14 us (PERF.md
// section 6), against about 0.8 ms for the ~52 operations they replace.
// Design:
//   - launch 1 (bounds): each block takes the min and max of its pixels'
//     C channels; the last block to count itself on a counter reduces
//     the blocks' pairs in block order and writes [-min, max] (the pair
//     an all_reduce MAX reduces over a process group);
//   - launch 2 (stats): each block recomputes b from that pair, takes
//     its pixels' log bounds and five sums (in double), and the last block
//     reduces the partials in block order: without a group it finalizes
//     (vec9 and the vectors); under a group it writes this rank's [-lmin,
//     lmax] and sums (f32) for the two all_reduce calls;
//   - launch 3 (finalize, a group only): one thread, the same finalize.
// A thread walks its block's pixels kThreads apart with the loads of
// kUnroll of them in flight (one at a time left each waiting on memory);
// pixel indices are 32-bit (the launcher refuses 2^31 pixels or more).
// The block partition is a function of the logical shape alone (the
// strides move only the addresses), so a strided view and its contiguous
// copy give the same bits, and so do the whole frame's sample and the
// band loop's concatenated one. No float atomics: the counters are
// integers, and the last block resets its own, so no memset runs.
//
// Bitwise with the twin's f32 ops: the bounds and the log bounds (min and
// max are exact; scaled is a true division, gray is summed left to right
// with no FMA under --fmad=false, log is logf), within rounding the sums
// and the means (another order). A NaN in the sample makes the bounds NaN,
// as amin/amax do (fminf/fmaxf would drop it). The vectors use powf and
// expf, as torch.pow and torch.exp compute them on the card.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kPerThread = 8;  // pixels a thread takes below kMaxBlocks
constexpr int kUnroll = 4;     // pixels whose loads a thread has in flight
// partials the scratch holds: ops/hopper/meter.py MAX_BLOCKS, which sizes
// the scratch
constexpr int kMaxBlocks = TIT_METER_MAX_BLOCKS;

struct StatsPartial {
  double sum[5];  // log_gray, gray, r, g, b
  float lmin, lmax;
};

// The per-device, per-stream scratch (ops/hopper/meter.py allocates it
// zeroed once): the two launches' block counters, then their partials.
struct Scratch {
  unsigned count[2];
  unsigned pad[14];
  float2 bounds[kMaxBlocks];
  StatsPartial stats[kMaxBlocks];
};
static_assert(sizeof(StatsPartial) == 48 && sizeof(Scratch) ==
                  64 + kMaxBlocks * (8 + 48),
              "ops/hopper/meter.py scratch_bytes");

struct Sample {
  int c, hs, ws;
  long long s0, s1, s2, s3;  // strides in elements
  long long pixels;          // n * hs * ws
  long long chunk;           // pixels of a block
  int blocks;
};

struct Vectors {
  float intensity, light_adapt, color_adapt;
  int ca_mode;
};

__device__ __forceinline__ float lerp(float t, float a, float b) {
  return a + t * (b - a);
}

// min and max that keep a NaN (amin / amax / jnp.min semantics)
__device__ __forceinline__ float min_nan(float m, float v) {
  return (v < m || v != v) ? v : m;
}
__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || v != v) ? v : m;
}

struct MinOp {
  __device__ float operator()(float a, float b) const { return min_nan(a, b); }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return max_nan(a, b); }
};
struct SumOp {
  __device__ double operator()(double a, double b) const { return a + b; }
};

// A block reduction of one value per thread in a fixed order: a butterfly
// in each warp, then warp 0 over the warps' results. Thread 0 gets the
// result. `sh` holds kThreads / 32 values; the call begins and ends with a
// barrier of the whole block.
template <typename V, typename Op>
__device__ V block_reduce(V v, Op op, V identity, V* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < tit::kThreads / 32 ? sh[lane] : identity;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
    }
  }
  return v;
}

// Pixel p's address (p < 2^31, the launcher's limit: 32-bit divisions).
template <typename T>
__device__ __forceinline__ const T* pixel(const T* x, const Sample& s,
                                          long long p) {
  const unsigned q = static_cast<unsigned>(p);
  const unsigned row = q / static_cast<unsigned>(s.ws);
  const unsigned col = q - row * s.ws;
  const unsigned n = row / static_cast<unsigned>(s.hs), y = row - n * s.hs;
  return x + n * s.s0 + y * s.s2 + col * s.s3;
}

// Channels 0-2 of the thread's pixels base + u kThreads (u < kUnroll)
// below p1, every load issued before any value is used; px[u] for the
// other channels.
template <typename T>
__device__ __forceinline__ void load_pixels(const T* x, const Sample& s,
                                            long long base, long long p1,
                                            float v[kUnroll][3],
                                            const T* px[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long p = base + u * tit::kThreads;
    px[u] = pixel(x, s, p < p1 ? p : base);
#pragma unroll
    for (int c = 0; c < 3; ++c) v[u][c] = tit::load_f32(px[u][c * s.s1]);
  }
}

// Whether this block is the last of `blocks` to finish: thread 0 counts
// it (after a fence that publishes its partial), every thread learns the
// answer. The last block resets the counter for the next launch.
__device__ bool last_block(unsigned* count, int blocks) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(count, 1u) == static_cast<unsigned>(blocks - 1);
    if (last) {
      *count = 0u;
      __threadfence();
    }
  }
  __syncthreads();
  return last;
}

// The map's and the linear tonemap's vectors from vec9 m: scal (6, or 10
// with ca_mode) and lin (2), in the twin's order of operations.
__device__ void write_vectors(const float* m, const Vectors& v, float* scal,
                              float* lin) {
  const float key = (m[3] - m[4]) / (m[3] - m[2]);
  scal[0] = m[0];
  scal[1] = m[1] - m[0];
  scal[2] = 0.3f + 0.7f * powf(key, 1.4f);
  scal[3] = m[5];
  scal[4] = expf(-v.intensity);
  scal[5] = v.light_adapt;
  if (v.ca_mode) {
    scal[6] = v.color_adapt;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      scal[7 + c] = m[5] + v.color_adapt * (m[6 + c] - m[5]);
    }
  }
  lin[0] = m[0];
  lin[1] = 1.0f / (m[1] - m[0]);
}

// vec9 and the vectors into out = [vec9 (9) | scal (10) | lin (2)] from
// [-min, max], the log bounds and the five sums: the one finalize of the
// grouped and ungrouped paths, so that a one-rank group gives the same
// bits as no group.
__device__ void finalize(const float* mm, float lmin, float lmax,
                         const float* sums, const float* prev, float t,
                         float n_total, const Vectors& v, float* out) {
  float stats[9];
  stats[0] = lerp(t, -mm[0], prev[0]);
  stats[1] = lerp(t, mm[1], prev[1]);
  stats[2] = lmin;
  stats[3] = lmax;
#pragma unroll
  for (int k = 0; k < 5; ++k) stats[4 + k] = sums[k] / n_total;
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = lerp(t, stats[i], prev[i]);
  write_vectors(out, v, out + 9, out + 19);
}

__device__ __forceinline__ float read_t(const float* t_ptr, float t) {
  return t_ptr ? *t_ptr : t;
}

// Launch 1: [-min, max] over every value of the sample into mm.
template <typename T>
__global__ void __launch_bounds__(tit::kThreads)
    bounds_kernel(const T* __restrict__ x, Sample s, Scratch* sc,
                  float* __restrict__ mm) {
  __shared__ float sh[tit::kThreads / 32];
  float mn = INFINITY, mx = -INFINITY;
  const long long p0 = blockIdx.x * s.chunk;
  const long long p1 = min(s.pixels, p0 + s.chunk);
  for (long long base = p0 + threadIdx.x; base < p1;
       base += tit::kThreads * kUnroll) {
    float v[kUnroll][3];
    const T* px[kUnroll];
    load_pixels(x, s, base, p1, v, px);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * tit::kThreads >= p1) break;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        mn = min_nan(mn, v[u][c]);
        mx = max_nan(mx, v[u][c]);
      }
      for (int c = 3; c < s.c; ++c) {
        const float w = tit::load_f32(px[u][c * s.s1]);
        mn = min_nan(mn, w);
        mx = max_nan(mx, w);
      }
    }
  }
  mn = block_reduce(mn, MinOp{}, INFINITY, sh);
  mx = block_reduce(mx, MaxOp{}, -INFINITY, sh);
  if (threadIdx.x == 0) sc->bounds[blockIdx.x] = make_float2(mn, mx);
  if (!last_block(&sc->count[0], s.blocks)) return;
  mn = INFINITY;
  mx = -INFINITY;
  for (int b = threadIdx.x; b < s.blocks; b += tit::kThreads) {
    const float2 v = __ldcg(&sc->bounds[b]);
    mn = min_nan(mn, v.x);
    mx = max_nan(mx, v.y);
  }
  mn = block_reduce(mn, MinOp{}, INFINITY, sh);
  mx = block_reduce(mx, MaxOp{}, -INFINITY, sh);
  if (threadIdx.x == 0) {
    mm[0] = -mn;
    mm[1] = mx;
  }
}

// The log bounds and the five sums of a block's values, reduced over the
// block; thread 0 holds them.
__device__ void reduce_stats(StatsPartial& st, void* shm) {
  auto* shd = static_cast<double*>(shm);
  auto* shf = static_cast<float*>(shm);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    st.sum[k] = block_reduce(st.sum[k], SumOp{}, 0.0, shd);
  }
  st.lmin = block_reduce(st.lmin, MinOp{}, INFINITY, shf);
  st.lmax = block_reduce(st.lmax, MaxOp{}, -INFINITY, shf);
}

// Launch 2: each block's log bounds and sums; the last block reduces
// them and finalizes into out (no group) or writes this rank's [-lmin,
// lmax] and sums into lb and sums (a group).
template <typename T>
__global__ void __launch_bounds__(tit::kThreads)
    stats_kernel(const T* __restrict__ x, Sample s, Scratch* sc,
                 const float* __restrict__ mm, const float* __restrict__ prev,
                 const float* t_ptr, float t_val, float* __restrict__ lb,
                 float* __restrict__ sums, float* __restrict__ out,
                 float n_total, Vectors v) {
  __shared__ double sh[tit::kThreads / 32];
  const float t = read_t(t_ptr, t_val);
  const float b0 = lerp(t, -mm[0], prev[0]);
  const float b1 = lerp(t, mm[1], prev[1]);
  const float den = (b1 - b0) + 1e-6f;
  StatsPartial st{{0.0, 0.0, 0.0, 0.0, 0.0}, INFINITY, -INFINITY};
  const long long p0 = blockIdx.x * s.chunk;
  const long long p1 = min(s.pixels, p0 + s.chunk);
  for (long long base = p0 + threadIdx.x; base < p1;
       base += tit::kThreads * kUnroll) {
    float v[kUnroll][3];
    const T* px[kUnroll];
    load_pixels(x, s, base, p1, v, px);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * tit::kThreads >= p1) break;
      float sc3[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sc3[c] = tit::div_rn_keep_zero(v[u][c] - b0, den);
      }
      const float gray = 0.299f * sc3[0] + 0.587f * sc3[1] + 0.114f * sc3[2];
      const float lg = logf(gray < 1e-4f ? 1e-4f : gray);  // NaN stays NaN
      st.sum[0] += lg;
      st.sum[1] += gray;
#pragma unroll
      for (int c = 0; c < 3; ++c) st.sum[2 + c] += sc3[c];
      st.lmin = min_nan(st.lmin, lg);
      st.lmax = max_nan(st.lmax, lg);
    }
  }
  reduce_stats(st, sh);
  if (threadIdx.x == 0) sc->stats[blockIdx.x] = st;
  if (!last_block(&sc->count[1], s.blocks)) return;
  StatsPartial tot{{0.0, 0.0, 0.0, 0.0, 0.0}, INFINITY, -INFINITY};
  for (int b = threadIdx.x; b < s.blocks; b += tit::kThreads) {
    const StatsPartial* q = &sc->stats[b];
#pragma unroll
    for (int k = 0; k < 5; ++k) tot.sum[k] += __ldcg(&q->sum[k]);
    tot.lmin = min_nan(tot.lmin, __ldcg(&q->lmin));
    tot.lmax = max_nan(tot.lmax, __ldcg(&q->lmax));
  }
  reduce_stats(tot, sh);
  if (threadIdx.x != 0) return;
  float fs[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) fs[k] = static_cast<float>(tot.sum[k]);
  if (lb != nullptr) {
    lb[0] = -tot.lmin;
    lb[1] = tot.lmax;
#pragma unroll
    for (int k = 0; k < 5; ++k) sums[k] = fs[k];
  } else {
    finalize(mm, tot.lmin, tot.lmax, fs, prev, t, n_total, v, out);
  }
}

// Launch 3 (a group): finalize from the all-reduced pair, log bounds and
// sums.
__global__ void finalize_kernel(const float* __restrict__ mm,
                                const float* __restrict__ lb,
                                const float* __restrict__ sums,
                                const float* __restrict__ prev,
                                const float* t_ptr, float t_val,
                                float* __restrict__ out, float n_total,
                                Vectors v) {
  finalize(mm, -lb[0], lb[1], sums, prev, read_t(t_ptr, t_val), n_total, v,
           out);
}

// The vectors alone from a given vec9 (metrics the caller holds): out =
// [scal (10) | lin (2)].
__global__ void vectors_kernel(const float* __restrict__ m, Vectors v,
                               float* __restrict__ out) {
  write_vectors(m, v, out, out + 10);
}

enum Phase { kBounds = 0, kStats = 1, kFinalize = 2 };

template <typename T>
int launch(const void* x, int n, int c, int hs, int ws, long long s0,
           long long s1, long long s2, long long s3, const void* prev,
           const void* t_ptr, float t, void* scratch, void* mm, void* lb,
           void* sums, void* out, float n_total, float intensity,
           float light_adapt, float color_adapt, int ca_mode, int phase,
           cudaStream_t stream) {
  const Vectors v{intensity, light_adapt, color_adapt, ca_mode};
  const auto* tp = static_cast<const float*>(t_ptr);
  if (phase == kFinalize) {
    finalize_kernel<<<1, 1, 0, stream>>>(
        static_cast<const float*>(mm), static_cast<const float*>(lb),
        static_cast<const float*>(sums), static_cast<const float*>(prev), tp,
        t, static_cast<float*>(out), n_total, v);
    return static_cast<int>(cudaGetLastError());
  }
  const long long pixels = static_cast<long long>(n) * hs * ws;
  if (pixels <= 0 || pixels > 0x7FFFFFFFLL || c < 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_block = static_cast<long long>(tit::kThreads) *
                              kPerThread;
  long long blocks = (pixels + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const long long chunk = (pixels + blocks - 1) / blocks;
  // the chunks may cover the pixels in fewer blocks than planned
  blocks = (pixels + chunk - 1) / chunk;
  const Sample s{c, hs, ws, s0, s1, s2, s3, pixels, chunk,
                 static_cast<int>(blocks)};
  const auto* xin = static_cast<const T*>(x);
  auto* sc = static_cast<Scratch*>(scratch);
  if (phase == kBounds) {
    bounds_kernel<T><<<s.blocks, tit::kThreads, 0, stream>>>(
        xin, s, sc, static_cast<float*>(mm));
  } else {
    stats_kernel<T><<<s.blocks, tit::kThreads, 0, stream>>>(
        xin, s, sc, static_cast<const float*>(mm),
        static_cast<const float*>(prev), tp, t, static_cast<float*>(lb),
        static_cast<float*>(sums), static_cast<float*>(out), n_total, v);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tit_meter_vectors(const void* metrics, float intensity,
                                 float light_adapt, float color_adapt,
                                 int ca_mode, void* out, cudaStream_t stream) {
  vectors_kernel<<<1, 1, 0, stream>>>(
      static_cast<const float*>(metrics),
      Vectors{intensity, light_adapt, color_adapt, ca_mode},
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

#define TIT_METER_LAUNCHER(suffix, T)                                        \
  extern "C" int tit_meter_##suffix(                                         \
      const void* x, int n, int c, int hs, int ws, long long s0,             \
      long long s1, long long s2, long long s3, const void* prev,            \
      const void* t_ptr, float t, void* scratch, void* mm, void* lb,         \
      void* sums, void* out, float n_total, float intensity,                 \
      float light_adapt, float color_adapt, int ca_mode, int phase,          \
      cudaStream_t stream) {                                                 \
    return launch<T>(x, n, c, hs, ws, s0, s1, s2, s3, prev, t_ptr, t,        \
                     scratch, mm, lb, sums, out, n_total, intensity,         \
                     light_adapt, color_adapt, ca_mode, phase, stream);      \
  }
TIT_FOR_EACH_DTYPE(TIT_METER_LAUNCHER)
