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
// 1.39 us at 3.35 TB/s; 2.79 us in f32). At that size what costs time is
// not the bytes but the launch and each serial step between the passes:
// the first design (two launches, a bounds pass and a stats pass, each
// ended by its last block's walk over ~380 partials) took 19.5-24.2 us of
// device time a step in bf16/f16 and 24.3-27.2 us in f32 on an NVIDIA H100
// 80GB HBM3 at 700 W. Design:
//   - one cooperative launch (cudaLaunchCooperativeKernel) without a
//     process group: pass 1 takes each block's min and max and publishes
//     them as two atomic order keys (min and max are exact, so integer
//     atomics give the same bits in any order); one grid barrier
//     (cooperative_groups' grid sync); every block reads the two keys, so
//     each holds the same b and no second barrier is needed; pass 2 takes
//     the log bounds and the five sums (in double) of the block's pixels;
//     the last block to count itself reduces the stats partials in block
//     order and finalizes (vec9 and the vectors);
//   - the grid is at most kMaxGrid blocks (kBlocksPerSm, held by
//     __launch_bounds__, on each of an H100 PCIe's 114 SMs); the wrapper
//     takes this launch only where the plan's grid is co-resident on the
//     device (kBlocksPerSm on each of its SMs: every plan on a whole
//     H100), and runs the split form below on a device with fewer SMs
//     (a MIG slice); the launcher checks the grid against the device's
//     SMs and the occupancy calculator, asked once a device, so a grid
//     that cannot be co-resident is an error, never a hang;
//   - a run is one 16-byte vector of a row of each channel (8 bf16/f16
//     pixels or 4 f32); a block owns consecutive runs and thread t the
//     block's runs t, t + kThreads, ..., walked without a division: (x,
//     y) and the address advance by constants from the run the thread
//     starts at. A run of a row whose address is 16-byte aligned (unit
//     column stride) is one vector load a channel; any other run (a
//     strided view, a gather, a row's ragged end, an unaligned view) loads
//     the same pixels one at a time, in the same order;
//   - pass 2 reads the block's runs from shared memory where they fit
//     (kCacheBytes: pass 1 stores each run's words there; the 6x4K
//     samples), else again from device memory (the 6x8K whole frame's);
//   - the partition (ops/hopper/meter.py plan: runs a block, blocks) is a
//     function of the logical shape and the dtype alone (the strides and
//     the data pointer move only the addresses and pick the loads), so a
//     strided view and its contiguous copy give the same bits, and so do
//     the whole frame's sample and the band loop's joined one.
// The split form: under a process group the phases stay separate
// launches, since a collective cannot run inside a kernel: bounds (pass
// 1, the last block writes [-min, max], the pair an all_reduce MAX
// reduces), stats (pass 2 from device memory, the last block writes this
// rank's [-lmin, lmax] and f32 sums for the two all_reduce calls), then a
// one-thread finalize: the same partition, reductions and finalize, so
// one rank is bitwise no group, and so is the split form without a group
// (the same three launches with no all_reduce between them), which a
// device that cannot hold the plan's grid at once runs. No float
// atomics: the counters and keys are integers, and each launch leaves
// them at 0, so no memset runs.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py's
// profiler traces; PERF.md section 6): 10.2-13.5 us a launch at the 6x4K
// sample in bf16/f16 and 15.1-15.2 us in f32, 15.5-18.0 us inside the
// step (the two launches before: 23.2-24.8 us), 36 us at the 6x8K whole
// frame's sample (was 52). Where a bf16 6x4K launch goes
// (tools/torch_meter_stages.py): pass 1 3.2 us, the grid barrier 1.4, the
// bounds read 0.3, pass 2 4.2 (its arithmetic: three true divisions, a
// logf and five f64 sums a pixel), the block reductions 0.9, the last
// block's count 0.7 and its reduction 1.2, finalize 0.7.
//
// Bitwise with the twin's f32 ops: the bounds and the log bounds (min and
// max are exact; scaled is a true division, gray is summed left to right
// with no FMA under --fmad=false, log is logf), within rounding the sums
// and the means (another order). A NaN in the sample makes the bounds NaN,
// as amin/amax do (a flag beside fminf/fmaxf, which drop it). The vectors
// use powf and expf, as torch.pow and torch.exp compute them on the card.
#include <cooperative_groups.h>
#include <cuda/atomic>

#include <cmath>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

// ops/hopper/meter.py's plan constants: the grid's cap (BLOCKS_PER_SM on
// each of PLAN_SMS SMs), the blocks of it each SM must hold, the shared
// memory a block may keep its runs in
constexpr int kMaxGrid = TIT_METER_MAX_GRID;
constexpr int kBlocksPerSm = TIT_METER_BLOCKS_PER_SM;
constexpr int kCacheBytes = TIT_METER_CACHE_BYTES;
static_assert(TIT_METER_THREADS == tit::kThreads, "meter.py THREADS");
constexpr int kWarps = tit::kThreads / 32;

template <typename T>
constexpr int kRun = 16 / static_cast<int>(sizeof(T));  // pixels of a run

struct MinMax {
  float mn, mx;  // NaN in both where a value was NaN
};

struct StatsPartial {
  double sum[5];  // log_gray, gray, r, g, b
  float lmin, lmax;
};

// The per-device, per-stream scratch (ops/hopper/meter.py allocates it
// zeroed once): the block counters of the bounds and stats phases, the
// sample's bounds as two atomic keys (publish_bounds), then the blocks' stats
// partials. Each launch leaves the counters and keys at 0.
struct Scratch {
  unsigned count[2];
  unsigned keys[2];
  unsigned pad[12];
  StatsPartial stats[kMaxGrid];
};
static_assert(sizeof(StatsPartial) == 48 &&
                  sizeof(Scratch) == 64 + kMaxGrid * 48,
              "ops/hopper/meter.py SCRATCH_BYTES");

// The host's launch block (ops/hopper/meter.py _launch_block): the shape,
// the strides in elements and the plan.
struct Launch {
  long long n, c, hs, ws, s0, s1, s2, s3, per_block, grid, cached;
};

// What the kernels walk: the shape, the plan, and the address steps of a
// thread's walk (kThreads runs on: dx runs along the row, dy rows and dn
// images, with a carry into the next row and image).
struct Geometry {
  long long s1, s3;
  long long x_step;  // dx runs along a row: dx run s3
  long long x_wrap;  // run rpr of a row to run 0 of the next: s2 - rpr run s3
  long long y_step;  // dy rows and dn images: dy s2 + dn s0
  long long y_wrap;  // row hs of an image to row 0 of the next: s0 - hs s2
  long long s0, s2;
  int c, hs;
  int rpr, last;        // runs of a row, pixels of its last run
  int runs, per_block;  // runs of the sample, of a block
  int blocks, dx, dy;
  int vec;     // unit column stride and 16-byte channel planes
  int cached;  // pass 2 reads the block's runs from shared memory
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

__device__ __forceinline__ void combine(MinMax& a, const MinMax& b) {
  a.mn = min_nan(a.mn, b.mn);
  a.mx = max_nan(a.mx, b.mx);
}
__device__ __forceinline__ void combine(StatsPartial& a,
                                        const StatsPartial& b) {
#pragma unroll
  for (int k = 0; k < 5; ++k) a.sum[k] += b.sum[k];
  a.lmin = min_nan(a.lmin, b.lmin);
  a.lmax = max_nan(a.lmax, b.lmax);
}

__device__ __forceinline__ MinMax shfl_xor(const MinMax& v, int off) {
  return MinMax{__shfl_xor_sync(0xffffffffu, v.mn, off),
                __shfl_xor_sync(0xffffffffu, v.mx, off)};
}
__device__ __forceinline__ StatsPartial shfl_xor(const StatsPartial& v,
                                                 int off) {
  StatsPartial r;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    r.sum[k] = __shfl_xor_sync(0xffffffffu, v.sum[k], off);
  }
  r.lmin = __shfl_xor_sync(0xffffffffu, v.lmin, off);
  r.lmax = __shfl_xor_sync(0xffffffffu, v.lmax, off);
  return r;
}

__device__ __forceinline__ MinMax identity(MinMax) {
  return MinMax{INFINITY, -INFINITY};
}
__device__ __forceinline__ StatsPartial identity(StatsPartial) {
  return StatsPartial{{0.0, 0.0, 0.0, 0.0, 0.0}, INFINITY, -INFINITY};
}

// A block reduction of one partial per thread in a fixed order: a
// butterfly in each warp, then warp 0 over the warps' results. Thread 0
// gets the result. `sh` holds kWarps partials; the call begins and ends
// with a barrier of the whole block (so it may reuse `sh`).
template <typename P>
__device__ P block_reduce(P v, P* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) combine(v, shfl_xor(v, off));
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sh[lane] : identity(v);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) combine(v, shfl_xor(v, off));
  }
  return v;
}

// A partial written by another block, read past L1.
__device__ __forceinline__ StatsPartial load_cg(const StatsPartial* p) {
  StatsPartial v;
#pragma unroll
  for (int k = 0; k < 5; ++k) v.sum[k] = __ldcg(&p->sum[k]);
  v.lmin = __ldcg(&p->lmin);
  v.lmax = __ldcg(&p->lmax);
  return v;
}

// The stats partials of blocks 0 .. n-1 (n <= kMaxGrid) reduced in block
// order: thread t combines partials t, t + kThreads, ..., every one loaded
// before the first is combined, then block_reduce. Thread 0 gets the
// result.
__device__ StatsPartial reduce_stats(const StatsPartial* parts, int n,
                                     StatsPartial* sh) {
  constexpr int kPer = (kMaxGrid + tit::kThreads - 1) / tit::kThreads;
  StatsPartial p[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int b = threadIdx.x + i * tit::kThreads;
    p[i] = b < n ? load_cg(&parts[b]) : identity(StatsPartial{});
  }
  StatsPartial v = identity(StatsPartial{});
#pragma unroll
  for (int i = 0; i < kPer; ++i) combine(v, p[i]);
  return block_reduce(v, sh);
}

// The sample's bounds across blocks without a pass over partials: min
// and max are exact, so integer atomics on order-preserving keys give the
// same bits in any order. key(a) < key(b) where a < b (-0 below +0); the
// min is kept as ~key, so that both words take atomicMax from 0; a NaN
// takes the largest word, so a NaN anywhere makes the bound NaN (amin /
// amax semantics). Thread 0 of each block publishes its block's bounds.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}
__device__ __forceinline__ void publish_bounds(Scratch* sc, MinMax mm) {
  atomicMax(&sc->keys[0], mm.mn != mm.mn ? 0xFFFFFFFFu : ~order_key(mm.mn));
  atomicMax(&sc->keys[1], mm.mx != mm.mx ? 0xFFFFFFFFu : order_key(mm.mx));
}
__device__ __forceinline__ MinMax read_bounds(const Scratch* sc) {
  const unsigned kn = __ldcg(&sc->keys[0]), kx = __ldcg(&sc->keys[1]);
  return MinMax{kn == 0xFFFFFFFFu ? NAN : from_key(~kn),
                kx == 0xFFFFFFFFu ? NAN : from_key(kx)};
}

// Whether this block is the last of `blocks` to finish: thread 0 counts
// it with an acquire-release add (which publishes the partial thread 0
// wrote and, in the last block, makes every other block's visible; a
// __threadfence before a plain add was slower on the card), every thread
// learns the answer. The last block resets the counter for the next
// launch.
__device__ bool last_block(unsigned* count, int blocks) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> c(*count);
    last = c.fetch_add(1u, cuda::memory_order_acq_rel) ==
           static_cast<unsigned>(blocks - 1);
    if (last) c.store(0u, cuda::memory_order_relaxed);
  }
  __syncthreads();
  return last;
}

// ------------------------------------------------------------- the walk

// A thread's position: run x of row y of its image, and the offset in
// elements of the run's first pixel in channel 0.
struct Cursor {
  int x, y;
  long long off;
};

// The cursor at run r (one division each: once a thread, not a pixel).
template <typename T>
__device__ __forceinline__ Cursor cursor_at(const Geometry& g, int r) {
  const int row = r / g.rpr;
  const int n = row / g.hs;
  Cursor c;
  c.x = r - row * g.rpr;
  c.y = row - n * g.hs;
  c.off = n * g.s0 + c.y * g.s2 + static_cast<long long>(c.x) * kRun<T> * g.s3;
  return c;
}

// kThreads runs on, with a carry into the next row and image.
__device__ __forceinline__ void advance(const Geometry& g, Cursor& c) {
  c.x += g.dx;
  c.off += g.x_step;
  if (c.x >= g.rpr) {
    c.x -= g.rpr;
    c.off += g.x_wrap;
    ++c.y;
  }
  c.y += g.dy;
  c.off += g.y_step;
  if (c.y >= g.hs) {
    c.y -= g.hs;
    c.off += g.y_wrap;
  }
}

template <typename T>
__device__ __forceinline__ int run_len(const Geometry& g, const Cursor& c) {
  return c.x == g.rpr - 1 ? g.last : kRun<T>;
}

__device__ __forceinline__ unsigned bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ unsigned bits(__half v) {
  return __half_as_ushort(v);
}
__device__ __forceinline__ unsigned bits(float v) { return __float_as_uint(v); }

// The len pixels of a run of one channel at p as the words a 16-byte load
// gives (unused lanes 0): one vector load, or one load a pixel.
template <typename T>
__device__ __forceinline__ void load_run(const T* p, long long s3, int len,
                                         bool vec, unsigned (&w)[4]) {
  if (vec) {
    tit::Run<T, kRun<T>>::load_words(p, w);
    return;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) w[m] = 0u;
#pragma unroll
  for (int k = 0; k < kRun<T>; ++k) {
    if (k < len) {
      const unsigned b = bits(p[k * s3]);
      if constexpr (sizeof(T) == 4) {
        w[k] = b;
      } else {
        w[k >> 1] |= b << (16 * (k & 1));
      }
    }
  }
}

// Pixel k of a run's words, exactly as f32 (Run::unpack's lane k).
template <typename T>
__device__ __forceinline__ float lane(const unsigned (&w)[4], int k) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[k]);
  } else if constexpr (std::is_same_v<T, __half>) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(
        (k & 1) ? (w[k >> 1] >> 16) : (w[k >> 1] & 0xFFFFu))));
  } else {
    return __uint_as_float((k & 1) ? (w[k >> 1] & 0xFFFF0000u)
                                   : (w[k >> 1] << 16));
  }
}

template <typename T>
__device__ __forceinline__ bool vector_run(const Geometry& g, const T* p,
                                           int len) {
  return g.vec && len == kRun<T> && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// This block's runs [r0, r1) and thread t's count of them.
struct Share {
  int r0, count;
};

__device__ __forceinline__ Share share_of(const Geometry& g) {
  const int r0 = blockIdx.x * g.per_block;
  const int r1 = min(g.runs, r0 + g.per_block);
  const int t = threadIdx.x;
  return Share{r0, r0 + t < r1 ? (r1 - r0 - t + tit::kThreads - 1) /
                                     tit::kThreads
                               : 0};
}

// ------------------------------------------------------------- the passes

// Folds the len pixels of a run's words into a running min and max, with
// a flag for NaN beside fminf/fmaxf, which drop it.
template <typename T>
__device__ __forceinline__ void bound_run(const unsigned (&w)[4], int len,
                                          float& mn, float& mx, bool& nan) {
#pragma unroll
  for (int k = 0; k < kRun<T>; ++k) {
    if (k < len) {
      const float v = lane<T>(w, k);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
      nan |= v != v;
    }
  }
}

// Pass 1: the min and max of the thread's runs over every channel (NaN if
// any value is); with `cache`, each run's words of channels 0-2 stored at
// cache[c * per_block + (run - r0)].
template <typename T>
__device__ MinMax bounds_pass(const T* __restrict__ x, const Geometry& g,
                              const Share& sh, uint4* cache) {
  float mn = INFINITY, mx = -INFINITY;
  bool nan = false;
  if (sh.count == 0) return MinMax{mn, mx};
  Cursor cur = cursor_at<T>(g, sh.r0 + threadIdx.x);
  for (int i = 0; i < sh.count; ++i) {
    const int len = run_len<T>(g, cur);
    const bool vec = vector_run(g, x + cur.off, len);
    unsigned w[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      load_run(x + cur.off + c * g.s1, g.s3, len, vec, w[c]);
    }
    if (cache != nullptr) {
      const int slot = threadIdx.x + i * tit::kThreads;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        cache[c * g.per_block + slot] =
            make_uint4(w[c][0], w[c][1], w[c][2], w[c][3]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) bound_run<T>(w[c], len, mn, mx, nan);
    for (int c = 3; c < g.c; ++c) {  // channels the stats do not read
      unsigned e[4];
      load_run(x + cur.off + c * g.s1, g.s3, len, vec, e);
      bound_run<T>(e, len, mn, mx, nan);
    }
    advance(g, cur);
  }
  return nan ? MinMax{NAN, NAN} : MinMax{mn, mx};
}

struct Norm {
  float b0, den;
};

__device__ __forceinline__ Norm norm_of(float mn, float mx,
                                        const float* prev, float t) {
  const float b0 = lerp(t, mn, prev[0]);
  const float b1 = lerp(t, mx, prev[1]);
  return Norm{b0, (b1 - b0) + 1e-6f};
}

// Pass 2: the log bounds and the five sums of the thread's runs, pixel by
// pixel in run order, from `cache` (pass 1's words) or device memory.
template <typename T>
__device__ StatsPartial stats_pass(const T* __restrict__ x,
                                   const Geometry& g, const Share& sh,
                                   const uint4* cache, Norm nm) {
  StatsPartial st = identity(StatsPartial{});
  if (sh.count == 0) return st;
  bool nan = false;
  Cursor cur = cursor_at<T>(g, sh.r0 + threadIdx.x);
  for (int i = 0; i < sh.count; ++i) {
    const int len = run_len<T>(g, cur);
    unsigned w[3][4];
    if (cache != nullptr) {
      const int slot = threadIdx.x + i * tit::kThreads;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const uint4 q = cache[c * g.per_block + slot];
        w[c][0] = q.x;
        w[c][1] = q.y;
        w[c][2] = q.z;
        w[c][3] = q.w;
      }
    } else {
      const bool vec = vector_run(g, x + cur.off, len);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        load_run(x + cur.off + c * g.s1, g.s3, len, vec, w[c]);
      }
    }
#pragma unroll
    for (int k = 0; k < kRun<T>; ++k) {
      if (k < len) {
        float s[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          s[c] = tit::div_rn_keep_zero(lane<T>(w[c], k) - nm.b0, nm.den);
        }
        const float gray = 0.299f * s[0] + 0.587f * s[1] + 0.114f * s[2];
        const float lg = logf(gray < 1e-4f ? 1e-4f : gray);  // NaN stays
        st.sum[0] += lg;
        st.sum[1] += gray;
#pragma unroll
        for (int c = 0; c < 3; ++c) st.sum[2 + c] += s[c];
        st.lmin = fminf(st.lmin, lg);
        st.lmax = fmaxf(st.lmax, lg);
        nan |= lg != lg;
      }
    }
    advance(g, cur);
  }
  if (nan) st.lmin = st.lmax = NAN;
  return st;
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
// the sample's min and max, the log bounds and the five f32 sums: the one
// finalize of the grouped and ungrouped paths, so that a one-rank group
// gives the same bits as no group.
__device__ void finalize(float mn, float mx, float lmin, float lmax,
                         const float* sums, const float* prev, float t,
                         float n_total, const Vectors& v, float* out) {
  float stats[9];
  stats[0] = lerp(t, mn, prev[0]);
  stats[1] = lerp(t, mx, prev[1]);
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

__device__ __forceinline__ void round_sums(const StatsPartial& tot,
                                           float (&fs)[5]) {
#pragma unroll
  for (int k = 0; k < 5; ++k) fs[k] = static_cast<float>(tot.sum[k]);
}

// ------------------------------------------------------------- the kernels

// The metering without a group: one cooperative launch of g.blocks blocks.
template <typename T>
__global__ void __launch_bounds__(tit::kThreads, kBlocksPerSm)
    meter_kernel(const T* __restrict__ x, Geometry g, Scratch* sc,
                 const float* __restrict__ prev, const float* t_ptr,
                 float t_val, float* __restrict__ out, float n_total,
                 Vectors v) {
  extern __shared__ uint4 cache[];
  __shared__ MinMax sh_mm[kWarps];
  __shared__ StatsPartial sh_st[kWarps];
  __shared__ MinMax grid_mm;
  uint4* runs = g.cached ? cache : nullptr;
  const Share sh = share_of(g);
  MinMax mm = block_reduce(bounds_pass(x, g, sh, runs), sh_mm);
  if (threadIdx.x == 0) publish_bounds(sc, mm);
  cg::this_grid().sync();
  if (threadIdx.x == 0) grid_mm = read_bounds(sc);
  __syncthreads();
  mm = grid_mm;
  const float t = read_t(t_ptr, t_val);
  const StatsPartial st = block_reduce(
      stats_pass(x, g, sh, runs, norm_of(mm.mn, mm.mx, prev, t)), sh_st);
  if (threadIdx.x == 0) sc->stats[blockIdx.x] = st;
  if (!last_block(&sc->count[1], g.blocks)) return;
  // every block has read the bounds before it counted itself
  if (threadIdx.x == 0) sc->keys[0] = sc->keys[1] = 0u;
  const StatsPartial tot = reduce_stats(sc->stats, g.blocks, sh_st);
  if (threadIdx.x != 0) return;
  float fs[5];
  round_sums(tot, fs);
  finalize(mm.mn, mm.mx, tot.lmin, tot.lmax, fs, prev, t, n_total, v, out);
}

// A group's phase 1: [-min, max] over every value of this rank's sample.
template <typename T>
__global__ void __launch_bounds__(tit::kThreads, kBlocksPerSm)
    bounds_kernel(const T* __restrict__ x, Geometry g, Scratch* sc,
                  float* __restrict__ mm_out) {
  __shared__ MinMax sh_mm[kWarps];
  const MinMax mm = block_reduce(bounds_pass(x, g, share_of(g), nullptr),
                                 sh_mm);
  if (threadIdx.x == 0) publish_bounds(sc, mm);
  if (!last_block(&sc->count[0], g.blocks) || threadIdx.x != 0) return;
  const MinMax tot = read_bounds(sc);
  sc->keys[0] = sc->keys[1] = 0u;
  mm_out[0] = -tot.mn;
  mm_out[1] = tot.mx;
}

// A group's phase 2: this rank's [-lmin, lmax] and f32 sums over the
// bounds the group reduced (mm).
template <typename T>
__global__ void __launch_bounds__(tit::kThreads, kBlocksPerSm)
    stats_kernel(const T* __restrict__ x, Geometry g, Scratch* sc,
                 const float* __restrict__ mm, const float* __restrict__ prev,
                 const float* t_ptr, float t_val, float* __restrict__ lb,
                 float* __restrict__ sums) {
  __shared__ StatsPartial sh_st[kWarps];
  const Norm nm = norm_of(-mm[0], mm[1], prev, read_t(t_ptr, t_val));
  const StatsPartial st = block_reduce(
      stats_pass(x, g, share_of(g), nullptr, nm), sh_st);
  if (threadIdx.x == 0) sc->stats[blockIdx.x] = st;
  if (!last_block(&sc->count[1], g.blocks)) return;
  const StatsPartial tot = reduce_stats(sc->stats, g.blocks, sh_st);
  if (threadIdx.x != 0) return;
  float fs[5];
  round_sums(tot, fs);
  lb[0] = -tot.lmin;
  lb[1] = tot.lmax;
#pragma unroll
  for (int k = 0; k < 5; ++k) sums[k] = fs[k];
}

// A group's phase 3: finalize from the all-reduced pair, log bounds and
// sums.
__global__ void finalize_kernel(const float* __restrict__ mm,
                                const float* __restrict__ lb,
                                const float* __restrict__ sums,
                                const float* __restrict__ prev,
                                const float* t_ptr, float t_val,
                                float* __restrict__ out, float n_total,
                                Vectors v) {
  finalize(-mm[0], mm[1], -lb[0], lb[1], sums, prev, read_t(t_ptr, t_val),
           n_total, v, out);
}

// The vectors alone from a given vec9 (metrics the caller holds): out =
// [scal (10) | lin (2)].
__global__ void vectors_kernel(const float* __restrict__ m, Vectors v,
                               float* __restrict__ out) {
  write_vectors(m, v, out, out + 10);
}

// ------------------------------------------------------------- the launcher

enum Phase { kFused = 0, kBounds = 1, kStats = 2, kFinalize = 3 };

// The kernels' geometry from the host's launch block, or false where the
// block is not a plan of this shape (ops/hopper/meter.py plan) for T.
template <typename T>
bool geometry(const Launch& l, Geometry& g) {
  if (l.n < 1 || l.c < 3 || l.hs < 1 || l.ws < 1) return false;
  const long long rpr = (l.ws + kRun<T> - 1) / kRun<T>;
  const long long runs = l.n * l.hs * rpr;
  if (l.n * l.hs * l.ws > 0x7FFFFFFFLL || l.per_block < 1 || l.grid < 1 ||
      l.grid > kMaxGrid || (l.grid - 1) * l.per_block >= runs ||
      l.grid * l.per_block < runs ||
      (l.cached && 3 * l.per_block * 16 > kCacheBytes)) {
    return false;
  }
  const long long rows = tit::kThreads / rpr;  // kThreads runs on
  const long long dx = tit::kThreads % rpr, dy = rows % l.hs,
                  dn = rows / l.hs;
  g.s1 = l.s1;
  g.s3 = l.s3;
  g.x_step = dx * kRun<T> * l.s3;
  g.x_wrap = l.s2 - rpr * kRun<T> * l.s3;
  g.y_step = dy * l.s2 + dn * l.s0;
  g.y_wrap = l.s0 - l.hs * l.s2;
  g.s0 = l.s0;
  g.s2 = l.s2;
  g.c = static_cast<int>(l.c);
  g.hs = static_cast<int>(l.hs);
  g.rpr = static_cast<int>(rpr);
  g.last = static_cast<int>(l.ws - (rpr - 1) * kRun<T>);
  g.runs = static_cast<int>(runs);
  g.per_block = static_cast<int>(l.per_block);
  g.blocks = static_cast<int>(l.grid);
  g.dx = static_cast<int>(dx);
  g.dy = static_cast<int>(dy);
  g.vec = l.s3 == 1 && (l.s1 * static_cast<long long>(sizeof(T))) % 16 == 0;
  g.cached = static_cast<int>(l.cached != 0);
  return true;
}

// Whether `blocks` blocks of meter_kernel<T>, with its largest shared
// memory, are co-resident on the current device (its SMs x the blocks an
// SM holds, asked once a device ordinal): cudaSuccess, the query's error
// or cudaErrorCooperativeLaunchTooLarge. The wrapper runs the split form
// wherever the grid exceeds kBlocksPerSm on each of the device's SMs, so
// it never meets this error.
template <typename T>
cudaError_t co_resident(int blocks) {
  static tit::PerDevice resident;
  int most = 0;
  const cudaError_t e = tit::resident_blocks(meter_kernel<T>, tit::kThreads,
                                             kCacheBytes, resident, most);
  if (e != cudaSuccess) return e;
  return blocks <= most ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
}

template <typename T>
int launch(const void* x, const void* launch_block, const void* prev,
           const void* t_ptr, float t, void* scratch, void* mm, void* lb,
           void* sums, void* out, float n_total, float intensity,
           float light_adapt, float color_adapt, int ca_mode, int phase,
           cudaStream_t stream) {
  Vectors v{intensity, light_adapt, color_adapt, ca_mode};
  const auto* tp = static_cast<const float*>(t_ptr);
  const auto* pv = static_cast<const float*>(prev);
  auto* o = static_cast<float*>(out);
  if (phase == kFinalize) {
    finalize_kernel<<<1, 1, 0, stream>>>(
        static_cast<const float*>(mm), static_cast<const float*>(lb),
        static_cast<const float*>(sums), pv, tp, t, o, n_total, v);
    return static_cast<int>(cudaGetLastError());
  }
  Geometry g;
  if (!geometry<T>(*static_cast<const Launch*>(launch_block), g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xin = static_cast<const T*>(x);
  auto* sc = static_cast<Scratch*>(scratch);
  if (phase == kFused) {
    const cudaError_t fits = co_resident<T>(g.blocks);
    if (fits != cudaSuccess) return static_cast<int>(fits);
    void* args[] = {&xin, &g, &sc, &pv, &tp, &t, &o, &n_total, &v};
    const size_t smem = g.cached ? 3 * g.per_block * sizeof(uint4) : 0;
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(meter_kernel<T>), dim3(g.blocks),
        dim3(tit::kThreads), args, smem, stream));
  }
  if (phase == kBounds) {
    bounds_kernel<T><<<g.blocks, tit::kThreads, 0, stream>>>(
        xin, g, sc, static_cast<float*>(mm));
  } else if (phase == kStats) {
    stats_kernel<T><<<g.blocks, tit::kThreads, 0, stream>>>(
        xin, g, sc, static_cast<const float*>(mm), pv, tp, t,
        static_cast<float*>(lb), static_cast<float*>(sums));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
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
      const void* x, const void* launch_block, const void* prev,             \
      const void* t_ptr, float t, void* scratch, void* mm, void* lb,         \
      void* sums, void* out, float n_total, float intensity,                 \
      float light_adapt, float color_adapt, int ca_mode, int phase,          \
      cudaStream_t stream) {                                                 \
    return launch<T>(x, launch_block, prev, t_ptr, t, scratch, mm, lb, sums, \
                     out, n_total, intensity, light_adapt, color_adapt,      \
                     ca_mode, phase, stream);                                \
  }
TIT_FOR_EACH_DTYPE(TIT_METER_LAUNCHER)
