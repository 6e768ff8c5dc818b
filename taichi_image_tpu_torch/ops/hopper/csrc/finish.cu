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
// Bound: memory, 12 * sizeof(T) bytes read and 12 bytes written per
// half-res pixel (0.134 ms for 6 x 4K bf16 at 3.35 TB/s), as long as the
// per-element work stays small: a Reinhard division that leaves its fast
// path (a zero dividend does, and dark or clipped frames are full of
// zeros) costs a subroutine call, so a zero divides 1 instead and is kept
// as it is. Each thread takes kV = 8 consecutive half-res pixels of one
// row of one colour: one or two 16-byte loads from each of its 4 phase
// planes, the per-image scalar read once, 4 x kV bytes out. Input
// (y, x) = (2i + pr, 2j + pc) comes from channel pc*6 + pr*3 + c. The grid
// is (column runs, rows, n * 3), so all indexing is 32-bit within a plane,
// with no division per pixel.
//   - No axis swap: each output row of the run is 2 kV = 16 interleaved
//     bytes, one 16-byte store (a half-warp writes 256 contiguous bytes).
//     flip_y moves the row; flip_x mirrors the vector's position and
//     reverses its bytes in registers (__byte_perm).
//   - Axis swap (transpose, rotate_90, rotate_270, transverse): a warp
//     takes 32 rows of one column run. The block stages its 32 x 64
//     input pixels of the 4 planes in shared memory with coalesced
//     16-byte loads (a lane per row reading device memory directly would
//     touch 32 rows per load), and its 128 x 64-byte output tile goes
//     back through shared memory, [x][y] as byte pairs, so that each
//     output row x' leaves as 64 contiguous bytes in 16-byte stores
//     (flip_y reverses each vector and mirrors its position).
// A row that is not a whole number of runs, an output side that is not a
// whole number of vectors, or a plane that is not 16-byte aligned takes
// the element-by-element loads and byte stores of the same kernel (the
// launcher picks `vec` from the sizes and pointers).
//
// The division is a true IEEE division and the u8 convert truncates
// toward zero (XLA's f32->u8 convert, camera_isp.py:1106); fmaxf maps a
// NaN (log2 of a negative p at gamma != 1) to 0.
#include "common.cuh"

namespace {

constexpr int kV = 8;          // half-res pixels per thread
constexpr int kSwapRows = 32;  // half-res rows of a swapped tile (a warp)
constexpr int kSwapRuns = 8;   // column runs of a swapped tile (warps)

struct Finish {
  int hh, wh, apply_gamma, flip_y, flip_x, vec;
  float inv_gamma;
};

// The per-image scalars a run needs: max(1e-6, max_out[b]), or [m0,
// inv_range].
struct Scal {
  float mx, m0, inv_range;
};

template <bool kLinear>
__device__ __forceinline__ Scal load_scal(const float* __restrict__ scal,
                                          int b) {
  return kLinear ? Scal{0.0f, scal[0], scal[1]}
                 : Scal{fmaxf(1e-6f, scal[b]), 0.0f, 0.0f};
}

template <bool kLinear>
__device__ __forceinline__ unsigned tone_u8(float xv, const Scal& sc,
                                            const Finish& f) {
  float s;
  if (kLinear) {
    float y = fmaxf((xv - sc.m0) * sc.inv_range, 0.0f);
    if (f.apply_gamma) y = exp2f(log2f(y) * f.inv_gamma);
    s = fminf(fmaxf(fminf(fmaxf(y, 0.0f), 1.0f) * 255.0f, 0.0f), 255.0f);
  } else {
    // mx >= 1e-6, so a zero p keeps off the division's slow path
    float o = tit::div_rn_keep_zero(xv, sc.mx);
    if (f.apply_gamma) o = exp2f(log2f(o) * f.inv_gamma);
    s = fminf(fmaxf(255.0f * o, 0.0f), 255.0f);
  }
  return __float2uint_rz(s);
}

// The bytes q[pr][pc][k] of one run of kV pixels; src[pr * 2 + pc] is the
// run's first element in the plane of input phase (pr, pc). With `vec`
// each plane is read in 16-byte vectors, else element by element up to n
// elements (the rest are 0).
template <typename T, bool kLinear>
__device__ __forceinline__ void finish_run(const T* const src[4], bool vec,
                                           int n, const Scal& sc,
                                           const Finish& f,
                                           unsigned q[2][2][kV]) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte vector
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
    for (int pc = 0; pc < 2; ++pc) {
      const T* p = src[pr * 2 + pc];
      float v[kV];
      if (vec) {
#pragma unroll
        for (int h = 0; h < kV / kPer; ++h) {
          tit::Run<T, kPer>::load(p + h * kPer, v + h * kPer);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kV; ++k) {
          v[k] = k < n ? tit::load_f32(p[k]) : 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        q[pr][pc][k] = tone_u8<kLinear>(v[k], sc, f);
      }
    }
  }
}

// The run's four planes in device memory: input (y, x) = (2i + pr,
// 2j + pc) comes from channel pc*6 + pr*3 + c.
template <typename T>
__device__ __forceinline__ void run_planes(const T* __restrict__ x, int b,
                                           int c, int i, int j0,
                                           const Finish& f,
                                           const T* src[4]) {
  const int plane = f.hh * f.wh;
  const T* xb = x + static_cast<size_t>(b) * 12 * plane + i * f.wh + j0;
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
    for (int pc = 0; pc < 2; ++pc) {
      src[pr * 2 + pc] = xb + (pc * 6 + pr * 3 + c) * plane;
    }
  }
}

__device__ __forceinline__ uint4 reverse_bytes(uint4 v) {
  return make_uint4(__byte_perm(v.w, 0, 0x0123), __byte_perm(v.z, 0, 0x0123),
                    __byte_perm(v.y, 0, 0x0123), __byte_perm(v.x, 0, 0x0123));
}

// No axis swap: block (16, 16) over (runs, rows).
template <typename T, bool kLinear>
__global__ void __launch_bounds__(256)
    finish_rows_kernel(const T* __restrict__ x,
                       const float* __restrict__ scal,
                       uint8_t* __restrict__ out, Finish f) {
  const int bc = blockIdx.z, b = bc / 3, c = bc - 3 * b;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * kV;
  if (i >= f.hh || j0 >= f.wh) return;
  unsigned q[2][2][kV];
  const T* src[4];
  run_planes(x, b, c, i, j0, f, src);
  finish_run<T, kLinear>(src, f.vec, f.wh - j0, load_scal<kLinear>(scal, b),
                         f, q);
  const int h = 2 * f.hh, w = 2 * f.wh;
  uint8_t* ob = out + static_cast<size_t>(bc) * h * w;
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    const int y = 2 * i + pr;
    uint8_t* row = ob + (f.flip_y ? h - 1 - y : y) * w;
    if (f.vec) {
      // bytes x = 2 j0 .. 2 j0 + 16 in order: (k, pc) = (0,0), (0,1), ...
      unsigned wd[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        wd[m] = q[pr][0][2 * m] | q[pr][1][2 * m] << 8 |
                q[pr][0][2 * m + 1] << 16 | q[pr][1][2 * m + 1] << 24;
      }
      const uint4 v = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      if (f.flip_x) {
        *reinterpret_cast<uint4*>(row + w - 2 * j0 - 2 * kV) =
            reverse_bytes(v);
      } else {
        *reinterpret_cast<uint4*>(row + 2 * j0) = v;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        if (j0 + k >= f.wh) break;
#pragma unroll
        for (int pc = 0; pc < 2; ++pc) {
          const int xx = 2 * (j0 + k) + pc;
          row[f.flip_x ? w - 1 - xx : xx] =
              static_cast<uint8_t>(q[pr][pc][k]);
        }
      }
    }
  }
}

// Axis swap: block (32, 8), a warp per column run, a lane per row. With
// `vec` the block first stages its 32 rows x 64 columns of the 4 planes in
// shared memory with coalesced 16-byte loads (rows padded by 16 bytes, so
// the lanes' reads of 32 rows fall in distinct banks); the output tile of
// 2 * 8 * kV rows x' by 2 * 32 bytes y goes through shared memory too.
template <typename T, bool kLinear>
__global__ void __launch_bounds__(256)
    finish_swap_kernel(const T* __restrict__ x,
                       const float* __restrict__ scal,
                       uint8_t* __restrict__ out, Finish f) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kTileW = kSwapRuns * kV;      // half-res columns of a tile
  constexpr int kPitch = kTileW + kPer;       // staged row, padded
  constexpr int kTileX = 2 * kTileW;          // output rows x' of a tile
  __shared__ alignas(16) T xs[4][kSwapRows][kPitch];
  // s[x][i]: bytes (y = 2i, 2i + 1) of output row x, tile-local
  __shared__ alignas(16) uint16_t s[kTileX][kSwapRows];
  const int bc = blockIdx.z, b = bc / 3, c = bc - 3 * b;
  const int i0 = blockIdx.y * kSwapRows, jt = blockIdx.x * kTileW;
  const int i = i0 + threadIdx.x;
  const int j0 = jt + threadIdx.y * kV;
  const int tid = threadIdx.y * kSwapRows + threadIdx.x;
  unsigned q[2][2][kV] = {};
  if (f.vec) {
    const int plane = f.hh * f.wh;
    const T* xb = x + static_cast<size_t>(b) * 12 * plane;
    constexpr int kCopies = kTileW / kPer;    // 16-byte copies of a row
#pragma unroll
    for (int k = tid; k < 4 * kSwapRows * kCopies; k += 256) {
      const int row = k / kCopies, cv = k - row * kCopies;  // pp * 32 + r
      const int pp = row / kSwapRows, r = row - pp * kSwapRows;
      const int y = i0 + r, xc = jt + cv * kPer;
      if (y < f.hh && xc < f.wh) {
        const int ch = (pp & 1) * 6 + (pp >> 1) * 3 + c;  // pp = pr*2 + pc
        *reinterpret_cast<uint4*>(&xs[pp][r][cv * kPer]) =
            *reinterpret_cast<const uint4*>(xb + ch * plane + y * f.wh + xc);
      }
    }
    __syncthreads();
    const T* src[4];
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      src[pp] = &xs[pp][threadIdx.x][threadIdx.y * kV];
    }
    // rows and columns past the frame compute bytes that are never stored
    finish_run<T, kLinear>(src, true, kV, load_scal<kLinear>(scal, b), f, q);
  } else if (i < f.hh && j0 < f.wh) {
    const T* src[4];
    run_planes(x, b, c, i, j0, f, src);
    finish_run<T, kLinear>(src, false, f.wh - j0, load_scal<kLinear>(scal, b),
                           f, q);
  }
#pragma unroll
  for (int k = 0; k < kV; ++k) {
#pragma unroll
    for (int pc = 0; pc < 2; ++pc) {
      s[2 * (threadIdx.y * kV + k) + pc][threadIdx.x] =
          static_cast<uint16_t>(q[0][pc][k] | q[1][pc][k] << 8);
    }
  }
  __syncthreads();
  const int h = 2 * f.hh, w = 2 * f.wh;  // output rows are h bytes long
  uint8_t* ob = out + static_cast<size_t>(bc) * h * w;
  constexpr int kVecs = 2 * kSwapRows / 16;  // 16-byte vectors of a row
  for (int k = tid; k < kTileX * kVecs; k += kSwapRows * kSwapRuns) {
    const int xl = k / kVecs, m = k - xl * kVecs;
    const int xx = 2 * jt + xl, y0 = 2 * i0 + 16 * m;
    if (xx >= w || y0 >= h) continue;
    uint8_t* row = ob + (f.flip_x ? w - 1 - xx : xx) * h;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(&s[xl][8 * m]);
    if (f.vec) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      if (f.flip_y) {
        *reinterpret_cast<uint4*>(row + h - y0 - 16) = reverse_bytes(v);
      } else {
        *reinterpret_cast<uint4*>(row + y0) = v;
      }
    } else {
      for (int e = 0; e < 16 && y0 + e < h; ++e) {
        const int y = y0 + e;
        row[f.flip_y ? h - 1 - y : y] = src[e];
      }
    }
  }
}

template <typename T, bool kLinear>
cudaError_t launch_mode(const T* x, const float* scal, uint8_t* out, int n,
                        const Finish& f, int swap, cudaStream_t stream) {
  if (swap) {
    const dim3 grid((f.wh + kSwapRuns * kV - 1) / (kSwapRuns * kV),
                    (f.hh + kSwapRows - 1) / kSwapRows, n * 3);
    finish_swap_kernel<T, kLinear><<<grid, dim3(kSwapRows, kSwapRuns), 0,
                                     stream>>>(x, scal, out, f);
  } else {
    const dim3 block(16, 16);
    const dim3 grid((f.wh + block.x * kV - 1) / (block.x * kV),
                    (f.hh + block.y - 1) / block.y, n * 3);
    finish_rows_kernel<T, kLinear><<<grid, block, 0, stream>>>(x, scal, out,
                                                                f);
  }
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* scal, void* out, int n, int hh,
           int wh, int linear, int apply_gamma, float inv_gamma, int swap,
           int flip_y, int flip_x, cudaStream_t stream) {
  if (static_cast<long long>(n) * hh * wh == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (!tit::image_fits_int32(hh, wh) || 3LL * n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // vectors: whole runs along each row, and (with a swap) whole 16-byte
  // vectors along each output row of 2 hh bytes
  const int vec = wh % kV == 0 && (!swap || hh % 8 == 0) &&
                  tit::aligned16(x) && tit::aligned16(out);
  const Finish f{hh, wh, apply_gamma, flip_y, flip_x, vec, inv_gamma};
  const auto* xin = static_cast<const T*>(x);
  const auto* s = static_cast<const float*>(scal);
  auto* o = static_cast<uint8_t*>(out);
  return static_cast<int>(
      linear ? launch_mode<T, true>(xin, s, o, n, f, swap, stream)
             : launch_mode<T, false>(xin, s, o, n, f, swap, stream));
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
