// The tonemap finish's per-value pieces, K4's tone and the I420
// conversion's helpers: finish.cu (K4 and its I420 mode) and yuv420.cu (the
// planar I420 kernels, its tonemap form among them) include them.
//
// Tone: reinhard o = p / max(1e-6, max_out[n]), or linear y = max((x - m0) *
// inv_range, 0); exp2(log2(.) * inv_gamma) when gamma != 1; then
// trunc(clip(255 o, 0, 255)) or trunc(clip(clip(y, 0, 1) * 255, 0, 255)).
// The quotient's bits are the IEEE one's wherever they can reach a byte
// (tone_u8) and the u8 convert truncates toward zero (XLA's f32->u8
// convert); fmaxf maps a NaN (log2 of a negative p at gamma != 1) to 0.
#pragma once

#include <cstring>

#include "common.cuh"

namespace tit {

constexpr int kRun = 8;  // values of a tone run

// The tone's form, a compile-time parameter of every kernel that tones:
// kGamma1 (gamma 1: no pow), kPowRcp (the pow of the division-free
// quotient; the linear tone's pow, which has no quotient) or kPowDiv (the
// pow of the true division). The launchers take it as an int, which
// ops/hopper/finish.py tone_form picks from gamma.
enum class Tone : int { kGamma1 = 0, kPowRcp = 1, kPowDiv = 2 };

struct Finish {
  int hh, wh, flip_y, flip_x, vec;
  float inv_gamma;
};

// The per-image scalars a run needs: max(1e-6, max_out[b]) and its
// reciprocal rounded to nearest, or [m0, inv_range].
struct Scal {
  float mx, rmx, m0, inv_range;
};

template <bool kLinear>
__device__ __forceinline__ Scal load_scal(const float* __restrict__ scal,
                                          int b) {
  if (kLinear) return Scal{0.0f, 0.0f, scal[0], scal[1]};
  const float mx = fmaxf(1e-6f, scal[b]);
  return Scal{mx, __frcp_rn(mx), 0.0f, 0.0f};
}

// trunc(v) for 0 <= v < 2^23 (v not NaN) from an add rounded toward zero:
// the bits of 2^23 + trunc(v). The F2I convert it replaces issues on the
// quarter-rate pipe beside MUFU; the I420 conversion's bytes and the
// tone's pow forms take the add, the tone at gamma 1 keeps the convert
// (the add was no faster there in K4: PERF.md section 6, "F2I against the
// add").
__device__ __forceinline__ unsigned trunc_small(float v) {
  return __float_as_uint(__fadd_rz(v, 8388608.0f)) - 0x4B000000u;
}

// The byte q (< 2^23) as an exact f32, by the same means: no I2F convert.
__device__ __forceinline__ float float_small(unsigned q) {
  return __uint_as_float(0x4B000000u | q) - 8388608.0f;
}

// RN(p / mx) without the division, which branches to a subroutine
// (Markstein): q0 = p RN(1/mx) lies within an ulp of the quotient, the
// residual p - q0 mx is exact in one FMA, and q0 + r RN(1/mx) in one more
// is RN(p / mx) while |q0| >= 2^-64 (mx >= 1e-6: nothing underflows). An
// infinite q0 (p infinite) is the quotient; a NaN stays NaN.
__device__ __forceinline__ float reinhard_quotient(float p, const Scal& sc) {
  const float q0 = p * sc.rmx;
  const float r = __fmaf_rn(-q0, sc.mx, p);
  return fabsf(q0) <= 0x1.fffffep127f ? __fmaf_rn(r, sc.rmx, q0) : q0;
}

// The byte of one value. The Reinhard forms give the division's byte:
//   - kGamma1: reinhard_quotient is bitwise p / mx while |q0| >= 2^-64;
//     below that 255 o < 1, a byte of 0 either way.
//   - kPowRcp: the same quotient, then the pow. Where |q0| >= 2^-64 the
//     pow sees the division's bits. Below it both quotients are under
//     2^-63, so o^(1/gamma) < 2^(-63/gamma) and the byte is 0 either way
//     while 255 2^(-63/gamma) < 1, that is 0 < gamma < 63 / log2(255) =
//     7.88; tone_form takes this form for gamma < 7 (a margin of 0.88 for
//     the few ulps of log2f and exp2f). A zero p gives log2 -inf, a byte
//     of 0, in both; a negative p or a NaN gives NaN, a byte of 0.
//   - kPowDiv: the true division, for every other gamma; mx >= 1e-6, so
//     a zero p keeps off the division's slow path.
// The pow forms truncate with trunc_small, an add, where gamma 1 keeps
// the F2I convert: F2I issues on the quarter-rate pipe that exp2f's
// MUFU.EX2 takes. The clip maps a NaN to 0, so 0 <= s <= 255 for both.
template <bool kLinear, Tone kTone>
__device__ __forceinline__ unsigned tone_u8(float xv, const Scal& sc,
                                            const Finish& f) {
  constexpr bool kPow = kTone != Tone::kGamma1;
  float s;
  if constexpr (kLinear) {
    float y = fmaxf((xv - sc.m0) * sc.inv_range, 0.0f);
    if constexpr (kPow) y = exp2f(log2f(y) * f.inv_gamma);
    s = fminf(fmaxf(fminf(fmaxf(y, 0.0f), 1.0f) * 255.0f, 0.0f), 255.0f);
  } else {
    float o;
    if constexpr (kTone == Tone::kPowDiv) {
      o = div_rn_keep_zero(xv, sc.mx);
    } else {
      o = reinhard_quotient(xv, sc);
    }
    if constexpr (kPow) o = exp2f(log2f(o) * f.inv_gamma);
    s = fminf(fmaxf(255.0f * o, 0.0f), 255.0f);
  }
  if constexpr (kPow) {
    return trunc_small(s);
  } else {
    return __float2uint_rz(s);
  }
}

// One run of kRun values of T as loaded (their bits, in 32-bit words), so
// that a thread can have several runs' loads in flight before it tones the
// first.
template <typename T>
struct RawRun {
  static constexpr int kWords = kRun * static_cast<int>(sizeof(T)) / 4;
  unsigned w[kWords];
};

// The run at p: with `vec` in 16-byte vectors, else element by element up
// to n elements (the rest 0, the bits of +0 in every T).
template <typename T>
__device__ __forceinline__ void load_run(const T* p, bool vec, int n,
                                         RawRun<T>& r) {
  constexpr int kPer = 16 / sizeof(T);
  if (vec) {
#pragma unroll
    for (int h = 0; h < kRun / kPer; ++h) {
      Run<T, kPer>::load_words(p + h * kPer, r.w + 4 * h);
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      r.w[k] = k < n ? reinterpret_cast<const unsigned*>(p)[k] : 0u;
    }
  } else {
    const auto* h16 = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int m = 0; m < RawRun<T>::kWords; ++m) {
      r.w[m] = (2 * m < n ? h16[2 * m] : 0u) |
               (2 * m + 1 < n ? static_cast<unsigned>(h16[2 * m + 1]) << 16
                              : 0u);
    }
  }
}

// tone_u8 of each value of a loaded run.
template <typename T, bool kLinear, Tone kTone>
__device__ __forceinline__ void tone_run(const RawRun<T>& r, const Scal& sc,
                                         const Finish& f, unsigned q[kRun]) {
  constexpr int kPer = 16 / sizeof(T);
  float v[kRun];
#pragma unroll
  for (int h = 0; h < kRun / kPer; ++h) {
    Run<T, kPer>::unpack(r.w + 4 * h, v + h * kPer);
  }
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    q[k] = tone_u8<kLinear, kTone>(v[k], sc, f);
  }
}

// ---------------------------------------------------------------------------
// The I420 conversion's pieces, shared by K4's I420 mode (finish.cu) and
// the planar I420 kernels (yuv420.cu).

// The rows of the conversion (ops/hopper/yuv420.py coefficients).
struct Yuv {
  float y[3], u[3], v[3];
  float off_y, off_u, off_v;
};

// ((m0 b + m1 g) + m2 r) + off for the row (y, u or v) of cv
#define TIT_YUV_ROW(cv, row, b, g, r) \
  (((cv.row[0] * (b) + cv.row[1] * (g)) + cv.row[2] * (r)) + cv.off_##row)

// trunc(clip(min(1, v) * 255, 0, 255)); min(1, v) * 255 <= 255 already
// (a NaN v gives min 1)
__device__ __forceinline__ unsigned yuv_u8(float v) {
  return trunc_small(fmaxf(fminf(v, 1.0f) * 255.0f, 0.0f));
}

// s / 255 rounded to nearest even, bitwise the quotient of div.rn.f32 for
// the sums the dot produces (up to the sign of a zero), from f32
// multiplies and fused multiply-adds only: q0 = s y with y = RN(1/255), the
// residual s - 255 q0 exact in one FMA, then q0 + r y.
// tests/test_torch_yuv420.py holds it to the division on every 97th f32
// of [2^-20, 1024), both signs, where the dot's sums lie.
__device__ __forceinline__ float div255(float s) {
  constexpr float y = 1.0f / 255.0f;
  const float q0 = s * y;
  const float r = __fmaf_rn(-q0, 255.0f, s);
  return __fmaf_rn(r, y, q0);
}

// ---------------------------------------------------------------------------
// The I420 tile: the tone's u8 of a tile in shared memory, turned into Y and
// VU of the transformed image. It runs the planar I420 tonemap form
// (yuv420.cu, kPlanar) and K4's I420 mode under an axis swap (finish.cu,
// kDot or kChains). Three sums, each in the order its plain twin in
// ops/hopper/yuv420.py keeps:
//   kDot (bf16 phases: the bf16 pipeline's dot; the rows are the
//     bf16-rounded (r, g, b) coefficients of _yuv420_w6, the chroma ones
//     / 4): Y = (y0 r + y1 g) + y2 b, V and U summed over the block's 12
//     channels, the output's phases in order and (r, g, b) within each;
//     then / 255 + offset;
//   kChains (f16 and f32 phases; the rows on (b, g, r) of x = u8 / 255
//     from the table of k / 255): Y = ((y0 b + y1 g) + y2 r) + off_y; the
//     chroma of the means (((x_p0 + x_p1) + x_p2) + x_p3) * 0.25 of b, g
//     and r;
//   kPlanar (the planar image): Y, U and V per pixel as kChains' Y, the
//     block's U and V as ((tl + tr) + bl) + br, * 0.25;
// each then trunc(clip(min(1, .) * 255, 0, 255)). The output's phases are
// taken in the twin's order: (0,0), (1,0), (0,1), (1,1) in (row, col) for
// the phases, tl, tr, bl, br for the planar image; each reads the input
// parity that the transform puts there.
//
// A block of 256 threads takes kTH x kTW of the input's 2x2 blocks (8 x 64
// without an axis swap; 16 x 32 with one, so that a tile's output rows are
// 32 bytes of Y, a whole sector, and its input rows 32 or 64 values):
// 6144 values, the phases' 12 planes of kTH rows of kTW or
// the planar image's 3 channels of 2 kTH rows of 2 kTW. Thread t loads runs
// t, t + 256 and t + 512 of them straight into registers (a warp reads 32
// adjacent 16-byte vectors), tones them and stores the bytes in the u8
// tile; after one barrier each thread takes two adjacent blocks from the
// bytes. The pair is adjacent in a row without a swap and in a column with
// one, so that it is adjacent in an output row either way: one 4-byte Y
// store per output row and one 2-byte store per chroma plane (a warp
// writes 8 pairs down each of 4 columns with a swap). The u8 rows of a
// swapped tile are padded by 4 bytes, so that a warp's byte reads down a
// column fall in distinct banks or share a word. A frame whose rows are not whole
// runs, or an input that is not 16-byte aligned, is loaded element by
// element; a pair that the frame cuts, or of an output row of odd width,
// leaves byte by byte.
enum class I420 { kDot, kChains, kPlanar };

template <typename T, I420 kKind, bool kSwap>
struct I420Tile {
  static constexpr bool kPlanar = kKind == I420::kPlanar;
  static constexpr int kTH = kSwap ? 16 : 8;  // the input's 2x2 blocks
  static constexpr int kTW = kSwap ? 32 : 64;
  static constexpr int kPlanes = kPlanar ? 3 : 12;
  static constexpr int kPR = kPlanar ? 2 * kTH : kTH;  // rows of a plane
  static constexpr int kRW = kPlanar ? 2 * kTW : kTW;  // values of a row
  static constexpr int kValues = kPlanes * kPR * kRW;
  static constexpr int kUP = kRW + (kSwap ? 4 : 0);    // u8 row pitch
  static constexpr int kRuns = kValues / (kRun * kThreads);
  static_assert(kRuns * kRun * kThreads == kValues, "whole runs a thread");
};

// The frame: f.hh x f.wh input blocks (the phase planes, or half the
// planar image) staged from rows x cols (the same, or the planar image's);
// f.vec: whole runs a row and a 16-byte aligned input; pairs: the output's
// block rows have an even width (4- and 2-byte stores).
template <typename T, I420 kKind, bool kLinear, Tone kTone, bool kSwap,
          bool kFlipY, bool kFlipX>
__global__ void __launch_bounds__(kThreads)
    i420_tile_kernel(const T* __restrict__ x, const float* __restrict__ scal,
                     const float* __restrict__ inv255g,
                     uint8_t* __restrict__ yp, uint8_t* __restrict__ vu,
                     Finish f, int rows, int cols, int pairs, Yuv cv) {
  using Tl = I420Tile<T, kKind, kSwap>;
  __shared__ alignas(16) uint8_t u8[Tl::kPlanes * Tl::kPR * Tl::kUP];
  __shared__ float inv255[256];
  const int tid = threadIdx.x, b = blockIdx.z;
  const int i0 = blockIdx.y * Tl::kTH, j0 = blockIdx.x * Tl::kTW;
  const int r0 = Tl::kPlanar ? 2 * i0 : i0, c0 = Tl::kPlanar ? 2 * j0 : j0;
  const int plane = rows * cols;
  const T* xb = x + static_cast<size_t>(b) * Tl::kPlanes * plane;
  RawRun<T> raw[Tl::kRuns];
#pragma unroll
  for (int m = 0; m < Tl::kRuns; ++m) {
    const int v = (tid + m * kThreads) * kRun;
    const int row = v / Tl::kRW, col = v - row * Tl::kRW;
    const int p = row / Tl::kPR, y = r0 + row - p * Tl::kPR, xc = c0 + col;
    const int n = y < rows ? cols - xc : 0;  // values of the run in frame
    if (n > 0) {
      load_run<T>(xb + p * plane + y * cols + xc, f.vec, n, raw[m]);
    } else {
#pragma unroll
      for (int w = 0; w < RawRun<T>::kWords; ++w) raw[m].w[w] = 0u;
    }
  }
  if (kKind != I420::kDot) inv255[tid] = inv255g[tid];  // loads in flight
  const Scal sc = load_scal<kLinear>(scal, b);
#pragma unroll
  for (int m = 0; m < Tl::kRuns; ++m) {
    const int v = (tid + m * kThreads) * kRun;
    const int row = v / Tl::kRW, col = v - row * Tl::kRW;
    unsigned q[kRun];
    tone_run<T, kLinear, kTone>(raw[m], sc, f, q);
    auto* d = reinterpret_cast<unsigned*>(u8 + row * Tl::kUP + col);
    d[0] = q[0] | q[1] << 8 | q[2] << 16 | q[3] << 24;
    d[1] = q[4] | q[5] << 8 | q[6] << 16 | q[7] << 24;
  }
  __syncthreads();
  // this thread's blocks of the tile: (ta, tb) and the next along the pair
  const int ta = kSwap ? 2 * (tid & 7) : tid >> 5;
  const int tb = kSwap ? tid >> 3 : 2 * (tid & 31);
  constexpr int along = kSwap ? kFlipY : kFlipX;  // the pair's output order
  // the byte of input parity (ipr, ipc), color c (r, g, b) of block (ti, tj)
  auto byte = [&](int ipr, int ipc, int c, int ti, int tj) -> unsigned {
    return Tl::kPlanar
               ? u8[(c * Tl::kPR + 2 * ti + ipr) * Tl::kUP + 2 * tj + ipc]
               : u8[((ipc * 6 + ipr * 3 + c) * Tl::kTH + ti) * Tl::kUP + tj];
  };
  unsigned yw[2] = {0u, 0u};  // Y by output row parity, the pair's 4 bytes
  unsigned cw[2] = {0u, 0u};  // V, U: the pair's 2 bytes
  float acc[2][3];
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    const int opr = Tl::kPlanar ? pp >> 1 : pp & 1;
    const int opc = Tl::kPlanar ? pp & 1 : pp >> 1;
    const int ipr = (kSwap ? opc : opr) ^ kFlipY;
    const int ipc = (kSwap ? opr : opc) ^ kFlipX;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int ti = kSwap ? ta + k : ta, tj = kSwap ? tb : tb + k;
      const unsigned q0 = byte(ipr, ipc, 0, ti, tj);
      const unsigned q1 = byte(ipr, ipc, 1, ti, tj);
      const unsigned q2 = byte(ipr, ipc, 2, ti, tj);
      unsigned ybyte;
      if constexpr (kKind == I420::kDot) {
        const float r = float_small(q0), g = float_small(q1);
        const float bl = float_small(q2);
        ybyte = yuv_u8(div255((r * cv.y[0] + g * cv.y[1]) + bl * cv.y[2]) +
                       cv.off_y);
        float av = pp ? acc[k][0] + r * cv.v[0] : r * cv.v[0];
        av = av + g * cv.v[1];
        acc[k][0] = av + bl * cv.v[2];
        float au = pp ? acc[k][1] + r * cv.u[0] : r * cv.u[0];
        au = au + g * cv.u[1];
        acc[k][1] = au + bl * cv.u[2];
      } else {
        const float xbl = inv255[q2], xg = inv255[q1], xr = inv255[q0];
        ybyte = yuv_u8(TIT_YUV_ROW(cv, y, xbl, xg, xr));
        if constexpr (kKind == I420::kChains) {
          acc[k][0] = pp ? acc[k][0] + xbl : xbl;
          acc[k][1] = pp ? acc[k][1] + xg : xg;
          acc[k][2] = pp ? acc[k][2] + xr : xr;
        } else {
          const float v = TIT_YUV_ROW(cv, v, xbl, xg, xr);
          const float u = TIT_YUV_ROW(cv, u, xbl, xg, xr);
          acc[k][0] = pp ? acc[k][0] + v : v;
          acc[k][1] = pp ? acc[k][1] + u : u;
        }
      }
      yw[opr] |= ybyte << (8 * (2 * (k ^ along) + opc));
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float v, u;
    if constexpr (kKind == I420::kDot) {
      v = div255(acc[k][0]) + cv.off_v;
      u = div255(acc[k][1]) + cv.off_u;
    } else if constexpr (kKind == I420::kChains) {
      const float mb = acc[k][0] * 0.25f, mg = acc[k][1] * 0.25f;
      const float mr = acc[k][2] * 0.25f;
      v = TIT_YUV_ROW(cv, v, mb, mg, mr);
      u = TIT_YUV_ROW(cv, u, mb, mg, mr);
    } else {
      v = acc[k][0] * 0.25f;
      u = acc[k][1] * 0.25f;
    }
    cw[0] |= yuv_u8(v) << (8 * (k ^ along));
    cw[1] |= yuv_u8(u) << (8 * (k ^ along));
  }
  // the output blocks: input block (i, j) lands on (io, jo)
  const int bh = kSwap ? f.wh : f.hh, bw = kSwap ? f.hh : f.wh;
  uint8_t* yb = yp + static_cast<size_t>(b) * 4 * bh * bw;
  uint8_t* vb = vu + static_cast<size_t>(b) * 2 * bh * bw;  // U at + bh bw
  int io[2], jo[2];
  bool in[2];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {  // the pair in output order
    const int k = sl ^ along;
    const int i = i0 + (kSwap ? ta + k : ta);
    const int j = j0 + (kSwap ? tb : tb + k);
    const int ib = kFlipY ? f.hh - 1 - i : i;
    const int jb = kFlipX ? f.wh - 1 - j : j;
    io[sl] = kSwap ? jb : ib;
    jo[sl] = kSwap ? ib : jb;
    in[sl] = i < f.hh && j < f.wh;
  }
  if (pairs && in[0] && in[1]) {
#pragma unroll
    for (int opr = 0; opr < 2; ++opr) {
      *reinterpret_cast<unsigned*>(yb + (2 * io[0] + opr) * 2 * bw +
                                   2 * jo[0]) = yw[opr];
    }
    *reinterpret_cast<uint16_t*>(vb + io[0] * bw + jo[0]) =
        static_cast<uint16_t>(cw[0]);
    *reinterpret_cast<uint16_t*>(vb + bh * bw + io[0] * bw + jo[0]) =
        static_cast<uint16_t>(cw[1]);
  } else {
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      if (!in[sl]) continue;
#pragma unroll
      for (int opr = 0; opr < 2; ++opr) {
        uint8_t* row = yb + (2 * io[sl] + opr) * 2 * bw + 2 * jo[sl];
        row[0] = static_cast<uint8_t>(yw[opr] >> (16 * sl));
        row[1] = static_cast<uint8_t>(yw[opr] >> (16 * sl + 8));
      }
      vb[io[sl] * bw + jo[sl]] = static_cast<uint8_t>(cw[0] >> (8 * sl));
      vb[bh * bw + io[sl] * bw + jo[sl]] =
          static_cast<uint8_t>(cw[1] >> (8 * sl));
    }
  }
}

// Run f(std::true_type{}) or f(std::false_type{}) for the run-time v.
template <typename F>
void with_bool(bool v, F&& f) {
  if (v) {
    f(std::true_type{});
  } else {
    f(std::false_type{});
  }
}

template <Tone kTone>
using ToneC = std::integral_constant<Tone, kTone>;

// Whether `tone` names a form (the launchers refuse any other int).
inline bool tone_ok(int tone) { return tone >= 0 && tone <= 2; }

// Run f(lin, tone) for the run-time mode and tone form as compile-time
// constants (std::bool_constant, ToneC): five pairs, since the linear
// tone has no quotient (kPowDiv runs its kPowRcp).
template <typename F>
decltype(auto) with_tone(bool linear, int tone, F&& f) {
  if (linear) {
    return tone == 0 ? f(std::true_type{}, ToneC<Tone::kGamma1>{})
                     : f(std::true_type{}, ToneC<Tone::kPowRcp>{});
  }
  return tone == 0   ? f(std::false_type{}, ToneC<Tone::kGamma1>{})
         : tone == 1 ? f(std::false_type{}, ToneC<Tone::kPowRcp>{})
                     : f(std::false_type{}, ToneC<Tone::kPowDiv>{});
}

// Launch the tile kernel over n images of f.hh x f.wh input blocks, with or
// without the axis swap (kSwap), the tonemap mode, the tone form and the
// flips as compile-time variants (the flips fix every shared-memory offset
// a block reads); the caller has checked the sizes (32-bit offsets, the
// grid's limits) and the tone form. x: the 12 phase planes (kDot, kChains)
// or the planar image (kPlanar).
template <typename T, I420 kKind, bool kSwap>
cudaError_t launch_i420_tiles(const T* x, const float* scal,
                              const float* inv255, uint8_t* y, uint8_t* vu,
                              int n, Finish f, int linear, int tone,
                              const Yuv& cv, cudaStream_t stream) {
  using Tl = I420Tile<T, kKind, kSwap>;
  const int rows = Tl::kPlanar ? 2 * f.hh : f.hh;
  const int cols = Tl::kPlanar ? 2 * f.wh : f.wh;
  f.vec = cols % kRun == 0 && aligned16(x);
  const int pairs = (kSwap ? f.hh : f.wh) % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(vu) % 2 == 0;
  const dim3 grid((f.wh + Tl::kTW - 1) / Tl::kTW,
                  (f.hh + Tl::kTH - 1) / Tl::kTH, n);
  with_tone(linear, tone, [&](auto lin, auto tn) {
    with_bool(f.flip_y, [&](auto fy) {
      with_bool(f.flip_x, [&](auto fx) {
        i420_tile_kernel<T, kKind, decltype(lin)::value, decltype(tn)::value,
                         kSwap, decltype(fy)::value, decltype(fx)::value>
            <<<grid, kThreads, 0, stream>>>(x, scal, inv255, y, vu, f, rows,
                                            cols, pairs, cv);
      });
    });
  });
  return cudaGetLastError();
}

}  // namespace tit
