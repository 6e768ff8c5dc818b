// K4<T>: tonemap finish, (N, 12, hh, wh) p or x12 of T (bf16, f16 or
// f32) -> planar u8 (N, 3, 2hh, 2wh), or (N, 3, 2wh, 2hh) under a
// transform that swaps the axes; or, in its I420 mode (below, after the
// RGB kernels), planar I420. Two tonemap modes:
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
// per-element work stays small: the Reinhard quotient comes from the
// per-image reciprocal and two FMAs (finish.cuh tone_u8), with no division
// (below gamma 7) and no branch, and the tone's form (gamma 1, or the pow
// of that quotient or of the division) is a compile-time variant. At gamma
// != 1 the pow itself bounds it by instruction issue: log2f is a polynomial
// of ~25 instructions, exp2f one MUFU.EX2 (PERF.md section 6), and a value
// takes no division and no F2I. Each thread takes kV = 8 consecutive
// half-res pixels of one row of one colour: one or two 16-byte loads from
// each of its 4 phase planes, the per-image scalar read once, 4 x kV bytes
// out. Input
// (y, x) = (2i + pr, 2j + pc) comes from channel pc*6 + pr*3 + c. The grid
// is (column runs, rows, n * 3), so all indexing is 32-bit within a plane,
// with no division per pixel.
//   - No axis swap: each output row of the run is 2 kV = 16 interleaved
//     bytes, one 16-byte store (a half-warp writes 256 contiguous bytes).
//     flip_y moves the row; flip_x mirrors the vector's position and
//     reverses its bytes in registers (__byte_perm).
//   - Axis swap (transpose, rotate_90, rotate_270, transverse):
//     finish_swap_kernel, a persistent grid (one wave, the blocks an SM
//     asked once a device) whose blocks walk tiles of 64 x 64 half-res
//     pixels by a fixed stride, a run of one row a thread, a warp down 32
//     rows of one column run. Its input goes through a ring of two stages
//     in shared memory: while tile k tones from its stage, tile k + 1's
//     four phase-plane rows are in flight, cp.async.cg 16-byte copies in
//     commit groups (cp.async.wait_group). Those copies were picked over
//     cp.async.bulk row copies on an mbarrier: each thread already holds
//     its share's addresses (8 copies a tile in f32, 4 in bf16/f16), a
//     tile needs a barrier for its output anyway, a copy past the frame is
//     simply not issued, and no thread issues 256 row copies or keeps an
//     mbarrier's phase and byte count. The staged rows are unpadded and
//     each 16-byte chunk's slot is XORed with its row's place in a bank
//     line, so that the lanes' reads down 32 rows fall in distinct banks.
//     The output tile, 128 rows x' of 128 bytes y, goes through one of two
//     shared buffers [x][y] of byte pairs, so that each output row leaves
//     as 128 contiguous bytes in 16-byte stores (flip_y reverses each
//     vector and mirrors its position); tile k's stores leave after the
//     next barrier, beside tile k + 1's tone, one barrier a tile. The tile
//     size and the ring's depth are the fastest of A/Bs on an H100 at the
//     f32 cell's 6 x 4K (PERF.md section 6). Shared memory sets the
//     blocks: 160 KB a block in f32, one block of 16 warps an SM at 128
//     registers; 96 KB in bf16 and f16, two blocks at 64 registers. The
//     copies in flight hide the latency, not resident blocks. At gamma 1
//     bytes bound it; at gamma != 1 instruction issue does, the pow of 32
//     values a thread a tile, so the walk advances without a division and
//     the staged and the element loads share one tone path.
// A row that is not a whole number of runs, an output side that is not a
// whole number of vectors, or a plane that is not 16-byte aligned takes
// the element-by-element loads and byte stores of the same kernels (the
// launcher picks `vec` from the sizes and pointers); the swap kernel then
// copies nothing and each thread loads its run from device memory.
//
// The table form (bf16 or f16 at gamma != 1 without an axis swap) is the
// only form there: ops/hopper/finish.py table_form passes the scratch, and
// the launcher refuses a null table. tone_u8 is a pure function of a
// value's bits, its image's scalars and inv_gamma, so tone_table_kernel
// tones each of the 65,536 bit patterns of T once an image, by the unpack
// and tone_u8 of the direct form (f32, gamma 1, the axis swap), into a
// 64 KB table of bytes, and the rows kernel's table form gives each value
// its byte by one shared-memory gather at its 16 bits: every byte is the
// one tone_u8 gives the value, NaN, zeros of both signs, negatives and
// subnormals included, and the pow leaves the per-value path. The same
// launcher call enqueues both kernels. The table form is a persistent grid,
// one wave of kTableBlocks blocks an SM shared out evenly over the images:
// a block copies its image's table into shared memory (cp.async) while its
// first run's loads are in flight, then walks its share of the image's
// (channel, row, run) items with the next item's loads in flight, keeping
// the direct form's loads, interleave, flips, 16-byte stores and element
// path.
//
// The byte is the one of the IEEE quotient (finish.cuh tone_u8) and the u8
// convert truncates toward zero (XLA's f32->u8 convert, camera_isp.py:1106);
// fmaxf maps a NaN (log2 of a negative p at gamma != 1) to 0.
#include "finish.cuh"

namespace {

using namespace tit;

constexpr int kV = kRun;  // half-res pixels per thread

// The bytes q[pr][pc][k] of one run of kV pixels; src[pr * 2 + pc] is the
// run's first element in the plane of input phase (pr, pc). With `vec`
// each plane is read in 16-byte vectors, else element by element up to n
// elements (the rest are 0).
template <typename T, bool kLinear, Tone kTone>
__device__ __forceinline__ void finish_run(const T* const src[4], bool vec,
                                           int n, const Scal& sc,
                                           const Finish& f,
                                           unsigned q[2][2][kV]) {
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
    for (int pc = 0; pc < 2; ++pc) {
      RawRun<T> r;
      load_run<T>(src[pr * 2 + pc], vec, n, r);
      tone_run<T, kLinear, kTone>(r, sc, f, q[pr][pc]);
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

// The run's bytes q[pr][pc][k] in the output plane bc (an image's channel):
// output row 2 i + pr, bytes 2 (j0 + k) + pc, moved by the flips.
__device__ __forceinline__ void store_run(const unsigned (&q)[2][2][kV],
                                          uint8_t* __restrict__ out, int bc,
                                          int i, int j0, const Finish& f) {
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

// The table form (kTable, below) gives every pattern's byte from shared
// memory: 64 KB a block, so kTableBlocks blocks an SM.
constexpr int kTableBytes = 65536;  // a byte per bit pattern of a 16-bit T
constexpr int kTableBlocks = 3;

// A (channel, row, run) item of the table form: item e of an image is run
// e % runs of row e / runs of its 3 hh channel rows.
struct Item {
  int c, i, j0;
};

// Item e's coordinates, and its run's loads from the four planes issued
// into r, where e < items.
template <typename T>
__device__ __forceinline__ Item load_item(const T* __restrict__ x, int b,
                                          int e, int runs, int items,
                                          const Finish& f,
                                          RawRun<T> (&r)[4]) {
  Item it{0, 0, 0};
  if (e < items) {
    const int row = e / runs;
    it.j0 = (e - row * runs) * kV;
    it.c = row / f.hh;
    it.i = row - it.c * f.hh;
    const T* src[4];
    run_planes(x, b, it.c, it.i, it.j0, f, src);
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      load_run<T>(src[pp], f.vec, f.wh - it.j0, r[pp]);
    }
  }
  return it;
}

// 16 bytes from device memory into shared memory, without registers
// (cp.async; cp_async_wait waits for this thread's copies).
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// This thread's copies issued since the last commit, as one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are still
// in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The table form's body: block (256) of grid (blocks an image, n) copies
// image b's table into shared memory while its first item's loads are in
// flight, then walks the image's items blockIdx.x * 256 + t, + gridDim.x *
// 256, ..., the next item's loads in flight while it gathers the bytes of
// the current one, a value's byte at its 16 bits.
template <typename T>
__device__ __forceinline__ void finish_rows_table(
    const T* __restrict__ x, const uint8_t* __restrict__ table,
    uint8_t* __restrict__ out, const Finish& f) {
  extern __shared__ __align__(16) uint8_t tab[];
  const int b = blockIdx.y;
  const int runs = (f.wh + kV - 1) / kV;
  const int items = 3 * f.hh * runs;
  const int step = gridDim.x * blockDim.x;
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  RawRun<T> raw[4];
  Item it = load_item(x, b, e, runs, items, f, raw);
  const uint8_t* tb = table + static_cast<size_t>(b) * kTableBytes;
  for (int k = threadIdx.x; k < kTableBytes / 16; k += blockDim.x) {
    copy16_async(tab + 16 * k, tb + 16 * k);
  }
  cp_async_wait();
  __syncthreads();
  for (; e < items; e += step) {
    RawRun<T> next[4];
    const Item nt = load_item(x, b, e + step, runs, items, f, next);
    unsigned q[2][2][kV];
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        const unsigned wd = raw[pp].w[k >> 1];
        q[pp >> 1][pp & 1][k] = tab[(k & 1) ? wd >> 16 : wd & 0xFFFFu];
      }
    }
    store_run(q, out, 3 * b + it.c, it.i, it.j0, f);
    it = nt;
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) raw[pp] = next[pp];
  }
}

// No axis swap. The direct form (f32, or gamma 1): block (16, 16) over
// (runs, rows), grid.z = n * 3. The table form (kTable: a 16-bit T and a
// pow form): each value its byte from the image's table
// (tone_table_kernel), finish_rows_table.
template <typename T, bool kLinear, Tone kTone, bool kTable>
__global__ void __launch_bounds__(256, kTable ? kTableBlocks : 1)
    finish_rows_kernel(const T* __restrict__ x,
                       const float* __restrict__ scal,
                       const uint8_t* __restrict__ table,
                       uint8_t* __restrict__ out, Finish f) {
  if constexpr (kTable) {
    finish_rows_table<T>(x, table, out, f);
  } else {
    const int bc = blockIdx.z, b = bc / 3, c = bc - 3 * b;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * kV;
    if (i >= f.hh || j0 >= f.wh) return;
    unsigned q[2][2][kV];
    const T* src[4];
    run_planes(x, b, c, i, j0, f, src);
    finish_run<T, kLinear, kTone>(src, f.vec, f.wh - j0,
                                  load_scal<kLinear>(scal, b), f, q);
    store_run(q, out, bc, i, j0, f);
  }
}

// The table of each image b: table[b][u] = tone_u8 of the T whose bits are
// u, under image b's scalars: the direct form's tone, by the same
// unpack and tone_u8 (a thread tones 4 patterns, one 4-byte store). Grid
// (kTableBytes / (4 * kThreads), n).
template <typename T, bool kLinear, Tone kTone>
__global__ void __launch_bounds__(kThreads)
    tone_table_kernel(const float* __restrict__ scal,
                      uint8_t* __restrict__ table, Finish f) {
  const int b = blockIdx.y;
  const unsigned u = 4 * (blockIdx.x * kThreads + threadIdx.x);
  const unsigned w[2] = {u | (u + 1) << 16, (u + 2) | (u + 3) << 16};
  float v[4];
  Run<T, 4>::unpack(w, v);
  const Scal sc = load_scal<kLinear>(scal, b);
  unsigned q = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q |= tone_u8<kLinear, kTone>(v[k], sc, f) << (8 * k);
  }
  reinterpret_cast<unsigned*>(table + static_cast<size_t>(b) *
                                          kTableBytes)[u / 4] = q;
}

// Axis swap: a persistent grid walks the swapped tiles. A tile is
// kSwapRows half-res rows by kSwapCols columns of one image's channel, a
// run of kV pixels a thread: warp wp takes rows 32 (wp / kSwapRuns) + lane
// of the run wp % kSwapRuns. Tile t of the walk (column tiles fastest,
// then row tiles, then the images' channels) goes to block t % grid, so
// that a block walks its tiles by a fixed stride.
constexpr int kSwapThreads = 512;                         // a block
constexpr int kSwapRows = 64;                             // half-res rows
constexpr int kSwapCols = kSwapThreads * kV / kSwapRows;  // and columns
constexpr int kSwapRuns = kSwapCols / kV;  // runs of a tile row
constexpr int kSmemPerSm = 233472;  // an sm_90 SM's shared memory, 228 KB

template <typename T>
struct SwapTile {
  static constexpr int kPer = 16 / sizeof(T);  // values of a 16-byte chunk
  static constexpr int kRowChunks = kSwapCols / kPer;  // chunks of a row
  static constexpr int kCopies = 4 * kSwapRows * kRowChunks / kSwapThreads;
  static constexpr int kStage = 4 * kSwapRows * kSwapCols;  // values
  static constexpr int kStages = 2;  // the ring
  static constexpr int kOutRows = 2 * kSwapCols;       // output rows x'
  static constexpr int kOutVecs = 2 * kSwapRows / 16;  // 16 bytes a row
  static constexpr int kStores = kOutRows * kOutVecs / kSwapThreads;
  static constexpr int kOut = kOutRows * kSwapRows;  // u16 of an s buffer
  // the ring, then two buffers s[x][i]: bytes (y = 2i, 2i + 1) of output
  // row x
  static constexpr int kSmem = kStages * kStage * static_cast<int>(sizeof(T)) +
                               2 * kOut * static_cast<int>(sizeof(uint16_t));
  // blocks an SM: as many as its shared memory holds, 1 KB of it reserved
  // a block, and at most 2048 threads
  static constexpr int kBlocks =
      kSmemPerSm / (kSmem + 1024) < 2048 / kSwapThreads
          ? kSmemPerSm / (kSmem + 1024)
          : 2048 / kSwapThreads;
  static_assert(kCopies * kSwapThreads == 4 * kSwapRows * kRowChunks &&
                    kStores * kSwapThreads == kOutRows * kOutVecs,
                "whole copies and stores a thread");
  static_assert(kBlocks >= 1, "a block fits an SM");

  // The offset of chunk `c` of staged row `row` in a stage: unpadded rows,
  // the chunk's slot XORed with the row's place among the rows of a
  // 128-byte bank line, so that the eight lanes of a quarter warp, on eight
  // consecutive rows, read the same chunk from eight distinct 16-byte bank
  // groups.
  static __device__ __forceinline__ int chunk_at(int row, int c) {
    constexpr int kLineRows = kRowChunks < 8 ? 8 / kRowChunks : 1;
    constexpr int kSwz = kRowChunks < 8 ? kRowChunks : 8;
    return (row * kRowChunks + (c ^ (row / kLineRows % kSwz))) * kPer;
  }
};

// A block's place in its walk: tile t, as its image's channel bc, tile row
// ty and tile column tx (column tiles fastest, then row tiles, then the
// channels).
struct SwapAt {
  int t, tx, ty, bc;
};

// The walk's geometry and its fixed stride, taken apart once into whole
// tile columns, tile rows and channels, so that a block advances its
// place with two compares and no division.
struct SwapWalk {
  int tiles_x, tiles_y, step, dx, dy, dbc;

  __device__ SwapWalk(int tx, int ty, int s)
      : tiles_x(tx), tiles_y(ty), step(s) {
    const int q = s / tiles_x;
    dx = s - q * tiles_x;
    dbc = q / tiles_y;
    dy = q - dbc * tiles_y;
  }

  __device__ __forceinline__ SwapAt at(int t) const {
    const int row = t / tiles_x;  // bc * tiles_y + ty
    const int bc = row / tiles_y;
    return SwapAt{t, t - row * tiles_x, row - bc * tiles_y, bc};
  }

  __device__ __forceinline__ void advance(SwapAt& a) const {
    a.t += step;
    a.tx += dx;
    a.ty += dy;
    a.bc += dbc;
    if (a.tx >= tiles_x) {
      a.tx -= tiles_x;
      ++a.ty;
    }
    if (a.ty >= tiles_y) {
      a.ty -= tiles_y;
      ++a.bc;
    }
  }
};

// The first element of tile `a`'s phase plane 0 (input phase (0, 0)) in x:
// the tile's row i0 and column jt of its image's channel.
template <typename T>
__device__ __forceinline__ const T* swap_tile_x(const T* __restrict__ x,
                                                const Finish& f,
                                                const SwapAt& a) {
  const int plane = f.hh * f.wh;
  const int b = a.bc / 3, c = a.bc - 3 * b;
  return x + static_cast<size_t>(b * 12 + c) * plane +
         (a.ty * kSwapRows * f.wh + a.tx * kSwapCols);
}

// This thread's share of tile `a`'s four phase planes, as 16-byte cp.async
// copies into the stage xs: staged row pp * kSwapRows + r holds row r of
// phase plane pp = pr * 2 + pc (channel c + pc * 6 + pr * 3). Rows and
// columns past the frame are not copied: their stale values tone into
// bytes that are never stored.
template <typename T>
__device__ __forceinline__ void stage_swap(const T* __restrict__ x,
                                           const Finish& f, const SwapAt& a,
                                           T* xs) {
  using Tl = SwapTile<T>;
  const int plane = f.hh * f.wh;
  const T* xt = swap_tile_x(x, f, a);
  const int rows = f.hh - a.ty * kSwapRows;  // the tile's rows in the frame
  const int cols = f.wh - a.tx * kSwapCols;  // and its columns
#pragma unroll
  for (int m = 0; m < Tl::kCopies; ++m) {
    const int k = threadIdx.x + m * kSwapThreads;
    const int row = k / Tl::kRowChunks, cv = k - row * Tl::kRowChunks;
    const int pp = row / kSwapRows, r = row - pp * kSwapRows;
    if (r < rows && cv * Tl::kPer < cols) {
      copy16_async(xs + Tl::chunk_at(row, cv),
                   xt + ((pp & 1) * 6 + (pp >> 1) * 3) * plane + r * f.wh +
                       cv * Tl::kPer);
    }
  }
}

// Tile `a`'s bytes from s ([x][i] byte pairs) to its 2 kSwapCols output
// rows x', 2 kSwapRows bytes y each: 16-byte stores with `vec` (flip_y
// reverses each vector and mirrors its position), else byte by byte.
template <typename T>
__device__ __forceinline__ void store_swap(const uint16_t* s, const SwapAt& a,
                                           uint8_t* __restrict__ out,
                                           const Finish& f) {
  using Tl = SwapTile<T>;
  const int h = 2 * f.hh, w = 2 * f.wh;  // output rows are h bytes long
  uint8_t* ob = out + static_cast<size_t>(a.bc) * h * w;
  const int xt = 2 * a.tx * kSwapCols, yt = 2 * a.ty * kSwapRows;
#pragma unroll
  for (int m = 0; m < Tl::kStores; ++m) {
    const int v = threadIdx.x + m * kSwapThreads;
    const int xl = v / Tl::kOutVecs, mv = v - xl * Tl::kOutVecs;
    const int xx = xt + xl, y0 = yt + 16 * mv;
    if (xx >= w || y0 >= h) continue;
    uint8_t* row = ob + (f.flip_x ? w - 1 - xx : xx) * h;
    const uint8_t* src =
        reinterpret_cast<const uint8_t*>(s + xl * kSwapRows + 8 * mv);
    if (f.vec) {
      const uint4 vv = *reinterpret_cast<const uint4*>(src);
      if (f.flip_y) {
        *reinterpret_cast<uint4*>(row + h - y0 - 16) = reverse_bytes(vv);
      } else {
        *reinterpret_cast<uint4*>(row + y0) = vv;
      }
    } else {
      for (int e = 0; e < 16 && y0 + e < h; ++e) {
        const int y = y0 + e;
        row[f.flip_y ? h - 1 - y : y] = src[e];
      }
    }
  }
}

// The walk over tiles blockIdx.x, + gridDim.x, ... < tiles, one barrier a
// tile. With `vec` the input goes through a ring of kStages stages: the
// copies of the kStages - 1 tiles after tile k are in flight while tile k
// tones, each thread's run read from the stage. Without it each thread
// loads its run element by element from device memory. Either way one
// tone_run a phase plane gives the bytes, which go to one of two buffers
// s; tile k's stores leave after the next barrier, beside tile k + 1's
// tone.
template <typename T, bool kLinear, Tone kTone>
__global__ void __launch_bounds__(kSwapThreads, SwapTile<T>::kBlocks)
    finish_swap_kernel(const T* __restrict__ x,
                       const float* __restrict__ scal,
                       uint8_t* __restrict__ out, Finish f, int tiles) {
  using Tl = SwapTile<T>;
  constexpr int kPer = Tl::kPer;
  extern __shared__ __align__(16) uint8_t swap_smem[];
  T* const ring = reinterpret_cast<T*>(swap_smem);
  uint16_t* const s0 = reinterpret_cast<uint16_t*>(
      swap_smem + Tl::kStages * Tl::kStage * sizeof(T));
  const int tid = threadIdx.x, wp = tid >> 5;
  const int r = wp / kSwapRuns * 32 + (tid & 31);  // the thread's tile row
  const int cr = wp % kSwapRuns * kV;              // its run's first column
  const SwapWalk walk((f.wh + kSwapCols - 1) / kSwapCols,
                      (f.hh + kSwapRows - 1) / kSwapRows, gridDim.x);
  const int plane = f.hh * f.wh;
  SwapAt a = walk.at(blockIdx.x);  // tile k
  SwapAt ahead = a;                // tile k + kStages - 1
#pragma unroll
  for (int j = 0; j + 1 < Tl::kStages; ++j) {
    if (j) walk.advance(ahead);
    if (f.vec && ahead.t < tiles) {
      stage_swap(x, f, ahead, ring + j * Tl::kStage);
    }
    cp_async_commit();
  }
  SwapAt prev = a;  // the tile whose bytes s holds
  for (int k = 0;; ++k) {
    cp_async_wait_group<Tl::kStages - 2>();  // this thread's tile k copies
    __syncthreads();  // everyone's; tile k - 1 toned, its stage free
    walk.advance(ahead);
    if (f.vec && ahead.t < tiles) {
      stage_swap(x, f, ahead,
                 ring + (k + Tl::kStages - 1) % Tl::kStages * Tl::kStage);
    }
    cp_async_commit();
    if (k > 0) store_swap<T>(s0 + ((k - 1) & 1) * Tl::kOut, prev, out, f);
    if (a.t >= tiles) break;
    const Scal sc = load_scal<kLinear>(scal, a.bc / 3);
    const T* st = ring + k % Tl::kStages * Tl::kStage;
    const T* xr = swap_tile_x(x, f, a) + r * f.wh + cr;  // element path
    const int n = f.wh - a.tx * kSwapCols - cr;  // its run's columns
    const bool in = r < f.hh - a.ty * kSwapRows && n > 0;
    uint16_t* s = s0 + (k & 1) * Tl::kOut;
#pragma unroll
    for (int pc = 0; pc < 2; ++pc) {
      unsigned q[2][kV];
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const int pp = pr * 2 + pc;
        RawRun<T> raw;
        if (f.vec) {
#pragma unroll
          for (int hv = 0; hv < kV / kPer; ++hv) {
            Run<T, kPer>::load_words(
                st + Tl::chunk_at(pp * kSwapRows + r, cr / kPer + hv),
                raw.w + 4 * hv);
          }
        } else {
          // rows and columns past the frame tone zeros never stored
          load_run<T>(xr + (pc * 6 + pr * 3) * plane, false, in ? n : 0,
                      raw);
        }
        tone_run<T, kLinear, kTone>(raw, sc, f, q[pr]);
      }
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        s[(2 * (cr + e) + pc) * kSwapRows + r] =
            static_cast<uint16_t>(q[0][e] | q[1][e] << 8);
      }
    }
    prev = a;
    walk.advance(a);
  }
}

// Blocks of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory each) that the current device holds at once: asked once a device,
// the kernel's limit of dynamic shared memory raised to `smem` before the
// first ask.
template <typename Kernel>
cudaError_t smem_blocks(Kernel kernel, int threads, int smem,
                        PerDevice& cache, int& blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices ||
      cache.value[dev].load(std::memory_order_relaxed) == 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
  }
  return resident_blocks(kernel, threads, smem, cache, blocks);
}

// The axis swap: one wave of finish_swap_kernel, at most a block a tile.
template <typename T, bool kLinear, Tone kTone>
cudaError_t launch_swap(const T* x, const float* scal, uint8_t* out, int n,
                        const Finish& f, cudaStream_t stream) {
  using Tl = SwapTile<T>;
  static PerDevice resident;
  int blocks = 0;
  cudaError_t err = smem_blocks(finish_swap_kernel<T, kLinear, kTone>,
                                kSwapThreads, Tl::kSmem, resident, blocks);
  if (err != cudaSuccess) return err;
  const long long tiles = 3LL * n * ((f.hh + kSwapRows - 1) / kSwapRows) *
                          ((f.wh + kSwapCols - 1) / kSwapCols);
  // a place of the walk runs up to kStages strides past the last tile
  if (tiles + (Tl::kStages + 1LL) * blocks > 0x7FFFFFFFLL) {
    return cudaErrorInvalidValue;
  }
  const int grid = tiles < blocks ? static_cast<int>(tiles) : blocks;
  finish_swap_kernel<T, kLinear, kTone>
      <<<grid, kSwapThreads, Tl::kSmem, stream>>>(x, scal, out, f,
                                                   static_cast<int>(tiles));
  return cudaGetLastError();
}

// The table form of a rows kernel (K4's, its I420 mode's, P's): the tables
// of the n images, then one wave of `kernel` (its blocks an SM asked once a
// device, into `resident`) shared out evenly over the images, no more
// blocks an image than 256-item passes of its `items`, enqueued by
// launch(kernel, grid): block (256) of grid (blocks an image, n), with
// kTableBytes of dynamic shared memory.
template <typename T, bool kLinear, Tone kTone, typename Kernel,
          typename Launch>
cudaError_t launch_table(Kernel kernel, PerDevice& resident, long long items,
                         const float* scal, uint8_t* table, int n,
                         const Finish& f, cudaStream_t stream,
                         Launch launch) {
  int blocks = 0;
  cudaError_t err = smem_blocks(kernel, 256, kTableBytes, resident, blocks);
  if (err != cudaSuccess) return err;
  long long per_image = blocks / n;
  if (per_image > (items + 255) / 256) per_image = (items + 255) / 256;
  if (per_image < 1) per_image = 1;
  tone_table_kernel<T, kLinear, kTone>
      <<<dim3(kTableBytes / (4 * kThreads), n), kThreads, 0, stream>>>(
          scal, table, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  launch(kernel, dim3(static_cast<unsigned>(per_image), n));
  return cudaGetLastError();
}

template <typename T, bool kLinear, Tone kTone>
cudaError_t launch_mode(const T* x, const float* scal, uint8_t* table,
                        uint8_t* out, int n, const Finish& f, int swap,
                        cudaStream_t stream) {
  if (swap) {
    return launch_swap<T, kLinear, kTone>(x, scal, out, n, f, stream);
  }
  if constexpr (sizeof(T) == 2 && kTone != Tone::kGamma1) {
    static PerDevice resident;
    return launch_table<T, kLinear, kTone>(
        finish_rows_kernel<T, kLinear, kTone, true>, resident,
        3LL * f.hh * ((f.wh + kV - 1) / kV), scal, table, n, f, stream,
        [&](auto kernel, dim3 grid) {
          kernel<<<grid, 256, kTableBytes, stream>>>(x, scal, table, out, f);
        });
  } else {
    const dim3 block(16, 16);
    const dim3 grid((f.wh + block.x * kV - 1) / (block.x * kV),
                    (f.hh + block.y - 1) / block.y, n * 3);
    finish_rows_kernel<T, kLinear, kTone, false>
        <<<grid, block, 0, stream>>>(x, scal, nullptr, out, f);
    return cudaGetLastError();
  }
}

// `table`: the table form's scratch of n * kTableBytes bytes, 16-byte
// aligned, which a 16-bit T at a pow form without an axis swap takes and
// every other launch leaves null (refused otherwise).
template <typename T>
int launch(const void* x, const void* scal, void* out, int n, int hh,
           int wh, int linear, int tone, float inv_gamma, int swap,
           int flip_y, int flip_x, void* table, cudaStream_t stream) {
  if (static_cast<long long>(n) * hh * wh == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (!tit::image_fits_int32(hh, wh) || 3LL * n > 65535 ||
      !tit::tone_ok(tone)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool table_form = sizeof(T) == 2 && tone != 0 && !swap;
  if ((table != nullptr) != table_form ||
      (table != nullptr && !tit::aligned16(table))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // vectors: whole runs along each row, and (with a swap) whole 16-byte
  // vectors along each output row of 2 hh bytes
  const int vec = wh % kV == 0 && (!swap || hh % 8 == 0) &&
                  tit::aligned16(x) && tit::aligned16(out);
  const Finish f{hh, wh, flip_y, flip_x, vec, inv_gamma};
  const auto* xin = static_cast<const T*>(x);
  const auto* s = static_cast<const float*>(scal);
  auto* tb = static_cast<uint8_t*>(table);
  auto* o = static_cast<uint8_t*>(out);
  return static_cast<int>(with_tone(linear, tone, [&](auto lin, auto tn) {
    return launch_mode<T, decltype(lin)::value, decltype(tn)::value>(
        xin, s, tb, o, n, f, swap, stream);
  }));
}

// ---------------------------------------------------------------------------
// K4's I420 mode: the same u8 RGB, from the same loads and tone_u8, turned
// into planar I420 without being written: Y u8 (N, H', W') at each pixel's
// transformed address and VU u8 (N, 2, H'/2, W'/2) at each 2x2 block's
// transformed position, V then U. It replaces the JAX phase route's XLA
// tail, reinhard_gamma_ca or linear_apply_ca, _transform_phases and
// yuv420_from_phases_u8 (taichi_image_tpu/models/camera_isp.py:1485-1532,
// :1774-1784). A thread takes the run of kV half-res pixels of one row in
// all 12 planes; the planes are read in the order of the OUTPUT's phases
// (the input phase that the transform puts on each output parity), since
// the chroma sums over them in that order:
//   - f32 chains (f16 and f32 input; the cv rows apply to (b, g, r) of
//     x = u8 / 255, from the wrapper's per-device table of k / 255):
//     Y = min(1, ((y0 b + y1 g) + y2 r) + off_y); the chroma of the means
//     (((x_p0 + x_p1) + x_p2) + x_p3) * 0.25 of b, g and r;
//   - the bf16 dot (bf16 input; the rows are the bf16-rounded (r, g, b)
//     coefficients of _yuv420_w6, the chroma ones / 4): Y = (y0 r + y1 g) +
//     y2 b, V and U summed over the 12 channels in ascending order (the
//     output's phases, (r, g, b) within each); then / 255 + offset;
// each then trunc(clip(min(1, .) * 255, 0, 255)). ops/hopper/yuv420.py's
// twins sum in the same orders.
//
// Bound: memory, the 12 * sizeof(T) bytes read per half-res pixel and 6
// bytes written (4 of Y, 2 of VU): 373.2 MB at 6 x 4K bf16, 0.1114 ms at
// 3.35 TB/s. Its arithmetic, not those bytes, bounds it (PERF.md section 6:
// an earlier form reading a tile that stays in L2 took 94% of its time),
// so the tone takes no division below gamma 7 (finish.cuh tone_u8) and the
// conversion's bytes no u8 <-> f32 convert. Without an axis swap the block
// is K4's (16, 16) over (runs, rows): a thread issues the loads of all four
// output phases of its run (two in f32, for registers) before it tones the
// first, each Y row of a run leaves as one 16-byte store and each chroma
// run as one 8-byte store (flip_x reverses the byte pairs, or the bytes,
// in registers). Under an axis swap the launcher runs finish.cuh's I420 tile
// kernel instead (kDot for bf16, kChains for f16 and f32): its loads are
// coalesced, where a lane per row of this kernel read half a 32-byte
// sector per load, and its tile turns the transpose into 4-byte stores.
// That tile kernel without a swap was slower than this one (PERF.md
// section 6): the bytes' round trip through shared memory adds to the
// arithmetic.
//
// At gamma != 1 the pow bounds the direct form by instruction issue (37% of
// its bound at gamma 0.6 on 6 x 4K f16). The table form (bf16 or f16 at a
// pow form without an axis swap: ops/hopper/finish.py table_form, K4's
// rule) is the only form there, and the launcher refuses a null table
// there and a table anywhere else. It is K4's: the same launcher call first
// enqueues tone_table_kernel, each image's 65,536 bit patterns toned once
// into its table, then this kernel's table form gives each value its byte
// by one shared-memory gather at its 16 bits, the byte tone_u8 gives it,
// which the conversion then takes as it takes the direct form's. The
// table form is a persistent grid, one wave of kI420TableBlocks blocks an
// SM shared out evenly over the images, 256 threads a block: a block
// copies its image's table into shared memory (cp.async) while its first
// item's loads are in flight, then walks its share of the image's items,
// an item the direct form's unit (a run of kV half-res pixels of a row, in
// all 12 planes), one at a time. A grid of (16, 16) blocks each copying
// 64 KB would read ~400 MB a set from L2. The blocks an SM and the loads in
// flight are the fastest of an A/B on an H100 at the I420 cell's 6 x 4K
// f16 and bf16 (PERF.md section 6): two blocks of 128 registers, a thread
// issuing an item's four phases at once and the next item's after its
// stores, beat three blocks (80 registers: the loads and sums spilled) and
// the next item's loads in flight beside the current one's (spilled at
// 128).

__device__ __forceinline__ uint4 reverse_pairs(uint4 v) {
  return make_uint4(__byte_perm(v.w, 0, 0x1032), __byte_perm(v.z, 0, 0x1032),
                    __byte_perm(v.y, 0, 0x1032), __byte_perm(v.x, 0, 0x1032));
}

// Byte k of a run packed four to a word.
__device__ __forceinline__ unsigned byte_of(const unsigned (&w)[kV / 4],
                                            int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

// One chroma plane's bytes of a run (cw, four to a word), in the row crow
// of bw bytes (no axis swap): an 8-byte store with `vec`, flip_x reversing
// the bytes.
__device__ __forceinline__ void store_chroma_run(uint8_t* crow,
                                                 const unsigned (&cw)[kV / 4],
                                                 const Finish& f, int bw,
                                                 int j0, int n) {
  if (f.vec) {
    const unsigned w0 = cw[0], w1 = cw[1];
    if (f.flip_x) {
      *reinterpret_cast<uint2*>(crow + bw - j0 - kV) = make_uint2(
          __byte_perm(w1, 0, 0x0123), __byte_perm(w0, 0, 0x0123));
    } else {
      *reinterpret_cast<uint2*>(crow + j0) = make_uint2(w0, w1);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      if (k >= n) break;
      crow[f.flip_x ? bw - 1 - (j0 + k) : j0 + k] =
          static_cast<uint8_t>(byte_of(cw, k));
    }
  }
}

// The runs of output phase pp (parity (pp & 1, pp >> 1)) in its 3 colors:
// those of the input phase (pr, pc) that the transform puts on that
// parity, channel pc * 6 + pr * 3 + c.
template <typename T>
__device__ __forceinline__ void load_phase(const T* xb, int plane, int pp,
                                           const Finish& f, int n,
                                           RawRun<T> (&r)[3]) {
  const int ipr = (pp & 1) ^ f.flip_y, ipc = (pp >> 1) ^ f.flip_x;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    load_run<T>(xb + (ipc * 6 + ipr * 3 + c) * plane, f.vec, n, r[c]);
  }
}

// Output phase pp's bytes q[c][k] of a run (c: r, g, b) into the run's Y
// bytes yw (its output row parity pp & 1, column parity pp >> 1) and the
// chroma sums acc, which output phase 0 starts.
template <bool kDot>
__device__ __forceinline__ void convert_phase(const unsigned (&q)[3][kV],
                                              int pp, const Yuv& cv,
                                              const float* inv255,
                                              unsigned (&yw)[2][kV / 2],
                                              float (&acc)[3][kV]) {
  const int opr = pp & 1, opc = pp >> 1;
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    if constexpr (kDot) {
      const float r = float_small(q[0][k]);
      const float g = float_small(q[1][k]);
      const float bl = float_small(q[2][k]);
      const float s = (r * cv.y[0] + g * cv.y[1]) + bl * cv.y[2];
      yw[opr][k >> 1] |= yuv_u8(div255(s) + cv.off_y)
                         << (8 * (2 * (k & 1) + opc));
      float av = pp ? acc[0][k] + r * cv.v[0] : r * cv.v[0];
      av = av + g * cv.v[1];
      acc[0][k] = av + bl * cv.v[2];
      float au = pp ? acc[1][k] + r * cv.u[0] : r * cv.u[0];
      au = au + g * cv.u[1];
      acc[1][k] = au + bl * cv.u[2];
    } else {
      const float xbl = inv255[q[2][k]], xg = inv255[q[1][k]];
      const float xr = inv255[q[0][k]];
      yw[opr][k >> 1] |=
          yuv_u8(((cv.y[0] * xbl + cv.y[1] * xg) + cv.y[2] * xr) + cv.off_y)
          << (8 * (2 * (k & 1) + opc));
      acc[0][k] = pp ? acc[0][k] + xbl : xbl;
      acc[1][k] = pp ? acc[1][k] + xg : xg;
      acc[2][k] = pp ? acc[2][k] + xr : xr;
    }
  }
}

// The run of image b's half-res row i from column j0, converted: its V and
// U bytes from the chroma sums acc, then its two Y rows (yw) and its
// chroma bytes stored where the flips put them.
template <bool kDot>
__device__ __forceinline__ void store_i420_run(
    const unsigned (&yw)[2][kV / 2], const float (&acc)[3][kV],
    uint8_t* __restrict__ yp, uint8_t* __restrict__ vu, int b, int i, int j0,
    const Finish& f, const Yuv& cv) {
  const int n = f.wh - j0;
  unsigned vw[kV / 4] = {}, uw[kV / 4] = {};  // V and U bytes
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    float v, u;
    if constexpr (kDot) {
      v = div255(acc[0][k]) + cv.off_v;
      u = div255(acc[1][k]) + cv.off_u;
    } else {
      const float mb = acc[0][k] * 0.25f, mg = acc[1][k] * 0.25f;
      const float mr = acc[2][k] * 0.25f;
      v = ((cv.v[0] * mb + cv.v[1] * mg) + cv.v[2] * mr) + cv.off_v;
      u = ((cv.u[0] * mb + cv.u[1] * mg) + cv.u[2] * mr) + cv.off_u;
    }
    vw[k >> 2] |= yuv_u8(v) << (8 * (k & 3));
    uw[k >> 2] |= yuv_u8(u) << (8 * (k & 3));
  }
  // the output's 2x2 blocks: hh x wh; Y is 2 hh x 2 wh
  const int bh = f.hh, bw = f.wh;
  uint8_t* yb = yp + static_cast<size_t>(b) * 4 * bh * bw;
  uint8_t* vb = vu + static_cast<size_t>(b) * 2 * bh * bw;  // U at + bh bw
  const int io = f.flip_y ? f.hh - 1 - i : i;  // the output block row
#pragma unroll
  for (int opr = 0; opr < 2; ++opr) {
    uint8_t* row = yb + (2 * io + opr) * 2 * bw;
    if (f.vec) {
      // bytes x = 2 j0 .. 2 j0 + 16 in order; flip_x reverses the pairs,
      // not the bytes in them
      const uint4 v =
          make_uint4(yw[opr][0], yw[opr][1], yw[opr][2], yw[opr][3]);
      if (f.flip_x) {
        *reinterpret_cast<uint4*>(row + 2 * (bw - j0 - kV)) =
            reverse_pairs(v);
      } else {
        *reinterpret_cast<uint4*>(row + 2 * j0) = v;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        if (k >= n) break;
        const int jo = f.flip_x ? bw - 1 - (j0 + k) : j0 + k;
        const unsigned pair = yw[opr][k >> 1] >> (16 * (k & 1));
        row[2 * jo] = static_cast<uint8_t>(pair);
        row[2 * jo + 1] = static_cast<uint8_t>(pair >> 8);
      }
    }
  }
  uint8_t* crow = vb + io * bw;
  store_chroma_run(crow, vw, f, bw, j0, n);
  store_chroma_run(crow + bh * bw, uw, f, bw, j0, n);
}

// The table form's blocks an SM: the fastest of an A/B on an H100 at the
// I420 cell's 6 x 4K (PERF.md section 6). At 3 blocks (80 registers) an
// item's loads and sums spill; 2 hold them in 128 registers.
constexpr int kI420TableBlocks = 2;

// Item e of the table form: the run of kV half-res pixels from column j0
// of row i, e = i * runs + j0 / kV.
struct I420Item {
  int i, j0;
};

__device__ __forceinline__ I420Item i420_item(int e, int runs) {
  const int i = e / runs;
  return I420Item{i, (e - i * runs) * kV};
}

// The bytes of a loaded run, each one gather from the table tab at the
// value's 16 bits.
template <typename T>
__device__ __forceinline__ void gather_run(const uint8_t* tab,
                                           const RawRun<T>& r,
                                           unsigned (&q)[kV]) {
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const unsigned wd = r.w[k >> 1];
    q[k] = tab[(k & 1) ? wd >> 16 : wd & 0xFFFFu];
  }
}

// The table form's body: block (256) of grid (blocks an image, n) copies
// image b's table into shared memory while its first item's loads are in
// flight, then walks the image's items blockIdx.x * 256 + t, + gridDim.x *
// 256, ..., one at a time as the direct form takes its run: the loads of
// all four output phases issued at once, each value's byte one
// shared-memory gather at its 16 bits, the direct form's conversion and
// stores, then the next item's loads.
template <typename T>
__device__ __forceinline__ void finish_yuv420_table(
    const T* __restrict__ x, const float* __restrict__ inv255g,
    const uint8_t* __restrict__ table, uint8_t* __restrict__ yp,
    uint8_t* __restrict__ vu, const Finish& f, const Yuv& cv) {
  constexpr bool kDot = std::is_same_v<T, __nv_bfloat16>;
  extern __shared__ __align__(16) uint8_t ytab[];
  __shared__ float inv255[kDot ? 1 : 256];  // k / 255 (the f32 chains)
  const int b = blockIdx.y;
  const int runs = (f.wh + kV - 1) / kV;
  const int items = f.hh * runs;
  const int step = gridDim.x * blockDim.x;
  const int plane = f.hh * f.wh;
  const T* const xi = x + static_cast<size_t>(b) * 12 * plane;
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  I420Item it = i420_item(e, runs);
  RawRun<T> raw[4][3];
  if (e < items) {
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      load_phase<T>(xi + it.i * f.wh + it.j0, plane, pp, f, f.wh - it.j0,
                    raw[pp]);
    }
  }
  const uint8_t* tb = table + static_cast<size_t>(b) * kTableBytes;
  for (int k = threadIdx.x; k < kTableBytes / 16; k += blockDim.x) {
    copy16_async(ytab + 16 * k, tb + 16 * k);
  }
  if constexpr (!kDot) inv255[threadIdx.x] = inv255g[threadIdx.x];
  cp_async_wait();
  __syncthreads();
  for (; e < items; e += step) {
    unsigned yw[2][kV / 2] = {};
    float acc[3][kV];
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {  // output phase pp
      unsigned q[3][kV];
#pragma unroll
      for (int c = 0; c < 3; ++c) gather_run<T>(ytab, raw[pp][c], q[c]);
      convert_phase<kDot>(q, pp, cv, inv255, yw, acc);
    }
    store_i420_run<kDot>(yw, acc, yp, vu, b, it.i, it.j0, f, cv);
    if (e + step < items) {
      it = i420_item(e + step, runs);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        load_phase<T>(xi + it.i * f.wh + it.j0, plane, pp, f, f.wh - it.j0,
                      raw[pp]);
      }
    }
  }
}

// No axis swap. The direct form (f32, or gamma 1): block (16, 16) over
// (runs, rows), grid.z = n. The table form (kTable: a 16-bit T and a pow
// form): each value's byte from its image's table (tone_table_kernel),
// finish_yuv420_table. The direct form's bound names no blocks an SM (0),
// so that ptxas sets its registers as it does without one.
template <typename T, bool kLinear, Tone kTone, bool kTable>
__global__ void __launch_bounds__(256, kTable ? kI420TableBlocks : 0)
    finish_yuv420_kernel(const T* __restrict__ x,
                         const float* __restrict__ scal,
                         const float* __restrict__ inv255g,
                         const uint8_t* __restrict__ table,
                         uint8_t* __restrict__ yp, uint8_t* __restrict__ vu,
                         Finish f, Yuv cv) {
  if constexpr (kTable) {
    finish_yuv420_table<T>(x, inv255g, table, yp, vu, f, cv);
  } else {
    constexpr bool kDot = std::is_same_v<T, __nv_bfloat16>;
    __shared__ float inv255[256];  // k / 255 (the f32 chains)
    const int b = blockIdx.z;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * kV;
    const bool live = i < f.hh && j0 < f.wh;
    const int n = f.wh - j0;
    const int plane = f.hh * f.wh;
    const T* xb = x + static_cast<size_t>(b) * 12 * plane + i * f.wh + j0;
    // Y bytes by output row parity, as that row's 16 bytes: (k, col
    // parity) at byte 2 k + col parity
    unsigned yw[2][kV / 2] = {};
    float acc[3][kV];  // chains: b, g, r over the phases; dot: V, U
    // the runs of the next kRing output phases are in flight: all four for
    // 16-bit T, two for f32 (48 registers of loads either way)
    constexpr int kRing = sizeof(T) == 4 ? 2 : 4;
    RawRun<T> raw[kRing][3];
    if (live) {
#pragma unroll
      for (int pp = 0; pp < kRing; ++pp) {
        load_phase<T>(xb, plane, pp, f, n, raw[pp]);
      }
    }
    if constexpr (!kDot) {  // the table arrives while the loads are in flight
      inv255[threadIdx.y * blockDim.x + threadIdx.x] =
          inv255g[threadIdx.y * blockDim.x + threadIdx.x];
      __syncthreads();
    }
    if (!live) return;
    const Scal sc = load_scal<kLinear>(scal, b);
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {  // output phase pp
      unsigned q[3][kV];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tone_run<T, kLinear, kTone>(raw[pp % kRing][c], sc, f, q[c]);
      }
      if (pp + kRing < 4) {
        load_phase<T>(xb, plane, pp + kRing, f, n, raw[pp % kRing]);
      }
      convert_phase<kDot>(q, pp, cv, inv255, yw, acc);
    }
    store_i420_run<kDot>(yw, acc, yp, vu, b, i, j0, f, cv);
  }
}

template <typename T, bool kLinear, Tone kTone>
cudaError_t launch_yuv420_mode(const T* x, const float* scal,
                               const float* inv255, uint8_t* table,
                               uint8_t* y, uint8_t* vu, int n,
                               const Finish& f, const Yuv& cv,
                               cudaStream_t stream) {
  if constexpr (sizeof(T) == 2 && kTone != Tone::kGamma1) {
    static PerDevice resident;
    return launch_table<T, kLinear, kTone>(
        finish_yuv420_kernel<T, kLinear, kTone, true>, resident,
        static_cast<long long>(f.hh) * ((f.wh + kV - 1) / kV), scal, table,
        n, f, stream, [&](auto kernel, dim3 grid) {
          kernel<<<grid, 256, kTableBytes, stream>>>(x, scal, inv255, table,
                                                     y, vu, f, cv);
        });
  } else {
    const dim3 block(16, 16);
    const dim3 grid((f.wh + block.x * kV - 1) / (block.x * kV),
                    (f.hh + block.y - 1) / block.y, n);
    finish_yuv420_kernel<T, kLinear, kTone, false>
        <<<grid, block, 0, stream>>>(x, scal, inv255, nullptr, y, vu, f, cv);
    return cudaGetLastError();
  }
}

// `table`: the table form's scratch of n * kTableBytes bytes, 16-byte
// aligned, which a 16-bit T at a pow form without an axis swap takes and
// every other launch leaves null (refused otherwise), as K4's.
template <typename T>
int launch_yuv420(const void* x, const void* scal, void* y, void* vu, int n,
                  int hh, int wh, int linear, int tone, float inv_gamma,
                  int swap, int flip_y, int flip_x, const float* coef,
                  const void* inv255, void* table, cudaStream_t stream) {
  if (static_cast<long long>(n) * hh * wh == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (!tit::image_fits_int32(hh, wh) || n > 65535 ||
      (hh + 15) / 16 > 65535 || !tit::tone_ok(tone)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool table_form = sizeof(T) == 2 && tone != 0 && !swap;
  if ((table != nullptr) != table_form ||
      (table != nullptr && !tit::aligned16(table))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // vectors: whole runs along each row
  const int vec = wh % kV == 0 && tit::aligned16(x) && tit::aligned16(y) &&
                  tit::aligned16(vu);
  const Finish f{hh, wh, flip_y, flip_x, vec, inv_gamma};
  Yuv cv;
  static_assert(sizeof(Yuv) == 12 * sizeof(float), "Yuv is 12 floats");
  memcpy(&cv, coef, sizeof(cv));
  const auto* xin = static_cast<const T*>(x);
  const auto* s = static_cast<const float*>(scal);
  auto* yo = static_cast<uint8_t*>(y);
  auto* vo = static_cast<uint8_t*>(vu);
  const auto* tab = static_cast<const float*>(inv255);
  if (swap) {  // the tile kernel: coalesced loads, the transpose in its tile
    constexpr I420 kKind = std::is_same_v<T, __nv_bfloat16> ? I420::kDot
                                                            : I420::kChains;
    return static_cast<int>(launch_i420_tiles<T, kKind, true>(
        xin, s, tab, yo, vo, n, f, linear, tone, cv, stream));
  }
  auto* tb = static_cast<uint8_t*>(table);
  return static_cast<int>(with_tone(linear, tone, [&](auto lin, auto tn) {
    return launch_yuv420_mode<T, decltype(lin)::value, decltype(tn)::value>(
        xin, s, tab, tb, yo, vo, n, f, cv, stream);
  }));
}

// ---------------------------------------------------------------------------
// P<T>: the resize route's RGB tail in one pass, from the untransformed
// planar (N, 3, h, w) of T: K3's map p and its per-image max, or the
// resized image and [m0, inv_range]: the tone (finish.cuh tone_u8, K4's
// bytes), then the three u8 planes stored under the output transform,
// (N, 3, h, w), or (N, 3, w, h) under an axis swap. It replaces the JAX
// resize route's XLA tail, reinhard_apply_ca or linear_apply_ca, then
// _transform_planar (taichi_image_tpu/models/camera_isp.py:1721-1727,
// :1790), which the port ran as torch's gamma_u8 / linear_u8 and a
// transformed copy. Its twin is that torch code, bitwise.
//
// Bound: memory, sizeof(T) bytes read and 1 written per value: 74.6 + 37.3
// MB at 6 x 1920 x 1080 bf16 (0.033 ms at 3.35 TB/s), 149.3 + 37.3 MB in
// f32 (0.056 ms); on an H100 it runs at 72-86% of that (PERF.md section
// 6), the tile path within 1.1x of the row path. Without an axis swap a
// thread tones one run of kRun
// values of a row (one 16-byte load of a 16-bit T, two of f32) and stores
// its kRun bytes where the transform puts them, one 8-byte store (flip_x
// reverses the bytes in registers). Under an axis swap a 256-thread block
// tones a tile of kTile x kTile values of one channel into shared memory
// (two runs a thread, rows padded by 4 bytes), then writes the tile's
// kTile output rows (one per input column) as kTile / 8 8-byte stores
// each, a warp covering 4 output rows of 64 bytes. A row that is not whole
// runs (or, under a swap, an output row that is not whole 8-byte stores),
// or an unaligned input, takes the element and byte path of the same
// kernels. f.hh and f.wh hold the planar h and w here.
//
// At gamma != 1 the pow bounds the direct form by instruction issue, as in
// K4 (48% of its bound at gamma 0.6 on 6 x 1080p f16, PERF.md section 6).
// P's table form (a 16-bit T at a pow form without an axis swap, each
// image at least kTableBytes values: ops/hopper/finish.py
// planar_table_form; the launcher refuses a table anywhere else and a
// null one there) is K4's: the same launcher call first enqueues
// tone_table_kernel, each image's 65,536 bit patterns toned once into its
// table, then the rows kernel's table form, a persistent grid of one wave
// of kPlanarTableBlocks blocks an SM shared out evenly over the images,
// gives each value its byte by one shared-memory gather at its 16 bits. A
// block copies its image's table into shared memory (cp.async) while its
// first item's loads are in flight, then walks its share of the image's
// items, kPlanarRuns runs of one row of one channel each, with the next
// item's loads in flight. It stores an item's bytes as one 16-byte store
// where the output rows are whole 16-byte vectors (f.vec == 2), else as the
// direct form stores its runs. The size floor keeps a launch of many small
// images (the tone on any layout, up to 21,845 images) on the direct form,
// where the tables would tone more patterns than the images hold values.

constexpr int kTile = 64;  // the swapped tile's rows and columns

__device__ __forceinline__ uint2 pack8(const unsigned q[kRun]) {
  return make_uint2(q[0] | q[1] << 8 | q[2] << 16 | q[3] << 24,
                    q[4] | q[5] << 8 | q[6] << 16 | q[7] << 24);
}

__device__ __forceinline__ uint2 reverse8(uint2 v) {
  return make_uint2(__byte_perm(v.y, 0, 0x0123), __byte_perm(v.x, 0, 0x0123));
}

// The bytes q of the kRun values from x0 of an input row in its output
// row `row` (no axis swap): one 8-byte store with `vec`, flip_x reversing
// the bytes, else byte by byte up to the row's end.
__device__ __forceinline__ void store_planar_run(const unsigned* q,
                                                 uint8_t* row, int x0,
                                                 const Finish& f) {
  const int w = f.wh;
  if (f.vec) {
    const uint2 v = pack8(q);
    if (f.flip_x) {
      *reinterpret_cast<uint2*>(row + w - x0 - kRun) = reverse8(v);
    } else {
      *reinterpret_cast<uint2*>(row + x0) = v;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int xx = x0 + k;
      if (xx >= w) break;
      row[f.flip_x ? w - 1 - xx : xx] = static_cast<uint8_t>(q[k]);
    }
  }
}

// The table form's blocks an SM and runs an item: the fastest of an A/B on
// an H100 at the resized cell's 6 x 1080p f16 (2 or 3 blocks, 1, 2 or 4
// runs; PERF.md section 6).
constexpr int kPlanarTableBlocks = 3;
constexpr int kPlanarRuns = 2;
constexpr int kPlanarItem = kPlanarRuns * kRun;  // an item's values

// The table form's item e of an image whose planes start at xb: values
// x0 .. x0 + kPlanarItem of its row `row` (c h + y of channel c), `groups`
// items a row; its runs' loads issued into r where e < items (a run past
// the row's end holds zeros, never stored).
template <typename T>
__device__ __forceinline__ void load_planar_item(
    const T* __restrict__ xb, int e, int groups, int items, const Finish& f,
    RawRun<T> (&r)[kPlanarRuns], int& row, int& x0) {
  if (e >= items) return;
  row = e / groups;
  x0 = (e - row * groups) * kPlanarItem;
  const T* src = xb + row * f.wh + x0;
#pragma unroll
  for (int k = 0; k < kPlanarRuns; ++k) {
    const int n = f.wh - x0 - k * kRun;
    if (n > 0) {
      load_run<T>(src + k * kRun, f.vec, n, r[k]);
    } else {
#pragma unroll
      for (int m = 0; m < RawRun<T>::kWords; ++m) r[k].w[m] = 0u;
    }
  }
}

// An item's bytes q in its output row `row`: one 16-byte store where the
// rows are whole 16-byte vectors (f.vec == 2), flip_x reversing the bytes,
// else each run as the direct form stores it.
__device__ __forceinline__ void store_planar_item(
    const unsigned (&q)[kPlanarItem], uint8_t* row, int x0,
    const Finish& f) {
  static_assert(kPlanarItem == 16, "an item is one 16-byte store");
  const int w = f.wh;
  if (f.vec == 2) {
    const uint2 lo = pack8(q), hi = pack8(q + kRun);
    const uint4 v = make_uint4(lo.x, lo.y, hi.x, hi.y);
    if (f.flip_x) {
      *reinterpret_cast<uint4*>(row + w - x0 - 16) = reverse_bytes(v);
    } else {
      *reinterpret_cast<uint4*>(row + x0) = v;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kPlanarRuns; ++k) {
    const int xk = x0 + k * kRun;
    if (xk < w) store_planar_run(q + k * kRun, row, xk, f);
  }
}

// The table form's body: block (256) of grid (blocks an image, n) copies
// image b's table into shared memory while its first item's loads are in
// flight, then walks the image's items blockIdx.x * 256 + t, + gridDim.x *
// 256, ..., the next item's loads in flight while it gathers the bytes of
// the current one, a value's byte at its 16 bits.
template <typename T>
__device__ __forceinline__ void planar_tone_table(
    const T* __restrict__ x, const uint8_t* __restrict__ table,
    uint8_t* __restrict__ out, const Finish& f) {
  extern __shared__ __align__(16) uint8_t ptab[];
  const int b = blockIdx.y, h = f.hh, w = f.wh;
  const int groups = (w + kPlanarItem - 1) / kPlanarItem;
  const int items = 3 * h * groups;
  const int step = gridDim.x * blockDim.x;
  const size_t image = static_cast<size_t>(b) * 3 * h * w;
  const T* xb = x + image;
  uint8_t* ob = out + image;
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  RawRun<T> raw[kPlanarRuns];
  int row = 0, x0 = 0;
  load_planar_item(xb, e, groups, items, f, raw, row, x0);
  const uint8_t* tb = table + static_cast<size_t>(b) * kTableBytes;
  for (int k = threadIdx.x; k < kTableBytes / 16; k += blockDim.x) {
    copy16_async(ptab + 16 * k, tb + 16 * k);
  }
  cp_async_wait();
  __syncthreads();
  for (; e < items; e += step) {
    RawRun<T> next[kPlanarRuns];
    int nrow = 0, nx0 = 0;
    load_planar_item(xb, e + step, groups, items, f, next, nrow, nx0);
    unsigned q[kPlanarItem];
#pragma unroll
    for (int r = 0; r < kPlanarRuns; ++r) {
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const unsigned wd = raw[r].w[k >> 1];
        q[r * kRun + k] = ptab[(k & 1) ? wd >> 16 : wd & 0xFFFFu];
      }
    }
    const int c = row / h, y = row - c * h;
    store_planar_item(q, ob + (c * h + (f.flip_y ? h - 1 - y : y)) * w, x0,
                      f);
    row = nrow;
    x0 = nx0;
#pragma unroll
    for (int r = 0; r < kPlanarRuns; ++r) raw[r] = next[r];
  }
}

// No axis swap. The direct form: block (16, 16) over (runs, rows), grid.z
// = n * 3. The table form (kTable): each value its byte from its image's
// table (tone_table_kernel), planar_tone_table.
template <typename T, bool kLinear, Tone kTone, bool kTable>
__global__ void __launch_bounds__(256, kTable ? kPlanarTableBlocks : 1)
    planar_tone_rows_kernel(const T* __restrict__ x,
                            const float* __restrict__ scal,
                            const uint8_t* __restrict__ table,
                            uint8_t* __restrict__ out, Finish f) {
  if constexpr (kTable) {
    planar_tone_table<T>(x, table, out, f);
  } else {
    const int bc = blockIdx.z, b = bc / 3;
    const int h = f.hh, w = f.wh;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kRun;
    if (y >= h || x0 >= w) return;
    const size_t plane = static_cast<size_t>(bc) * h * w;
    RawRun<T> r;
    load_run<T>(x + plane + y * w + x0, f.vec, w - x0, r);
    unsigned q[kRun];
    tone_run<T, kLinear, kTone>(r, load_scal<kLinear>(scal, b), f, q);
    store_planar_run(q, out + plane + (f.flip_y ? h - 1 - y : y) * w, x0, f);
  }
}

// Axis swap: block 256 over a kTile x kTile tile of one channel, grid
// (column tiles, row tiles, n * 3). Input (y, xc) lands on output row
// flip_x(xc), byte flip_y(y).
template <typename T, bool kLinear, Tone kTone>
__global__ void __launch_bounds__(256)
    planar_tone_swap_kernel(const T* __restrict__ x,
                            const float* __restrict__ scal,
                            uint8_t* __restrict__ out, Finish f) {
  constexpr int kPitch = kTile + 4;
  constexpr int kRuns = kTile * kTile / (kRun * 256);  // runs a thread
  constexpr int kSegs = kTile / 8;  // 8-byte stores of an output row
  __shared__ alignas(16) uint8_t u8[kTile * kPitch];
  const int tid = threadIdx.x, bc = blockIdx.z, b = bc / 3;
  const int h = f.hh, w = f.wh;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const size_t plane = static_cast<size_t>(bc) * h * w;
  const Scal sc = load_scal<kLinear>(scal, b);
  RawRun<T> raw[kRuns];
#pragma unroll
  for (int m = 0; m < kRuns; ++m) {
    const int v = (tid + m * 256) * kRun;
    const int r = v / kTile, c = v - r * kTile;
    const int y = y0 + r, xc = x0 + c;
    const int n = y < h ? w - xc : 0;  // values of the run in the frame
    if (n > 0) {
      load_run<T>(x + plane + y * w + xc, f.vec, n, raw[m]);
    } else {
#pragma unroll
      for (int k = 0; k < RawRun<T>::kWords; ++k) raw[m].w[k] = 0u;
    }
  }
#pragma unroll
  for (int m = 0; m < kRuns; ++m) {
    const int v = (tid + m * 256) * kRun;
    const int r = v / kTile, c = v - r * kTile;
    unsigned q[kRun];
    tone_run<T, kLinear, kTone>(raw[m], sc, f, q);
    const uint2 p = pack8(q);
    auto* d = reinterpret_cast<unsigned*>(u8 + r * kPitch + c);
    d[0] = p.x;
    d[1] = p.y;
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kTile * kSegs / 256; ++m) {
    const int k = tid + m * 256;
    const int xl = k / kSegs, seg = k - xl * kSegs;
    const int xc = x0 + xl, ys = y0 + 8 * seg;
    if (xc >= w || ys >= h) continue;
    uint8_t* orow = out + plane + static_cast<size_t>(
                                      f.flip_x ? w - 1 - xc : xc) * h;
    unsigned q[kRun];
#pragma unroll
    for (int e = 0; e < kRun; ++e) q[e] = u8[(8 * seg + e) * kPitch + xl];
    if (f.vec) {
      const uint2 v = pack8(q);
      if (f.flip_y) {
        *reinterpret_cast<uint2*>(orow + h - ys - kRun) = reverse8(v);
      } else {
        *reinterpret_cast<uint2*>(orow + ys) = v;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        const int y = ys + e;
        if (y >= h) break;
        orow[f.flip_y ? h - 1 - y : y] = static_cast<uint8_t>(q[e]);
      }
    }
  }
}

template <typename T, bool kLinear, Tone kTone>
cudaError_t launch_planar_tone_mode(const T* x, const float* scal,
                                    uint8_t* table, uint8_t* out, int n,
                                    const Finish& f, int swap,
                                    cudaStream_t stream) {
  if (swap) {
    const dim3 grid((f.wh + kTile - 1) / kTile, (f.hh + kTile - 1) / kTile,
                    n * 3);
    planar_tone_swap_kernel<T, kLinear, kTone>
        <<<grid, 256, 0, stream>>>(x, scal, out, f);
    return cudaGetLastError();
  }
  if constexpr (sizeof(T) == 2 && kTone != Tone::kGamma1) {
    if (table != nullptr) {
      static PerDevice resident;
      return launch_table<T, kLinear, kTone>(
          planar_tone_rows_kernel<T, kLinear, kTone, true>, resident,
          3LL * f.hh * ((f.wh + kPlanarItem - 1) / kPlanarItem), scal, table,
          n, f, stream, [&](auto kernel, dim3 grid) {
            kernel<<<grid, 256, kTableBytes, stream>>>(x, scal, table, out,
                                                       f);
          });
    }
  }
  const dim3 block(16, 16);
  const dim3 grid((f.wh + block.x * kRun - 1) / (block.x * kRun),
                  (f.hh + block.y - 1) / block.y, n * 3);
  planar_tone_rows_kernel<T, kLinear, kTone, false>
      <<<grid, block, 0, stream>>>(x, scal, nullptr, out, f);
  return cudaGetLastError();
}

// `table`: the table form's scratch of n * kTableBytes bytes, 16-byte
// aligned, which a 16-bit T at a pow form without an axis swap takes where
// an image holds at least kTableBytes values, and every other launch
// leaves null (refused otherwise).
template <typename T>
int launch_planar_tone(const void* x, const void* scal, void* out, int n,
                       int h, int w, int linear, int tone, float inv_gamma,
                       int swap, int flip_y, int flip_x, void* table,
                       cudaStream_t stream) {
  if (static_cast<long long>(n) * h * w == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (3LL * h * w > 0x7FFFFFFFLL || 3LL * n > 65535 ||
      (h + 15) / 16 > 65535 || !tit::tone_ok(tone)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool table_form =
      sizeof(T) == 2 && tone != 0 && !swap && 3LL * h * w >= kTableBytes;
  if ((table != nullptr) != table_form ||
      (table != nullptr && !tit::aligned16(table))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // vectors: whole runs along each input row and, under a swap, whole
  // 8-byte stores along each output row; 2: also whole 16-byte stores
  // along each output row (the table form's)
  int vec = w % kRun == 0 && (!swap || h % kRun == 0) &&
            tit::aligned16(x) && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  if (vec && w % 16 == 0 && tit::aligned16(out)) vec = 2;
  const Finish f{h, w, flip_y, flip_x, vec, inv_gamma};
  const auto* xin = static_cast<const T*>(x);
  const auto* s = static_cast<const float*>(scal);
  auto* tb = static_cast<uint8_t*>(table);
  auto* o = static_cast<uint8_t*>(out);
  return static_cast<int>(with_tone(linear, tone, [&](auto lin, auto tn) {
    return launch_planar_tone_mode<T, decltype(lin)::value,
                                   decltype(tn)::value>(xin, s, tb, o, n, f,
                                                        swap, stream);
  }));
}

}  // namespace

#define TIT_FINISH_LAUNCHER(suffix, T)                                        \
  extern "C" int tit_finish_planar_u8_##suffix(                               \
      const void* x, const void* scal, void* out, int n, int hh, int wh,      \
      int linear, int tone, float inv_gamma, int swap, int flip_y,            \
      int flip_x, void* table, cudaStream_t stream) {                         \
    return launch<T>(x, scal, out, n, hh, wh, linear, tone, inv_gamma, swap,  \
                     flip_y, flip_x, table, stream);                          \
  }
TIT_FOR_EACH_DTYPE(TIT_FINISH_LAUNCHER)

#define TIT_FINISH_YUV420_LAUNCHER(suffix, T)                               \
  extern "C" int tit_finish_yuv420_##suffix(                                \
      const void* x, const void* scal, void* y, void* vu, int n, int hh,    \
      int wh, int linear, int tone, float inv_gamma, int swap, int flip_y,  \
      int flip_x, const float* coef, const void* inv255, void* table,       \
      cudaStream_t stream) {                                                \
    return launch_yuv420<T>(x, scal, y, vu, n, hh, wh, linear, tone,        \
                            inv_gamma, swap, flip_y, flip_x, coef, inv255,  \
                            table, stream);                                 \
  }
TIT_FOR_EACH_DTYPE(TIT_FINISH_YUV420_LAUNCHER)

#define TIT_FINISH_PLANAR_TONE_LAUNCHER(suffix, T)                        \
  extern "C" int tit_finish_planar_tone_##suffix(                         \
      const void* x, const void* scal, void* out, int n, int h, int w,    \
      int linear, int tone, float inv_gamma, int swap, int flip_y,        \
      int flip_x, void* table, cudaStream_t stream) {                     \
    return launch_planar_tone<T>(x, scal, out, n, h, w, linear, tone,     \
                                 inv_gamma, swap, flip_y, flip_x, table,  \
                                 stream);                                 \
  }
TIT_FOR_EACH_DTYPE(TIT_FINISH_PLANAR_TONE_LAUNCHER)
