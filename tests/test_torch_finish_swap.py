"""K4's axis-swap kernel (``csrc/finish.cu`` ``finish_swap_kernel``) in
numpy: the index arithmetic the card runs, with the tone left out.

Contracts:
  * the walk: each block's place, advanced by its fixed stride with
    ``SwapWalk.advance`` (two compares, no division), is the place the
    divisions give, and the blocks together visit each tile exactly once;
  * the staged rows' swizzle (``SwapTile::chunk_at``): each row's chunks
    fill its own slots, and the eight lanes of a quarter warp, on eight
    consecutive rows, read one chunk from eight distinct 16-byte bank
    groups;
  * the data movement: the copies into a stage, each thread's run read back
    from it (or, off the staged path, from device memory element by
    element), the byte pairs in the output buffer and the stores under the
    flips move each input byte where ``planar_from_phases_transformed``
    puts it, under the four transforms that swap the axes, in both element
    sizes, at frames whose tiles are cut and on the element path.

The constants mirror the kernel's (a block of 512 threads, tiles of 64 x
64 half-res pixels, 16-byte chunks).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from taichi_image_tpu_torch.ops.bayer import (  # noqa: E402
    _TRANSFORM_SFF, planar_from_phases_transformed)
from taichi_image_tpu_torch.ops.interpolate import ImageTransform  # noqa: E402

THREADS, ROWS, RUN = 512, 64, 8       # kSwapThreads, kSwapRows, kV
COLS = THREADS * RUN // ROWS          # kSwapCols
RUNS = COLS // RUN                    # kSwapRuns
SWAPS = [t for t in ImageTransform if _TRANSFORM_SFF[t][0]]


class Walk:
  """``SwapWalk``: the stride taken apart once, then advanced."""

  def __init__(self, tiles_x, tiles_y, step):
    self.tiles_x, self.tiles_y, self.step = tiles_x, tiles_y, step
    q = step // tiles_x
    self.dx = step - q * tiles_x
    self.dbc = q // tiles_y
    self.dy = q - self.dbc * tiles_y

  def at(self, t):
    row = t // self.tiles_x
    bc = row // self.tiles_y
    return [t, t - row * self.tiles_x, row - bc * self.tiles_y, bc]

  def advance(self, a):
    a[0] += self.step
    a[1] += self.dx
    a[2] += self.dy
    a[3] += self.dbc
    if a[1] >= self.tiles_x:
      a[1] -= self.tiles_x
      a[2] += 1
    if a[2] >= self.tiles_y:
      a[2] -= self.tiles_y
      a[3] += 1


@pytest.mark.parametrize("tiles_x,tiles_y,channels,grid", [
    (30, 17, 18, 132), (30, 17, 18, 264), (15, 9, 3, 264), (1, 1, 3, 3),
    (2, 100, 3, 7), (7, 3, 12, 5), (4, 4, 6, 97)],
    ids=["6x4K f32 grid", "6x4K bf16 grid", "1080p", "one tile a channel",
         "tall", "grid under a row", "grid over a channel"])
def test_walk_visits_each_tile_once(tiles_x, tiles_y, channels, grid):
  tiles = tiles_x * tiles_y * channels
  grid = min(grid, tiles)   # the launcher's grid: at most a block a tile
  walk = Walk(tiles_x, tiles_y, grid)
  seen = []
  for block in range(grid):
    a = walk.at(block)
    ahead = list(a)
    walk.advance(ahead)   # the ring's place, a stride ahead
    while a[0] < tiles:
      assert a == walk.at(a[0])
      assert ahead == walk.at(ahead[0])
      seen.append(a[0])
      walk.advance(a)
      walk.advance(ahead)
  assert sorted(seen) == list(range(tiles))


def chunk_at(row, c, itemsize):
  """``SwapTile::chunk_at`` in values of the element size."""
  per = 16 // itemsize
  row_chunks = COLS // per
  line_rows = 8 // row_chunks if row_chunks < 8 else 1
  swz = row_chunks if row_chunks < 8 else 8
  return (row * row_chunks + (c ^ (row // line_rows % swz))) * per


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16-f16", "f32"])
def test_swizzle_fills_each_row_and_spreads_the_banks(itemsize):
  per = 16 // itemsize
  row_chunks = COLS // per
  for row in range(4 * ROWS):
    slots = sorted(chunk_at(row, c, itemsize) for c in range(row_chunks))
    assert slots == [(row * row_chunks + c) * per for c in range(row_chunks)]
  # a quarter warp: lanes on rows 8 q .. 8 q + 7, one chunk each
  for first in range(0, 4 * ROWS, 8):
    for c in range(row_chunks):
      groups = {chunk_at(first + i, c, itemsize) * itemsize // 16 % 8
                for i in range(8)}
      assert len(groups) == 8


def emulate(x, itemsize, transform, vec):
  """The kernel's bytes for the (n, 12, hh, wh) codes ``x`` (0..255, each
  value's byte as the tone would give it), every tile walked in order."""
  n, _, hh, wh = x.shape
  _, fy, fx = _TRANSFORM_SFF[transform]
  per = 16 // itemsize
  row_chunks = COLS // per
  h, w = 2 * hh, 2 * wh
  out = np.full((n, 3, w, h), -1, np.int64)
  tid = np.arange(THREADS)
  r = tid // 32 // RUNS * 32 + tid % 32     # each thread's tile row
  cr = tid // 32 % RUNS * RUN               # its run's first column
  for bc in range(3 * n):
    b, c = divmod(bc, 3)
    for ty in range(-(-hh // ROWS)):
      for tx in range(-(-wh // COLS)):
        i0, jt = ty * ROWS, tx * COLS
        stage = np.full(4 * ROWS * COLS, -7, np.int64)   # stale values
        if vec:
          for k in range(4 * ROWS * row_chunks):
            row, cv = divmod(k, row_chunks)
            pp, rr = divmod(row, ROWS)
            y, xc = i0 + rr, jt + cv * per
            if y < hh and xc < wh:
              ch = (pp & 1) * 6 + (pp >> 1) * 3 + c
              at = chunk_at(row, cv, itemsize)
              stage[at:at + per] = x[b, ch, y, xc:xc + per]
        s = np.zeros((2 * COLS, ROWS), np.int64)
        for t in tid:
          q = {}
          for pc in range(2):
            for pr in range(2):
              pp = pr * 2 + pc
              if vec:
                run = np.concatenate([
                    stage[chunk_at(pp * ROWS + r[t], cr[t] // per + hv,
                                   itemsize):][:per]
                    for hv in range(RUN // per)])
              else:
                y, j0 = i0 + r[t], jt + cr[t]
                run = np.zeros(RUN, np.int64)
                if y < hh and j0 < wh:
                  cols = min(RUN, wh - j0)
                  run[:cols] = x[b, pc * 6 + pr * 3 + c, y, j0:j0 + cols]
              q[pr, pc] = run
            for e in range(RUN):
              s[2 * (cr[t] + e) + pc, r[t]] = q[0, pc][e] | q[1, pc][e] << 8
        pairs = np.stack([s & 0xFF, s >> 8], -1).reshape(2 * COLS, 2 * ROWS)
        for v in range(2 * COLS * (2 * ROWS // 16)):
          xl, mv = divmod(v, 2 * ROWS // 16)
          xx, y0 = 2 * jt + xl, 2 * i0 + 16 * mv
          if xx >= w or y0 >= h:
            continue
          row = w - 1 - xx if fx else xx
          src = pairs[xl, 16 * mv:16 * mv + 16]
          if vec:
            if fy:
              out[b, c, row, h - y0 - 16:h - y0] = src[::-1]
            else:
              out[b, c, row, y0:y0 + 16] = src
          else:
            for e in range(min(16, h - y0)):
              y = y0 + e
              out[b, c, row, h - 1 - y if fy else y] = src[e]
  return out


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16-f16", "f32"])
@pytest.mark.parametrize("transform", SWAPS, ids=[t.value for t in SWAPS])
@pytest.mark.parametrize("shape,vec", [
    ((1, 12, 64, 64), True), ((2, 12, 72, 80), True),
    ((1, 12, 19, 50), False), ((1, 12, 8, 136), True)],
    ids=["one tile", "cut tiles", "element path", "one short tile row"])
def test_data_movement_is_the_transform(itemsize, transform, shape, vec):
  # the launcher's `vec`: whole runs along each row and whole 16-byte
  # vectors along each output row of 2 hh bytes
  assert vec == (shape[3] % RUN == 0 and shape[2] % 8 == 0)
  x = np.random.default_rng(26).integers(0, 256, shape)
  want = planar_from_phases_transformed(
      torch.from_numpy(x.astype(np.uint8)), transform).numpy()
  got = emulate(x, itemsize, transform, vec)
  np.testing.assert_array_equal(got, want)
