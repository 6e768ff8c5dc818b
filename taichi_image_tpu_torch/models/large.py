"""Large frames (8K and up): ``process_banded``, its drivers and band plans.

Counterpart of ``taichi_image_tpu/models/large.py``, which runs a large
frame as a sequence of row-band programs. On the H100 a 6 x 8K set fits
in device memory whole, so the default driver is the whole-frame step,
:func:`fused_isp_step`, and its result is ``process``'s. The band loop
(``driver="loop"`` or ``"scan"``) gives the same bits more slowly; it is
kept for the JAX package's API, whose callers can force it, and it is the
one path that runs K2's banded mode (the finish spec's strip gates). It
does not hold less than a band's share of the frame: the metering needs
every band's sample before the first map, so every band's x12 is alive at
once. What it saves over the whole-frame step is that x12 and p are not
both whole at once: each band's x12 is dropped once its p exists, and each
p once its output exists. A band is read with one phase row (two
full-res rows) of halo on each side, zeros beyond the image:

  per band   decode (K1, K1's packed16 mode or the CFA split) of the
             band's raw rows -> banded K2: the top and bottom factors at
             the band's true image edge (the finish spec's top_row = 1 on
             the first band, bot_row = hb on the last, -1 elsewhere), only
             the band's own rows stored, with their metering sample
  once       the EMA metering over the samples joined along H
  per band   K3 and the band's per-image max; then the max of those
  per band   K4 (RGB or its I420 mode, the transform in its stores) with
             the frame's max, or K4's linear mode
  once       the bands joined where the transform puts them

With a resize plan the bands partition the output rows; each band
demosaics the input rows its bilinear taps span (plus the halo) and runs
K12 with the frame's taps for its rows (``resize.band_taps``), then K3
and the resize route's tail per band. The row-sharded steps
(``parallel/spatial.py``) run the same band body (:func:`band_x12`,
:func:`resize_band`, :func:`finish_resized`) on each rank's rows.

Band starts are multiples of lcm(stride / 2, 16) (``band_plan``), so the
joined samples are the whole frame's sample tensor and the max of the
band maxima is the frame's: every driver is bitwise ``process`` (the JAX
package holds its bands to 1 u8 count).

The drivers differ from the JAX package's where its reasons were the
TPU's: ``"flat"`` is the whole-frame step here, for every raw format,
working dtype and frame width (the JAX package refuses f16 and widths
that its kernels cannot tile), but not with a resize plan, which neither
package's flat form has; ``"scan"`` is the band loop over
``scan_band_size``'s equal bands, since the port has no ``lax.scan``.
"""

from __future__ import annotations

import numpy as np
import torch

from taichi_image_tpu_torch import types
from taichi_image_tpu_torch.models import camera_isp as ci
from taichi_image_tpu_torch.ops import bayer as bayer_ops
from taichi_image_tpu_torch.ops import interpolate
from taichi_image_tpu_torch.ops.hopper import demosaic as hopper_dm
from taichi_image_tpu_torch.ops.hopper import finish as hopper_finish
from taichi_image_tpu_torch.ops.hopper import reinhard as hopper_reinhard
from taichi_image_tpu_torch.ops.hopper import resize as hopper_resize
from taichi_image_tpu_torch.ops.hopper import yuv420 as hopper_yuv420
from taichi_image_tpu_torch.ops.interpolate import (ImageTransform,
                                                    _axis_samples)

__all__ = ["process_banded", "band_plan", "band_plan_rows",
           "scan_band_size"]

DRIVERS = ("auto", "loop", "scan", "flat")

# The largest band, in phase rows, that the band drivers run: it bounds a
# band's rows (so n_bands is raised on tall frames), which keeps this
# module's plans those of the JAX package, band for band. It does not bound
# the loop's memory: every band's x12 is alive until the metering is done.
_BAND_ROWS_MAX = 280


def scan_band_size(n_rows: int, n_bands: int, q: int):
  """Equal-band size for the scan driver: the largest multiple of ``q``
  that DIVIDES ``n_rows`` and does not exceed the loop driver's band size
  for the same ``n_bands`` (nor ``_BAND_ROWS_MAX``). None when no such
  divisor exists (odd row counts — the loop driver handles those)."""
  if n_rows < q or n_rows % q:
    return None
  nb = max(1, min(n_bands, n_rows // q))
  per = (-(-n_rows // nb) + q - 1) // q * q
  best = None
  for cand in range(q, min(per, n_rows, _BAND_ROWS_MAX) + 1, q):
    if n_rows % cand == 0:
      best = cand
  return best


def band_plan_rows(n_rows: int, n_bands: int, q: int,
                   q_fallback: int = None):
  """Split ``n_rows`` into ``<= n_bands`` bands whose starts are
  multiples of ``q`` (or ``q_fallback`` when fewer than ``q`` rows
  exist; a single band when even that doesn't fit). Returns
  [(r0, r1), ...]."""
  if n_rows < q:
    q = q_fallback if q_fallback else 1
    if n_rows < q:
      return [(0, n_rows)]
  n_bands = max(1, min(n_bands, n_rows // q))
  per = (-(-n_rows // n_bands) + q - 1) // q * q  # round band size to q
  edges = []
  r = 0
  while r < n_rows:
    edges.append((r, min(r + per, n_rows)))
    r += per
  return edges


def band_plan(hh: int, n_bands: int, stride: int = 8):
  """Split hh half-res rows into bands whose starts align to the
  half-res metering grid (stride//2), sizes quantized to
  lcm(stride//2, 16) (the JAX package's plan). Returns [(r0, r1), ...]."""
  return band_plan_rows(hh, n_bands,
                        int(np.lcm(max(stride // 2, 1), 16)),
                        q_fallback=max(stride // 2, 1))


def _fit_bands(seed: int, n_bands: int, plan_fn, extent_fn, n_max: int):
  """Raise ``n_bands`` (a user MINIMUM) until no band spans more than
  ``_BAND_ROWS_MAX`` input phase rows — the q-rounding of band sizes and
  (in resize mode) the input span of a band's bilinear taps can both
  overshoot a naive rows/_BAND_ROWS_MAX split. ``plan_fn(n)`` builds the
  candidate plan, ``extent_fn(plan)`` its largest input-phase-row
  extent, ``n_max`` the n at which bands reach the plan's quantum
  (``n_rows // q``) so a finer split truly cannot exist. Consecutive
  plans can be equal long before that bound (q-rounding plateaus), so
  plateaus are stepped over rather than returned. Past ``n_max`` the
  finest plan is returned. Returns (n, plan)."""
  n = max(n_bands, seed, 1)
  while True:
    plan = plan_fn(n)
    if extent_fn(plan) <= _BAND_ROWS_MAX or n >= n_max:
      return n, plan
    n += 1


def _as_words(x: torch.Tensor) -> torch.Tensor:
  """``x`` viewed as the widest integer type whose size divides its rows'
  bytes, so that a copy of its rows moves 8-byte words (a strided copy of
  u8 elements moves about a byte per thread); uint16 at least as int16,
  since uint16 has few torch ops."""
  row = x.shape[-1] * x.element_size()
  if x.is_contiguous():
    for dt in (torch.int64, torch.int32, torch.int16):
      size = dt.itemsize
      if (size >= x.element_size() and row % size == 0
          and x.data_ptr() % size == 0):
        return x.view(dt)
  return x.view(torch.int16) if x.dtype == torch.uint16 else x


def _band_raws(raws: torch.Tensor, p0: int, p1: int) -> torch.Tensor:
  """The full-res raw rows of half-res rows [p0 - 1, p1 + 1): the band
  with one phase row of halo on each side, zero rows beyond the image;
  one contiguous copy (the decode takes contiguous raws, and the rows of
  a band are not contiguous across the cameras)."""
  n, h, _ = raws.shape
  lo, hi = max(2 * p0 - 2, 0), min(2 * p1 + 2, h)
  top, bot = (2 if p0 == 0 else 0), (2 if 2 * p1 == h else 0)
  src = _as_words(raws)
  band = src.new_empty((n, hi - lo + top + bot, src.shape[-1]))
  band[:, :top] = 0
  band[:, top:top + hi - lo] = src[:, lo:hi]
  band[:, top + hi - lo:] = 0
  return band.view(raws.dtype)


def band_x12(band, p0, p1, hh, fmt, ids_format, wd, pattern, cc,
             sample_step):
  """Decode and demosaic half-res rows [p0, p1) of a frame of hh rows from
  ``band``, the frame's raw rows [2 p0 - 2, 2 p1 + 2) with zero rows
  beyond the image (what :func:`_band_raws` copies out of a whole frame,
  or what a row shard holds with its halo): ``(x12 (N, 12, p1 - p0, wh),
  sample or None)``, each pixel's value the whole frame's (the halo rows
  give the stencil its neighbours, and the top and bottom factors apply
  only at the image's own edges)."""
  phases = ci._decode_checked(band, fmt, wd, ids_format, "auto")
  hb = p1 - p0
  wh = phases.shape[-1]
  fin = bayer_ops._finish_spec_for(pattern, "mhc", hb + 2, wh, cc, wd,
                                   top_row=1 if p0 == 0 else -1,
                                   bot_row=hb if p1 == hh else -1)
  return hopper_dm.demosaic_stencil(
      phases, bayer_ops._demosaic_tables(pattern, "mhc"), fin, sample_step,
      rows=(1, hb + 1))


def _band_x12(raws, p0, p1, hh, fmt, ids_format, wd, pattern, cc,
              sample_step):
  """:func:`band_x12` of half-res rows [p0, p1) of the whole frame
  ``raws``."""
  return band_x12(_band_raws(raws, p0, p1), p0, p1, hh, fmt, ids_format, wd,
                  pattern, cc, sample_step)


def resize_in_rows(r_lo, r_hi, o0: int, o1: int, hh: int):
  """The half-res input rows [p0, p1) that output rows [o0, o1) of a
  resize tap (``r_lo``, ``r_hi``: the frame's full-res taps per output
  row)."""
  return int(r_lo[o0]) // 2, min(int(r_hi[o1 - 1]) // 2 + 1, hh)


def resize_band(x12, out_rows, in_rows, hh, wh, size, scale_yx):
  """Output rows ``out_rows`` = (o0, o1) of the frame's resize from
  ``x12``, the x12 of its half-res input rows ``in_rows``: K12 with the
  frame's taps for those rows (``resize.band_taps``). Planar
  (N, 3, o1 - o0, w_out) of x12's dtype."""
  taps = hopper_resize.band_taps(hh, wh, size, scale_yx, out_rows, in_rows,
                                 x12.device)
  return hopper_resize.resize_x12(x12, taps)


def finish_resized(x, scal, gamma, tonemap: str, transform: ImageTransform,
                   color_format: str):
  """The resize route's tail on planar ``x`` (K3's map, or the resized
  image under the linear tonemap) with ``scal`` (the max, or the linear
  scalars): planar u8 RGB under ``transform`` (P), or with I420 output
  the tonemap, the transform and I420 in one kernel."""
  if color_format == "yuv420":
    return hopper_yuv420.yuv420_planar_tone(x, scal, gamma, tonemap,
                                            transform)
  return hopper_finish.finish_planar_tone(x, scal, gamma, tonemap,
                                          transform)


def _join(outs, transform: ImageTransform, color_format: str):
  """The bands' outputs, each already transformed, joined where the
  transform puts the rows of the input: along the output's rows, or its
  columns under a transform that swaps the axes, in reverse order where
  it flips the input's rows. Planar RGB (N, 3, ., .) or (Y, VU)."""
  swap, flip_rows, _ = bayer_ops._TRANSFORM_SFF[transform]
  if flip_rows:
    outs = outs[::-1]
  if color_format == "yuv420":
    y_axis, vu_axis = (2, 3) if swap else (1, 2)
    if len(outs) == 1:
      return outs[0]
    return (torch.cat([o[0] for o in outs], dim=y_axis),
            torch.cat([o[1] for o in outs], dim=vu_axis))
  if len(outs) == 1:
    return outs[0].contiguous()
  return torch.cat(outs, dim=3 if swap else 2)


def _tone_inputs(xs, mt, tonemap, color_adapt):
  """What the finish of each band takes: the bands' x (linear) or their
  K3 maps, and M's linear scalars or the frame's per-image max (the max
  of the band maxima). Under Reinhard ``xs`` is emptied as the maps are
  made, so that a band's x is freed once its p exists."""
  if tonemap == "linear":
    return xs, mt.lin
  ca_mode = float(color_adapt) != 0.0
  ps, maxes = [], []
  while xs:
    p, m = hopper_reinhard.reinhard_map(xs.pop(0), mt.scal, ca_mode)
    ps.append(p)
    maxes.append(m)
  return ps, torch.stack(maxes).amax(dim=0)


def _finish_bands(srcs, finish):
  """``finish`` of each band, ``srcs`` emptied as it goes (a band's input
  is freed once its output exists)."""
  outs = []
  while srcs:
    outs.append(finish(srcs.pop(0)))
  return outs


def _phase_loop(raws, prev, t, bands, *, fmt, ids_format, wd, pattern, cc,
                stride, gamma, intensity, light_adapt, color_adapt, tonemap,
                color_format, transform):
  """The band loop without a resize: (metrics, output)."""
  hh = raws.shape[-2] // 2
  x12s, samples = (list(v) for v in zip(*(
      _band_x12(raws, p0, p1, hh, fmt, ids_format, wd, pattern, cc,
                max(stride // 2, 1)) for p0, p1 in bands)))
  mt = ci._meter(torch.cat(samples, dim=2), prev, t, intensity=intensity,
                 light_adapt=light_adapt, color_adapt=color_adapt)
  srcs, scal = _tone_inputs(x12s, mt, tonemap, color_adapt)
  outs = _finish_bands(srcs, lambda x: ci._finish(
      x, scal, gamma, tonemap, transform, color_format, "auto"))
  return mt.metrics, _join(outs, transform, color_format)


def _resize_loop(raws, prev, t, n_bands, resize_plan, *, fmt, ids_format,
                 wd, pattern, cc, stride, gamma, intensity, light_adapt,
                 color_adapt, tonemap, color_format, transform):
  """The band loop with a resize plan: the bands partition the output
  rows (starts on the metering grid), each demosaics the input rows its
  taps span and resizes with the frame's taps: (metrics, output)."""
  size, scale = resize_plan
  h, w = raws.shape[-2], ci.decoded_width(fmt, raws.shape[-1])
  hh, wh = h // 2, w // 2
  sy, sx = ci._plan_scales(h, w, size, scale)
  h_out = int(size[1])
  r_lo, r_hi, _ = _axis_samples(h_out, h, sy)

  def extent(plan):
    return max(p1 - p0 for p0, p1 in (resize_in_rows(r_lo, r_hi, *b, hh)
                                      for b in plan))

  # seeded from input phase rows: a band's size follows the input rows its
  # taps span, not its output rows
  q_rs = int(np.lcm(stride, 16))
  _, obands = _fit_bands(
      -(-hh // _BAND_ROWS_MAX), n_bands,
      lambda n: band_plan_rows(h_out, n, q_rs, q_fallback=stride), extent,
      n_max=max(1, h_out // (q_rs if h_out >= q_rs else stride)))
  size_i, scale_yx = (int(size[0]), h_out), (float(sy), float(sx))
  rgbs, samples = [], []
  for o0, o1 in obands:
    p0, p1 = resize_in_rows(r_lo, r_hi, o0, o1, hh)
    x12 = _band_x12(raws, p0, p1, hh, fmt, ids_format, wd, pattern, cc,
                    0)[0]
    rgbs.append(resize_band(x12, (o0, o1), (p0, p1), hh, wh, size_i,
                            scale_yx))
    samples.append(bayer_ops.subsample_hw(rgbs[-1], stride, stride))
  mt = ci._meter(torch.cat(samples, dim=2), prev, t, intensity=intensity,
                 light_adapt=light_adapt, color_adapt=color_adapt)
  srcs, scal = _tone_inputs(rgbs, mt, tonemap, color_adapt)
  outs = _finish_bands(srcs, lambda x: finish_resized(
      x, scal, gamma, tonemap, transform, color_format))
  return mt.metrics, _join(outs, transform, color_format)


def process_banded(raws, prev, t, *, n_bands, fmt="packed12",
                   ids_format=False, work_dtype, pattern, cc=None,
                   stride=8, gamma=1.0, intensity=1.0, light_adapt=1.0,
                   color_adapt=0.0, tonemap="reinhard",
                   color_format="rgb", resize_plan=None,
                   transform=ImageTransform.none, driver="auto",
                   device="cuda"):
  """The fused ISP step of a large frame set.

  Same arguments and results as :func:`fused_isp_step`: ``(metrics,
  planar u8 (N, 3, H', W'))``, or the I420 pair with
  ``color_format='yuv420'``. ``raws`` is a tensor, taken on its own
  device, or an array, moved to ``device`` (the card by default); ``prev``
  a (9,) tensor or array, moved to the raws' device.

  ``driver``: ``"auto"`` and ``"flat"`` run the whole-frame step;
  ``"loop"`` runs the band loop over ``band_plan``'s bands, ``"scan"``
  over ``scan_band_size``'s equal ones (refused with a resize plan or
  when no equal-band plan exists). All give ``process``'s bits.
  ``n_bands`` is a minimum: it is raised until no band exceeds
  ``_BAND_ROWS_MAX`` phase rows. The band drivers need an even metering
  stride, as the JAX package's do, and frames of at least 4 x 4 pixels.
  """
  if tonemap not in ("reinhard", "linear"):
    raise ValueError(f"unknown tonemap {tonemap}")
  if color_format not in ("rgb", "yuv420"):
    raise ValueError(f"unknown color_format {color_format!r}")
  if stride % 2 != 0:
    raise ValueError("banded processing needs an even metering stride")
  if driver not in DRIVERS:
    raise ValueError(f"unknown driver {driver!r}")
  raws = types.as_tensor(raws, device)
  prev = (prev.to(raws.device, torch.float32) if torch.is_tensor(prev)
          else torch.tensor(np.asarray(prev, np.float32),
                            device=raws.device))
  wd = types.canonical_dtype(work_dtype)
  h = raws.shape[-2]
  hh_in = h // 2
  if driver == "flat" and resize_plan is not None:
    raise ValueError(
        "flat driver runs the whole-frame step without a resize_plan, as "
        "the JAX package's flat form does — use driver='auto' (the same "
        "step, with the resize) or 'loop'")
  if driver in ("auto", "flat"):
    return ci.fused_isp_step(
        raws, prev, t, gamma, intensity, light_adapt, color_adapt, fmt,
        ids_format, wd, pattern, cc, resize_plan, stride, transform,
        tonemap, color_format=color_format)
  if hh_in < 2 or ci.decoded_width(fmt, raws.shape[-1]) < 4:
    raise ValueError("the band drivers need frames of at least 4x4 pixels "
                     "— use driver='auto'")
  if color_format == "yuv420" and resize_plan is not None:
    w_out, h_out = resize_plan[0]
    hopper_yuv420.check_even(*interpolate.transformed_size(
        (w_out, h_out), transform)[::-1])
  kw = dict(fmt=fmt, ids_format=ids_format, wd=wd, pattern=pattern, cc=cc,
            stride=stride, gamma=gamma, intensity=intensity,
            light_adapt=light_adapt, color_adapt=color_adapt,
            tonemap=tonemap, color_format=color_format, transform=transform)
  if resize_plan is None:
    q_loop = int(np.lcm(max(stride // 2, 1), 16))
    if hh_in < q_loop:  # band_plan falls back to the stride quantum
      q_loop = max(stride // 2, 1)
    n_bands, bands = _fit_bands(
        -(-hh_in // _BAND_ROWS_MAX), n_bands,
        lambda n: band_plan(hh_in, n, stride),
        lambda plan: max(r1 - r0 for r0, r1 in plan),
        n_max=max(1, hh_in // q_loop))
    if driver == "scan":
      b_scan = scan_band_size(hh_in, n_bands,
                              int(np.lcm(max(stride // 2, 1), 16)))
      if b_scan is not None:
        bands = [(r, r + b_scan) for r in range(0, hh_in, b_scan)]
    if driver == "loop" or b_scan is not None:
      return _phase_loop(raws, prev, t, bands, **kw)
  elif driver == "loop":
    return _resize_loop(raws, prev, t, n_bands, resize_plan, **kw)
  raise ValueError(
      "scan driver needs equal aligned bands and no resize_plan — "
      f"no equal-band plan for {h // 2} half-res rows "
      f"(q={int(np.lcm(max(stride // 2, 1), 16))}) or resize set; "
      "use driver='auto' or 'loop'")
