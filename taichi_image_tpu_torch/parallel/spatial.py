"""Spatial (intra-frame) sharding: each image's ROWS split over the ranks
of a mesh axis, with a halo exchange at the shard borders.

Counterpart of ``taichi_image_tpu/parallel/spatial.py``. Each rank holds
rows [i h_l, (i + 1) h_l) of every frame's raws, and runs on them the
large-frame loop's band body (``models/large.py``): the decode of its
rows with their halo, K2's banded mode with the top and bottom factors
at the frame's own edges only (the first rank's top, the last rank's
bottom), and with a resize K12 on the frame's taps for its output rows.
The decode is row-local for every raw format, so the halo is exchanged
once per step, in raw rows, before the decode: the previous rank's last
two rows (one phase row, the stencil's reach) and the next rank's first
rows, two more than the phase rows a resize's taps reach past the shard
(``_spatial_resize_plan``); zero rows beyond the frame, as the band loop
reads them. The exchange is one ``all_gather`` of each rank's border rows
over the axis (the collective that NCCL and gloo both take for CUDA
tensors). The metering is reduced over the axis (over the whole mesh for
the grid step), and each image's Reinhard max, after K3 and before K4,
by one all_reduce MAX over the axis. Each rank's output is its band,
already transformed (RGB or the I420 pair: rows per shard are a multiple
of 8, so no 2x2 chroma block straddles two ranks); :func:`gather_rows`
joins the bands where the transform puts them, for callers that want the
whole frame.

Alignment (``ValueError``s, with the JAX package's meaning): rows per
shard a multiple of 8 (Bayer parity and the metering grid); with a
resize, the resized height dividing over the shards, resized rows per
shard a multiple of the stride, and taps that shift with the shard (no
f32 drift) and need no top halo; at least 3 half-res rows per shard; a
known ``color_format``. Two more than the JAX package: the metering
stride must be even, and, without a resize, divide the rows per shard.
The JAX step samples phase (0, 0) at ``stride // 2`` on every shard
(``taichi_image_tpu/parallel/spatial.py:351-354``), which is the
unsharded grid only for an even stride that divides the shard's rows;
at stride 7 it disagrees with its own unsharded step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from taichi_image_tpu_torch import types
from taichi_image_tpu_torch.models import camera_isp as ci
from taichi_image_tpu_torch.models import large
from taichi_image_tpu_torch.ops import bayer as bayer_ops
from taichi_image_tpu_torch.ops.hopper import demosaic as hopper_dm
from taichi_image_tpu_torch.ops.hopper import yuv420 as hopper_yuv420
from taichi_image_tpu_torch.ops.interpolate import (ImageTransform,
                                                    _axis_samples,
                                                    transformed_size)
from taichi_image_tpu_torch.parallel.runtime import (CAMERA_AXIS,
                                                     mesh_device, mesh_group)
from taichi_image_tpu_torch.parallel.sharding import (_all_gather, _axis,
                                                      _n_total)

ROW_AXIS = "rows"

__all__ = ["ROW_AXIS", "shard_rows", "make_spatial_isp_step",
           "make_grid_isp_step", "demosaic_phases_spatial", "gather_rows"]

# full-res raw rows above a shard that its band reads: one phase row, the
# stencil's reach
_ABOVE = 2


def _contiguous(t: torch.Tensor) -> torch.Tensor:
  """``t`` contiguous; a uint16 tensor through its int16 bits (torch
  copies few uint16 tensors)."""
  if t.dtype == torch.uint16:
    return t.view(torch.int16).contiguous().view(torch.uint16)
  return t.contiguous()


def shard_rows(batch, mesh, axis_name: str = ROW_AXIS) -> torch.Tensor:
  """This rank's contiguous slice of the ROW axis of ``batch`` (the whole
  (N, H, ...) batch, or an (H, ...) array when 1-D) on its device.
  Raises ``ValueError`` unless the rows divide over the axis."""
  i, n = _axis(mesh, axis_name)
  batch = types.as_tensor(batch)
  ax = 1 if batch.ndim >= 2 else 0
  h = batch.shape[ax]
  if h % n:
    raise ValueError(f"{h} rows do not divide over the {n} ranks of mesh "
                     f"axis {axis_name!r}")
  k = h // n
  part = batch.narrow(ax, i * k, k)
  return _contiguous(types.to_device(_contiguous(part), mesh_device(mesh)))


def gather_rows(out, mesh, transform: ImageTransform = ImageTransform.none,
                color_format: str = "rgb", axis_name: str = ROW_AXIS):
  """The whole frames from each rank's band of the row-sharded step's
  output (planar u8, or the I420 pair ``(Y, VU)``, each band already
  under ``transform``): every band gathered over ``axis_name`` and the
  bands joined where the transform puts the rows of the input (along the
  output's rows, or its columns under a transform that swaps the axes,
  in reverse order where it flips them), on every rank. For tests and
  callers that want the whole frame; the step itself never gathers."""
  group = mesh.get_group(axis_name)
  if color_format == "yuv420":
    ys, vus = (_all_gather(o, group) for o in out)
    return large._join(list(zip(ys, vus)), transform, color_format)
  return large._join(_all_gather(out, group), transform, color_format)


def _border_rows(bytes_, idx, n, below, group):
  """The halo exchange: every rank's first ``below`` and last ``_ABOVE``
  raw rows (as bytes) gathered over the axis. Returns (the previous
  rank's last ``_ABOVE`` rows, the next rank's first ``below`` rows),
  None past the frame's edges."""
  hl = bytes_.shape[1]
  send = torch.cat([bytes_[:, :below], bytes_[:, hl - _ABOVE:]], dim=1)
  parts = _all_gather(send, group)
  up = parts[idx - 1][:, below:] if idx > 0 else None
  down = parts[idx + 1][:, :below] if idx < n - 1 else None
  return up, down


def _halo_band(raws, idx, n, below, rows, group):
  """The frame's raw rows ``rows`` = [a, b) for this rank's band, from
  its own rows (``raws``, rows [idx h_l, (idx + 1) h_l)) and its
  neighbours' borders, zero rows beyond the frame: one contiguous (N,
  b - a, W_raw) tensor of the raws' dtype."""
  nb, hl, _ = raws.shape
  b8 = _contiguous(raws).view(torch.uint8)
  up, down = _border_rows(b8, idx, n, below, group)
  s0 = idx * hl
  a, b = rows

  def zeros(k):
    return b8.new_zeros((nb, k, b8.shape[-1]))

  pieces = []
  if a < s0:
    pieces.append(up[:, _ABOVE - (s0 - a):] if up is not None
                  else zeros(s0 - a))
  pieces.append(b8[:, max(a, s0) - s0:min(b, s0 + hl) - s0])
  if b > s0 + hl:
    pieces.append(down[:, :b - s0 - hl] if down is not None
                  else zeros(b - s0 - hl))
  return torch.cat(pieces, dim=1).view(raws.dtype)


def _exchange_phase_rows(x, idx, n, group):
  """One halo phase row each side of the (N, C, hh_l, wh) shard ``x``,
  from its neighbours (zeros beyond the frame): (N, C, hh_l + 2, wh)."""
  parts = _all_gather(torch.cat([x[:, :, :1], x[:, :, -1:]], dim=2), group)
  zero = torch.zeros_like(x[:, :, :1])
  top = parts[idx - 1][:, :, 1:] if idx > 0 else zero
  bot = parts[idx + 1][:, :, :1] if idx < n - 1 else zero
  return torch.cat([top, x, bot], dim=2)


def _cc_key(cc):
  """The CCM as the unsharded step hands it to the stencil's cached finish
  spec."""
  return None if cc is None else tuple(cc)


def demosaic_phases_spatial(phases, mesh, pattern, cc=None, method="mhc",
                            axis_name: str = ROW_AXIS) -> torch.Tensor:
  """Demosaic this rank's rows ``phases`` (N, 4, hh_l, wh) of phase
  planes whose rows are split over ``axis_name``: one halo phase row from
  each neighbour, then K2's banded mode in f32 with the border factors at
  the frame's top and bottom only. Returns this rank's clamped f32
  (N, 12, hh_l, wh)."""
  idx, n = _axis(mesh, axis_name)
  x = types.as_tensor(phases).to(mesh_device(mesh), torch.float32)
  _, _, hh_l, wh = x.shape
  if hh_l < 3:
    raise ValueError(
        "row shards must have at least 3 half-res rows (got "
        f"{hh_l}; use fewer row shards or larger frames)")
  padded = _exchange_phase_rows(x, idx, n, mesh.get_group(axis_name))
  fin = bayer_ops._finish_spec_for(pattern, method, hh_l + 2, wh,
                                   _cc_key(cc), torch.float32,
                                   top_row=1 if idx == 0 else -1,
                                   bot_row=hh_l if idx == n - 1 else -1)
  return hopper_dm.demosaic_stencil(
      padded, bayer_ops._demosaic_tables(pattern, method), fin, 0,
      rows=(1, hh_l + 1))[0]


def _spatial_resize_plan(h, w, n_shards, resize_plan, stride):
  """Validate a resize plan for row sharding (the JAX package's rules):
  every shard's taps are shard 0's shifted by its input rows (checked on
  the unclamped positions, which are shift-invariant for the production
  scales: x0.5, x0.25, integer upscales; non-dyadic scales drift in f32
  and are refused), the resized rows divide over the shards into
  multiples of the metering stride, and no top halo is needed. Returns
  (size, (sy, sx), h_out_local, halo_lo, halo_hi), halos in phase
  rows."""
  size, scale = resize_plan
  w_out, h_out = size
  sy, sx = ci._plan_scales(h, w, size, scale)
  if h_out % n_shards:
    raise ValueError(
        f"resized height {h_out} must divide over {n_shards} row shards")
  hol = h_out // n_shards
  if hol % stride:
    raise ValueError(
        f"resized rows per shard ({hol}) must be a multiple of the "
        f"metering stride ({stride}) so the sample grid stays global")
  hil = h // n_shards
  p = np.arange(h_out, dtype=np.float32) / np.float32(sy)
  r_lo = p.astype(np.int32)
  r_f = p - r_lo.astype(np.float32)
  r_hi = r_lo + 1
  for i in range(1, n_shards):
    o = slice(i * hol, (i + 1) * hol)
    if (not np.array_equal(r_lo[o], r_lo[:hol] + i * hil)
        or not np.array_equal(r_f[o], r_f[:hol])):
      raise ValueError(
          f"resize scale {sy} is not shift-invariant across {n_shards} "
          f"row shards (f32 tap drift) — use process_large or an "
          f"unsharded step for this scale")
  halo_lo = max(0, -(-max(0, 0 - int(r_lo[0])) // 2))
  halo_hi = max(0, -(-max(0, int(r_hi[hol - 1]) - (hil - 1)) // 2))
  if halo_lo != 0:
    raise ValueError(
        f"resize plan needs a top halo of {halo_lo} phase rows — the "
        "row-sharded resize only supports truncation-anchored sampling "
        "(top tap at row 0); use process_large or an unsharded step")
  return size, (sy, sx), hol, halo_lo, halo_hi


def _check_rows(h, w, n_shards, stride, color_format, tonemap):
  """The build-time refusals of the row and grid steps that need no
  resize plan."""
  if color_format not in ("rgb", "yuv420"):
    raise ValueError(f"unknown color_format {color_format!r}")
  if tonemap not in ("reinhard", "linear"):
    raise ValueError(f"unknown tonemap {tonemap}")
  if h % n_shards or (h // n_shards) % 8 != 0:
    raise ValueError(
        f"rows per shard must be a multiple of 8 (Bayer parity + "
        f"metering-grid alignment); got H={h} over {n_shards} shards")
  if h // n_shards // 2 < 3:
    raise ValueError(
        "row shards must have at least 3 half-res rows (got "
        f"{h // n_shards // 2}; use fewer row shards or larger frames)")
  if w < 4:
    raise ValueError(f"row shards need frames at least 4 pixels wide, got "
                     f"{w}")
  if stride % 2:
    raise ValueError(
        f"row-sharded steps need an even metering stride, got {stride}: an "
        "odd stride's samples fall on every phase, which a shard's "
        "stride // 2 phase grid does not reproduce")


class _RowGeometry:
  """One rank's static part of a row-sharded step: the half-res input
  rows [q0, q1) its band demosaics, the raw rows [a, b) that band reads,
  its output rows (with a resize), and the raw rows every rank sends its
  next neighbour."""

  def __init__(self, h, w, n, idx, stride, resize_plan):
    hh, hl = h // 2, h // n
    self.hh, self.wh = hh, w // 2
    if resize_plan is None:
      if hl % stride:
        raise ValueError(
            f"rows per shard ({hl}) must be a multiple of the metering "
            f"stride ({stride}) so the sample grid stays global")
      bands = [(j * hl // 2, (j + 1) * hl // 2) for j in range(n)]
      self.resize = None
    else:
      size, (sy, sx), hol, _, _ = _spatial_resize_plan(h, w, n, resize_plan,
                                                       stride)
      r_lo, r_hi, _ = _axis_samples(int(size[1]), h, sy)
      bands = [large.resize_in_rows(r_lo, r_hi, j * hol, (j + 1) * hol, hh)
               for j in range(n)]
      self.resize = ((int(size[0]), int(size[1])), (float(sy), float(sx)),
                     (idx * hol, (idx + 1) * hol))
    for j, (q0, _) in enumerate(bands):
      if 2 * q0 < j * hl:
        raise ValueError(f"row shard {j}'s band starts above its rows: the "
                         "row-sharded step reads no top halo past the "
                         "stencil's")
    # raw rows past each shard's own that its band reads, from the next
    # shard (none past the frame)
    need = [2 * q1 + 2 - (j + 1) * hl for j, (_, q1) in enumerate(bands)]
    self.below = max([0, *need[:-1]])
    if self.below > hl:
      raise ValueError(f"a resize's taps reach {self.below} raw rows past a "
                       f"row shard of {hl} rows: more than its neighbour")
    self.q = bands[idx]
    self.rows = (2 * self.q[0] - 2, 2 * self.q[1] + 2)


def _build_local_step(*, fmt, ids_format, work_dtype, pattern, cc, stride,
                      tonemap, transform, color_format, n_total, geom, idx,
                      n, row_group, meter_group, device):
  """The per-rank step shared by the row and the grid factories."""
  wd = types.canonical_dtype(work_dtype)
  cc = _cc_key(cc)

  def step(raws, prev, t, gamma, intensity, light_adapt, color_adapt):
    raws = types.to_device(types.as_tensor(raws), device)
    prev = torch.as_tensor(prev, dtype=torch.float32, device=device)
    band = _halo_band(raws, idx, n, geom.below, geom.rows, row_group)
    if geom.resize is None:
      x, sample = large.band_x12(band, *geom.q, geom.hh, fmt, ids_format,
                                 wd, pattern, cc, stride // 2)
    else:
      size, scale_yx, out_rows = geom.resize
      x12 = large.band_x12(band, *geom.q, geom.hh, fmt, ids_format, wd,
                           pattern, cc, 0)[0]
      x = large.resize_band(x12, out_rows, geom.q, geom.hh, geom.wh, size,
                            scale_yx)
      sample = bayer_ops.subsample_hw(x, stride, stride)
    mt = ci._meter(sample, prev, t, meter_group, n_total, intensity,
                   light_adapt, color_adapt)
    if tonemap == "reinhard":
      x, scal = ci.reinhard_map_max_ca(x, mt.metrics, intensity,
                                       light_adapt, color_adapt, wd,
                                       scal=mt.scal)
      # the image's max over its rows on every rank of the axis
      dist.all_reduce(scal, op=dist.ReduceOp.MAX, group=row_group)
    else:
      scal = mt.lin
    if geom.resize is None:
      return mt.metrics, ci._finish(x, scal, gamma, tonemap, transform,
                                    color_format, "auto")
    return mt.metrics, large.finish_resized(x, scal, gamma, tonemap,
                                            transform, color_format)

  return step


def _factory(mesh, h, w, *, row_axis, meter_group, fmt, ids_format,
             work_dtype, pattern, cc, stride, tonemap, n_cameras,
             resize_plan, transform, color_format):
  idx, n = _axis(mesh, row_axis)
  _check_rows(h, w, n, stride, color_format, tonemap)
  geom = _RowGeometry(h, w, n, idx, stride, resize_plan)
  if color_format == "yuv420" and resize_plan is not None:
    hopper_yuv420.check_even(*transformed_size(geom.resize[0],
                                               transform)[::-1])
  return _build_local_step(
      fmt=fmt, ids_format=ids_format, work_dtype=work_dtype, pattern=pattern,
      cc=cc, stride=stride, tonemap=tonemap, transform=transform,
      color_format=color_format,
      n_total=_n_total(n_cameras, (h, w), resize_plan, stride), geom=geom,
      idx=idx, n=n, row_group=mesh.get_group(row_axis),
      meter_group=meter_group, device=mesh_device(mesh))


def make_spatial_isp_step(mesh, *, fmt: str = "packed12",
                          ids_format: bool = False, work_dtype, pattern,
                          cc=None, stride: int = 8,
                          tonemap: str = "reinhard", n_cameras: int,
                          image_hw, resize_plan=None,
                          transform: ImageTransform = ImageTransform.none,
                          color_format: str = "rgb",
                          axis_name: str = ROW_AXIS):
  """Whole-rig step with each frame's ROWS split over ``axis_name``:

    step(raws, prev, t, gamma, intensity, light_adapt, color_adapt)
      -> (metrics, this rank's band of the planar u8 (N, 3, H', W'))

  ``raws`` is this rank's (N, H / n_shards, W_raw) rows
  (:func:`shard_rows`), ``prev`` the vec9, equal on every rank; the new
  metrics come out equal on every rank. ``resize_plan=(size, scale)``
  composes the resize (shift-invariant scales only), ``transform`` is
  applied to each band where its kernel stores it, and
  ``color_format='yuv420'`` gives the band's ``(Y, VU)``.
  :func:`gather_rows` joins the bands into frames."""
  h, w = image_hw
  return _factory(mesh, h, w, row_axis=axis_name,
                  meter_group=mesh.get_group(axis_name), fmt=fmt,
                  ids_format=ids_format, work_dtype=work_dtype,
                  pattern=pattern, cc=cc, stride=stride, tonemap=tonemap,
                  n_cameras=n_cameras, resize_plan=resize_plan,
                  transform=transform, color_format=color_format)


def make_grid_isp_step(mesh, *, fmt: str = "packed12",
                       ids_format: bool = False, work_dtype, pattern,
                       cc=None, stride: int = 8, tonemap: str = "reinhard",
                       n_cameras: int, image_hw, resize_plan=None,
                       transform: ImageTransform = ImageTransform.none,
                       color_format: str = "rgb",
                       cam_axis: str = CAMERA_AXIS,
                       row_axis: str = ROW_AXIS):
  """Whole-rig step over a 2-D mesh: the cameras split over ``cam_axis``
  and each frame's rows over ``row_axis``. The metering reduces over the
  whole mesh; each image's Reinhard max over the row axis. ``raws`` is
  this rank's cameras and rows (:func:`shard_cameras`, then
  :func:`shard_rows`); the output is its cameras' band, as in
  :func:`make_spatial_isp_step`."""
  h, w = image_hw
  return _factory(mesh, h, w, row_axis=row_axis,
                  meter_group=mesh_group(mesh), fmt=fmt,
                  ids_format=ids_format, work_dtype=work_dtype,
                  pattern=pattern, cc=cc, stride=stride, tonemap=tonemap,
                  n_cameras=n_cameras, resize_plan=resize_plan,
                  transform=transform, color_format=color_format)
