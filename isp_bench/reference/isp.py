"""Plain reference of the camera ISP step, for deciding ``correct``.

A frozen copy of the upstream step's mathematics (uc-vision/taichi_image
``camera_isp.py``: packed12 decode, Malvar-He-Cutler demosaic with the
dropped border taps divided out, the ``resize_width`` policy's bilinear
resize, the vec9 EMA metering, the Reinhard map, the gamma to u8, the
image transforms and the I420 conversion, in the upstream order: demosaic,
resize, metering, tonemap, transform), written at full resolution in
plain PyTorch. It imports nothing of the program: the benchmark hands it
the same raw sets it hands the program, and it works out everything else
itself.

``work_dtype`` is where the configuration materialises its images: the
decoded CFA, the demosaiced RGB, the resized RGB and the map's output are
rounded to it, and the arithmetic between those points is float32 (sums
of the metering in float64). Passing a lower precision than the
configuration states gives the control that ``compare`` has to reject.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# f32(1 / 4095): the 12-bit codes are scaled by a multiplication
DECODE_SCALE = torch.tensor(1.0 / 4095.0, dtype=torch.float32).item()
GRAY = (0.299, 0.587, 0.114)
GRAY_SUM = GRAY[0] + GRAY[1] + GRAY[2]
# full-range BT.601 rows, applied to the channel-reversed (b, g, r) vector
# (the upstream yuv_420 kernel's order), and the offsets of Y, U, V
YUV_Y = (0.299, 0.587, 0.114)
YUV_U = (-0.168736, -0.331264, 0.5)
YUV_V = (0.5, -0.418688, -0.081312)
YUV_OFFSET = (0.0, 0.5, 0.5)
# counts from a u8 step within which a tone is a tie (float32 has some
# 1.5e-5 counts of resolution at 255)
TIE_COUNTS = 1e-4

# Malvar-He-Cutler 5x5 kernels, integer weights summing to 16
_IDENT = ((0, 0, 0, 0, 0), (0, 0, 0, 0, 0), (0, 0, 16, 0, 0),
          (0, 0, 0, 0, 0), (0, 0, 0, 0, 0))
_G_AT_RB = ((0, 0, -2, 0, 0), (0, 0, 4, 0, 0), (-2, 4, 8, 4, -2),
            (0, 0, 4, 0, 0), (0, 0, -2, 0, 0))
_RB_AT_BR = ((0, 0, -3, 0, 0), (0, 4, 0, 4, 0), (-3, 0, 12, 0, -3),
             (0, 4, 0, 4, 0), (0, 0, -3, 0, 0))
# the missing colour lies above and below / left and right of a G site
_VERT = ((0, 0, -2, 0, 0), (0, -2, 8, -2, 0), (1, 0, 10, 0, 1),
         (0, -2, 8, -2, 0), (0, 0, -2, 0, 0))
_HORIZ = ((0, 0, 1, 0, 0), (0, -2, 0, -2, 0), (-2, 8, 10, 8, -2),
          (0, -2, 0, -2, 0), (0, 0, 1, 0, 0))

# RGGB: (row parity, col parity) of a CFA site -> its (R, G, B) kernels
MHC_RGGB = {
    (0, 0): (_IDENT, _G_AT_RB, _RB_AT_BR),
    (0, 1): (_HORIZ, _IDENT, _VERT),
    (1, 0): (_VERT, _IDENT, _HORIZ),
    (1, 1): (_RB_AT_BR, _G_AT_RB, _IDENT),
}

def decode_packed12(raws: torch.Tensor) -> torch.Tensor:
  """(N, H, 1.5W) u8, two 12-bit pixels in three bytes (low byte of the
  first, then the nibbles, then the high byte of the second) -> (N, H,
  W) int32 codes."""
  b = raws.to(torch.int32)
  b0, b1, b2 = b[..., 0::3], b[..., 1::3], b[..., 2::3]
  first = ((b1 & 0xF) << 8) | b0
  second = (b2 << 4) | (b1 >> 4)
  n, h, _ = raws.shape
  return torch.stack([first, second], dim=-1).reshape(n, h, -1)


def demosaic(cfa: torch.Tensor, pattern: str = "RGGB") -> torch.Tensor:
  """(N, H, W) CFA values in [0, 1] -> (N, 3, H, W) float32 RGB clipped
  to [0, 1]: at every site each colour is the kernel's weighted sum of
  the in-frame taps over the sum of their weights (taps outside the frame
  are dropped, not mirrored)."""
  if pattern != "RGGB":
    raise ValueError(f"the reference knows the RGGB pattern only, not "
                     f"{pattern}")
  x = cfa.to(torch.float32)
  n, h, w = x.shape
  if h % 2 or w % 2:
    raise ValueError(f"a CFA needs even sides, got {h}x{w}")
  xp = F.pad(x, (2, 2, 2, 2))
  ones = F.pad(torch.ones((1, h, w), dtype=torch.float32, device=x.device),
               (2, 2, 2, 2))
  out = torch.empty((n, 3, h, w), dtype=torch.float32, device=x.device)
  for (py, px), kernels in MHC_RGGB.items():
    for c, k in enumerate(kernels):
      num = den = None
      for dy in range(5):
        for dx in range(5):
          wt = float(k[dy][dx])
          if wt == 0.0:
            continue
          rows = slice(py + dy, py + dy + h, 2)
          cols = slice(px + dx, px + dx + w, 2)
          t, u = xp[:, rows, cols] * wt, ones[:, rows, cols] * wt
          num = t if num is None else num + t
          den = u if den is None else den + u
      out[:, c, py::2, px::2] = num / den
  return out.clamp_(0.0, 1.0)


def rgb_frames(raws: torch.Tensor, work_dtype: torch.dtype) -> torch.Tensor:
  """A packed12 set -> (N, 3, H, W) RGB of ``work_dtype``: the decoded CFA
  and the demosaic each rounded to it."""
  cfa = (decode_packed12(raws).to(torch.float32) * DECODE_SCALE).to(
      work_dtype)
  return demosaic(cfa).to(work_dtype)


def resize_plan(h: int, w: int, resize_width: int):
  """The upstream ``resize_width`` policy (``camera_isp.py:302-315``):
  ``(h_out, w_out, scale)`` with ``scale = resize_width / w`` and the
  height ``round(h * scale)``."""
  scale = resize_width / w
  return round(h * scale), resize_width, scale


def resize_samples(n_out: int, n_in: int, scale: float):
  """The upstream bilinear sampling of one axis, on the CPU: ``p =
  f32(i) / f32(scale)``, ``i0 = trunc(p)``, ``frac = p - i0``, taps
  ``i0`` and ``i0 + 1`` clamped to the frame: (lo, hi int64, frac
  float32)."""
  p = (torch.arange(n_out, dtype=torch.float32)
       / torch.tensor(scale, dtype=torch.float32))
  i0 = p.trunc()
  return (i0.to(torch.int64).clamp(0, n_in - 1),
          (i0.to(torch.int64) + 1).clamp(0, n_in - 1), p - i0)


def resize(rgb: torch.Tensor, h_out: int, w_out: int, scale: float,
           work_dtype: torch.dtype) -> torch.Tensor:
  """(N, 3, H, W) -> (N, 3, h_out, w_out) of ``work_dtype``: rows mixed
  first, then columns, each ``lo + frac * (hi - lo)`` in float32, one
  rounding at the end. Both axes take the one ``scale``."""
  _, _, h, w = rgb.shape
  r_lo, r_hi, r_f = (t.to(rgb.device)
                     for t in resize_samples(h_out, h, scale))
  c_lo, c_hi, c_f = (t.to(rgb.device)
                     for t in resize_samples(w_out, w, scale))
  x = rgb.to(torch.float32)
  top, bot = x.index_select(2, r_lo), x.index_select(2, r_hi)
  rows = top + r_f[:, None] * (bot - top)
  left, right = rows.index_select(3, c_lo), rows.index_select(3, c_hi)
  return (left + c_f * (right - left)).to(work_dtype)


def metering_sample(rgb: torch.Tensor, stride: int) -> torch.Tensor:
  """The pixels the metering reads: every ``stride``-th row and column."""
  return rgb[:, :, ::stride, ::stride]


def reinhard(rgb: torch.Tensor, metrics: torch.Tensor, intensity: float,
             light_adapt: float, work_dtype: torch.dtype):
  """The Reinhard map (colour adaptation 0) of (N, 3, H, W) under the
  metering state: ``(p rounded to work_dtype, each image's max of the
  float32 p)``; a NaN of p is 0."""
  m = metrics.to(torch.float32)
  key = (m[3] - m[4]) / (m[3] - m[2])
  map_key = 0.3 + 0.7 * key ** 1.4
  x = (rgb.to(torch.float32) - m[0]) / (m[1] - m[0])
  gray = (GRAY[0] * x[:, 0] + GRAY[1] * x[:, 1] + GRAY[2] * x[:, 2])[:, None]
  adapt = (math.exp(-intensity) * (m[5] + light_adapt * (gray - m[5]))
           ) ** map_key
  p = x / (adapt + x)
  p = torch.where(torch.isnan(p), 0.0, p)
  return p.to(work_dtype), p.amax(dim=(1, 2, 3))


def tone(p: torch.Tensor, max_out: torch.Tensor, gamma: float):
  """p over its image's max, to the power 1 / gamma, times 255, clipped
  to [0, 255] and truncated to u8 (a NaN, from a negative p, gives 0):
  ``(the u8 values, where the float32 value lies within TIE_COUNTS of a
  u8 step)``. There the truncation takes the side that float32 rounding
  gives, and a sound computation in another order may take the other."""
  o = p.to(torch.float32) / max_out.clamp_min(1e-6).reshape(-1, 1, 1, 1)
  if gamma != 1.0:
    o = o ** (1.0 / gamma)
  v = torch.nan_to_num((255.0 * o).clamp(0.0, 255.0), nan=0.0)
  return v.to(torch.uint8), (v - v.round()).abs() < TIE_COUNTS


def transform(x: torch.Tensor, name: str) -> torch.Tensor:
  """The rig's output transform on the last two axes; rotate_90 is
  clockwise: out[i, j] = in[H - 1 - j, i]."""
  if name == "none":
    return x
  if name == "rotate_90":
    return torch.rot90(x, -1, (-2, -1))
  raise ValueError(f"the reference knows no transform {name!r}")


def i420(rgb8: torch.Tensor):
  """Planar u8 RGB (N, 3, H, W) -> (Y (N, H, W), VU (N, 2, H/2, W/2)):
  Y of each pixel, V then U of each 2x2 block's mean colour, on values
  u8 / 255, each min(1, .) * 255 truncated."""
  x = rgb8.to(torch.float32) / 255.0
  r, g, b = x[:, 0], x[:, 1], x[:, 2]

  def row(m, off, b, g, r):
    return m[0] * b + m[1] * g + m[2] * r + off

  def u8(v):
    return (v.clamp_max(1.0) * 255.0).clamp(0.0, 255.0).to(torch.uint8)

  def block_mean(c):
    n, h, w = c.shape
    return c.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

  mb, mg, mr = block_mean(b), block_mean(g), block_mean(r)
  y = u8(row(YUV_Y, YUV_OFFSET[0], b, g, r))
  vu = torch.stack([row(YUV_V, YUV_OFFSET[2], mb, mg, mr),
                    row(YUV_U, YUV_OFFSET[1], mb, mg, mr)], dim=1)
  return y, u8(vu)


class SampleSums:
  """What the metering needs of one sample (N, 3, h, w) whatever the
  state: its bounds, the gray of every pixel (float32), and the mean of
  each channel and of the gray (float64)."""

  def __init__(self, sample: torch.Tensor):
    x = sample.to(torch.float32)
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    self.count = r.numel()
    self.lo, self.hi = x.amin().item(), x.amax().item()
    self.gray = GRAY[0] * r + GRAY[1] * g + GRAY[2] * b
    self.gray_lo, self.gray_hi = (self.gray.amin().item(),
                                  self.gray.amax().item())
    self.means = [v.sum(dtype=torch.float64).item() / self.count
                  for v in (self.gray, r, g, b)]


def meter_step(ss: SampleSums, prev: list, t: float) -> list:
  """One EMA update of the vec9 [min, max, log min, log max, log mean,
  mean, r mean, g mean, b mean], in float64 on the host: the sample's
  bounds blended with the previous bounds; the statistics of the sample
  scaled to the blended bounds, s = (x - b0) / (b1 - b0 + 1e-6), with
  gray = .299 s_r + .587 s_g + .114 s_b and the log of the gray clamped
  at 1e-4; then the whole vector blended with the previous one. ``t``
  weighs the previous state. The means and the bounds of the gray are
  linear in s, so they come from the sample's own sums; only the mean of
  the log takes a pass over the pixels."""
  b0 = ss.lo + t * (prev[0] - ss.lo)
  b1 = ss.hi + t * (prev[1] - ss.hi)
  d = b1 - b0 + 1e-6
  c = b0 * GRAY_SUM
  log_mean = torch.log(((ss.gray - c) / d).clamp_min(1e-4)).sum(
      dtype=torch.float64).item() / ss.count
  stats = [b0, b1, math.log(max((ss.gray_lo - c) / d, 1e-4)),
           math.log(max((ss.gray_hi - c) / d, 1e-4)), log_mean,
           (ss.means[0] - c) / d, *[(m - b0) / d for m in ss.means[1:]]]
  return [s + t * (p - s) for s, p in zip(stats, prev)]


class Pipeline:
  """The reference run over a chain of sets: the pool's RGB (resized
  where the configuration has a ``resize_width`` above 0, and then only
  the resized RGB kept) and metering sums worked out once, the EMA state
  carried through every step in order, and the output of any step on
  request."""

  def __init__(self, cfg: dict, pool, work_dtype: torch.dtype):
    self.cfg = cfg
    self.work_dtype = work_dtype
    self.rgb = [self._frames(raws) for raws in pool]
    stride = int(cfg["metering_stride"])
    self.sums = [SampleSums(metering_sample(x, stride)) for x in self.rgb]

  def _frames(self, raws: torch.Tensor) -> torch.Tensor:
    rgb = rgb_frames(raws, self.work_dtype)
    width = int(self.cfg.get("resize_width", 0))
    if width <= 0:
      return rgb
    return resize(rgb, *resize_plan(rgb.shape[2], rgb.shape[3], width),
                  self.work_dtype)

  def states(self, chain, wanted) -> dict:
    """The metering state after each step of ``chain`` (indices into the
    pool) whose position is in ``wanted``: {position: float32 vec9 on
    the pool's device}."""
    t_next = 1.0 - float(self.cfg["moving_alpha"])
    prev, t = [0.0] * 9, 0.0
    out = {}
    for pos, i in enumerate(chain):
      prev = meter_step(self.sums[i], prev, t)
      t = t_next
      if pos in wanted:
        out[pos] = torch.tensor(prev, dtype=torch.float32,
                                device=self.rgb[0].device)
    return out

  def output(self, set_index: int, metrics: torch.Tensor,
             color_format: str = "rgb"):
    """The step's output for pool set ``set_index`` under the state the
    step produced, and where its values are ties (``tone``): planar u8
    RGB (N, 3, h', w') after the transform and its ties, or with
    ``color_format="yuv420"`` the (Y, VU) pair and None (the I420
    conversion marks no ties)."""
    c = self.cfg
    p, mx = reinhard(self.rgb[set_index], metrics, float(c["intensity"]),
                     float(c["light_adapt"]), self.work_dtype)
    rgb8, ties = tone(p, mx, float(c["gamma"]))
    rgb8 = transform(rgb8, c["transform"])
    if color_format == "yuv420":
      return i420(rgb8), None
    return rgb8, transform(ties, c["transform"])
