"""The least work a frame set needs, whatever kernels carry it.

Bytes: the raw set read once and the output written once, from the
configuration's shapes, the output at the route's output size (the
resized frame where the configuration has a ``resize_width``).
Operations: the reference's float32 arithmetic (``reference/isp.py``)
counted per pixel of the full-resolution frame up to the demosaic and per
pixel of the output after it, each add, subtract, multiply, divide, min,
max, compare, select, log, exp and pow one operation, as few as the
arithmetic allows (the demosaic's taps of equal weight summed before
their one multiply); the bit unpacking of the decode and the transform's
data movement count none. A fused or removed kernel leaves both counts
as they are.
"""

from isp_bench.reference import isp as ref

def _stencil_ops(kernel) -> int:
  """The least arithmetic of one colour of the demosaic at an interior
  site: the taps of each weight summed first, one multiply a weight
  other than 1, the weighted sums added, one multiply to normalise and
  the clip's min and max. The identity (the site's own colour) is
  free."""
  weights = [w for row in kernel for w in row if w]
  if weights == [16]:
    return 0
  groups = {w: weights.count(w) for w in set(weights)}
  return (sum(n - 1 for n in groups.values())
          + sum(w != 1 for w in groups) + len(groups) - 1 + 1 + 2)


def _demosaic_ops() -> float:
  """Per pixel, over the four sites of the 2x2 CFA cell."""
  return sum(_stencil_ops(k) for kernels in ref.MHC_RGGB.values()
             for k in kernels) / len(ref.MHC_RGGB)


# operations per pixel of each stage of the reference: the decode and the
# demosaic a full-resolution pixel, the later stages an output pixel
STAGE_OPS = {
    "decode": 1.0,              # the code times f32(1 / 4095)
    "demosaic": _demosaic_ops(),
    # per output pixel: 3 values, each 3 lerps (two along the rows, one
    # along the columns) of 3 operations (subtract, multiply, add)
    "resize": 27.0,
    # per pixel of the sample: scaling 3 x (subtract, divide), the gray
    # 5, its clamp and log 2, five sums 5, the bounds of the values 6
    # and of the log 2
    "meter_per_sample_pixel": 26.0,
    # scaling 6, gray 5, the adaptation (subtract, multiply, add,
    # multiply, pow) 5, p 3 x (add, divide), the NaN select 3, the max 3
    "map": 28.0,
    # per value: divide by the max, pow (not at gamma 1), times 255, the
    # clip's min and max, the NaN select
    "tone_per_value": 6.0,
    # per pixel: 3 divisions by 255; Y's row (3 multiplies, 3 adds), its
    # min, multiply and clip 4; per 2x2 block the 3 means (3 adds and a
    # multiply each), the V and U rows (6 each) and their u8 (4 each):
    # 32 a block, 8 a pixel
    "i420": 3.0 + 10.0 + 8.0,
}


ITEM_BYTES = {"float16": 2, "bfloat16": 2, "float32": 4}


def pixels(cfg: dict) -> int:
  return cfg["cameras"] * cfg["height"] * cfg["width"]


def resized(cfg: dict) -> bool:
  """Whether the configuration takes the resize route."""
  return int(cfg.get("resize_width", 0)) > 0


def out_size(cfg: dict) -> tuple[int, int]:
  """(height, width) of one camera's output: the resize plan's on the
  resize route, else the frame's."""
  if not resized(cfg):
    return cfg["height"], cfg["width"]
  h_out, w_out, _ = ref.resize_plan(cfg["height"], cfg["width"],
                                    int(cfg["resize_width"]))
  return h_out, w_out


def out_pixels(cfg: dict) -> int:
  h, w = out_size(cfg)
  return cfg["cameras"] * h * w


def sample_pixels(cfg: dict) -> int:
  """Pixels of the metering sample: every ``metering_stride``-th row and
  column of the output."""
  s = cfg["metering_stride"]
  h, w = out_size(cfg)
  return cfg["cameras"] * -(-h // s) * -(-w // s)


def tone_ops(cfg: dict) -> float:
  """Operations of the tone a value (no pow at gamma 1)."""
  return STAGE_OPS["tone_per_value"] - (1.0 if cfg["gamma"] == 1.0 else 0.0)


def item_bytes(cfg: dict) -> int:
  """Bytes of one value of the configuration's working dtype."""
  return ITEM_BYTES[cfg["work_dtype"]]


def irreducible_bytes(cfg: dict, color_format: str) -> int:
  """The raw set read once and the output written once."""
  raw = pixels(cfg) * 3 // 2          # packed12: 1.5 bytes a pixel
  # u8 RGB: 3 bytes a pixel; I420: Y, and V and U a 2x2 block
  n = out_pixels(cfg)
  return raw + (n * 3 if color_format == "rgb" else n * 3 // 2)


def ops(cfg: dict, color_format: str) -> float:
  """The reference's float32 operations for one set."""
  s = cfg["metering_stride"]
  per_out = (STAGE_OPS["meter_per_sample_pixel"] / (s * s)
             + STAGE_OPS["map"] + 3 * tone_ops(cfg))
  if resized(cfg):
    per_out += STAGE_OPS["resize"]
  if color_format == "yuv420":
    per_out += STAGE_OPS["i420"]
  return ((STAGE_OPS["decode"] + STAGE_OPS["demosaic"]) * pixels(cfg)
          + per_out * out_pixels(cfg))
