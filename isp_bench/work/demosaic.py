"""K2, the MHC stencil (``demosaic_<T>``): the phase planes in, the
12-channel phase RGB and the metering sample out; on the resize route
no sample, since the metering reads the resized image (chip_smoke's
stage table)."""

from isp_bench.work.isp_set import (STAGE_OPS, item_bytes, pixels, resized,
                                    sample_pixels)

SYMBOLS = ("stencil_kernel",)


def logical_bytes(cfg: dict, color_format: str) -> int:
  sample = 0 if resized(cfg) else 3 * sample_pixels(cfg)
  return (pixels(cfg) + 3 * pixels(cfg) + sample) * item_bytes(cfg)


def ops(cfg: dict, color_format: str) -> float:
  return STAGE_OPS["demosaic"] * pixels(cfg)
